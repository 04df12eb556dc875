// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tensor maps and loads, bulk copies, cp.async 16-byte copies (and
// their arrival on an mbarrier), the 16-byte swizzle of shared-memory tiles,
// thread block clusters (rank, the split cluster barrier, bulk copies into
// a peer block's shared memory), wgmma's shared-memory matrix descriptors,
// its fence/commit/wait sequence and the 16-bit m64nNk16 products (bf16,
// or f16 for f16 keys; both operands from shared memory, or A from
// registers), with f32 accumulators in registers, and the s8
// m64nNk32 products (both operands K-major from shared memory) with s32
// accumulators.
//
// Tiles: a 16-bit (bf16 or f16) tile is kept as "chunks" of SW bytes a row
// (SW = 128, or 64 for a 32-column tile), each chunk a [rows][SW] block whose 16-byte units
// are XOR-swizzled by the row (swizzle() below), exactly as TMA writes a
// box under CU_TENSOR_MAP_SWIZZLE_128B / _64B and as wgmma reads it under
// the descriptor's layout type 1 / 2. Chunk bases are 1024-byte aligned.
// Descriptors (make_desc):
//   K-major operand (A = rows x K, or B = N x K with K contiguous): SBO =
//     8 rows x SW (the stride between 8-row core-matrix groups), LBO unused
//     (16); the k16 step s of a chunk starts 32 s bytes into the row (for
//     s8 operands the k32 step: a 128-byte row holds 128 k values, four
//     k32 products). 8-bit operands have no MN-major form.
//   MN-major B (K x N with N contiguous, V of P.V, a (k, n) weight): SBO =
//     8 K-rows x SW, LBO = the stride between SW/2-column chunks along N;
//     the k16 step s starts 16 s rows in; trans-b = 1 (16-bit types only).
//   MN-major A (K x M with M contiguous, B17's slice of the transpose of a
//     (rows, k) tensor): B's layout with M in place of N: SBO = 8 K-rows x
//     SW, LBO = the stride between SW/2-column chunks along M; the k16 step
//     s starts 16 s rows in; trans-a = 1 (SS products, 16-bit types only).
//
// The tensor-map encoder is a driver entry point: it is taken through
// cudaGetDriverEntryPoint[ByVersion], so the library links with the CUDA
// runtime only (no -lcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tpp {
namespace hopper {

// ---- host: tensor maps -------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over `base` of `rank` dims (innermost first), the byte
// strides of dims 1.. in `strides`, boxes of `box` elements, swizzled by
// `swizzle` bytes (64 or 128, or 0: not swizzled), elements of `type` (int8
// as CU_TENSOR_MAP_DATA_TYPE_UINT8: TMA moves bytes); out-of-bounds
// elements read as zero. Returns a cudaError_t: TMA needs a 16-byte aligned
// base and strides.
inline int make_map_typed(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, int rank, const uint64_t* dims,
                          const uint64_t* strides, const uint32_t* box,
                          int swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult rc = fn(
      map, type, rank, const_cast<void*>(base), d, s, b, e,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the tensor-map element type of T
template <class T> struct MapType;
template <> struct MapType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct MapType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// make_map_typed over elements of T (bf16 by default, f16, or f32)
template <class T = __nv_bfloat16>
inline int make_map(CUtensorMap* map, const void* base, int rank,
                    const uint64_t* dims, const uint64_t* strides,
                    const uint32_t* box, int swizzle) {
  return make_map_typed(map, MapType<T>::value, base, rank, dims, strides,
                        box, swizzle);
}

// ---- device: shared memory, barriers, TMA ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of a 16-byte unit in a tile chunk of SW-byte rows, swizzled
// as TMA and wgmma lay it out (offset relative to a 1024-byte aligned base)
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible (then __syncthreads)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed. A pipeline fault
// (a copy that never lands, a count that never completes) traps after some
// 2^34 clocks (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes from global to shared memory in one bulk copy
// (the TMA unit, no tensor map), completing on `bar` as TMA loads do; both
// addresses 16-byte aligned, `bytes` a multiple of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes from global to shared memory by the copy engine (cp.async), or
// zeros for the bytes at or past `src_bytes` (0 or 16); both addresses
// 16-byte aligned. Completion is per thread: commit, then wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// an arrival on `bar` once all of this thread's earlier cp.async copies
// have landed; it counts toward the barrier's expected arrivals (noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// shared-memory writes of the generic proxy (st.shared) made visible to the
// async proxy (wgmma, TMA) before a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a named barrier over `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// an arrival at named barrier `id` of `count` threads without waiting (the
// producer side of a hand-off: the arriving threads' earlier writes are
// released to the threads that bar_sync on it)
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- device: thread block clusters -------------------------------------

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// a barrier over every thread of the cluster, split in two: arrive releases
// this thread's earlier writes (shared memory of any block of the cluster
// included), wait acquires every other thread's; each thread alternates
// arrive and wait, all threads of a warp together
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// the shared::cluster address of `addr` (a shared::cta address of this
// block) in the block of rank `rank`: the same offset in its shared memory
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// an arrival (release, cluster scope) on the mbarrier at the offset of
// `bar` in the block of `rank`, where `issue` is true (by predicate)
__device__ __forceinline__ void mbar_arrive_peer_if(uint64_t* bar,
                                                    uint32_t rank,
                                                    bool issue) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n}\n"
      ::"r"(peer_addr(smem_u32(bar), rank)),
      "r"(static_cast<int>(issue))
      : "memory");
}

// `bytes` contiguous bytes of this block's shared memory into the shared
// memory of the block of `rank` in its cluster (at the same offset as
// `dst`), completing on that block's mbarrier at the offset of `bar`, by
// the bulk-copy engine; 16-byte aligned, `bytes` a multiple of 16. The
// source may be reused once cp.async.bulk.wait_group.read says so.
// Issued only where `issue` is true (a predicate, not a branch: the whole
// warp runs one path).
__device__ __forceinline__ void bulk_to_peer(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar,
                                             uint32_t rank, bool issue) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %4, 0;\n"
      "@p cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
      "::bytes [%0], [%1], %2, [%3];\n}\n" ::"r"(peer_addr(smem_u32(dst),
                                                           rank)),
      "r"(smem_u32(src)), "r"(bytes), "r"(peer_addr(smem_u32(bar), rank)),
      "r"(static_cast<int>(issue))
      : "memory");
}

// mbar_arrive_tx where `issue` is true, by predicate
__device__ __forceinline__ void mbar_arrive_tx_if(uint64_t* bar,
                                                  uint32_t bytes, bool issue) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(issue))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until at most N committed bulk-copy groups still read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// wait until at most N committed bulk-copy groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// ---- device: wgmma -----------------------------------------------------

// layout type of the descriptor: 1 = 128-byte swizzle, 2 = 64-byte
template <int SW>
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : 2;
  const uint32_t a = smem_u32(smem);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products (before the fence, after the wait)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two values rounded to bf16, then converted to f16 for an f16 product (the
// training attention rounds P and dS to bf16 for bf16 and f16 keys): the
// bf16 pair's halves are the f32 values' top 16 bits. Exact for |x| >=
// 2^-17 (bf16's 8 significant bits fit f16's 11 down to its subnormal step
// 2^-24); below, a value moves by at most 2^-25
__device__ __forceinline__ uint32_t pack_bf16_as_f16(float lo, float hi) {
  const uint32_t b = pack_bf16(lo, hi);
  return pack_f16(__uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}

// two values as a pair of the 16-bit product type T (bf16 or f16)
template <class T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// The products' type is part of a wgmma's name (.bf16 or .f16), so each
// wrapper below writes its asm once, as a macro of the type's name, and
// expands it for the product type T it is instantiated at.
#define TPP_WGMMA_TYPED(T, ASM)                   \
  if constexpr (std::is_same<T, __half>::value) { \
    ASM("f16");                                   \
  } else {                                        \
    ASM("bf16");                                  \
  }

// Register layout of an m64nN f32 accumulator (and of the A fragment): warp
// w of the warpgroup holds rows 16 w + lane / 4 and 16 w + lane / 4 + 8;
// d[4 j + 2 h + e] is row 16 w + lane / 4 + 8 h, column 8 j + 2 (lane % 4)
// + e. An A fragment of 16 columns is {rows +0 cols 0-7, rows +8 cols 0-7,
// rows +0 cols 8-15, rows +8 cols 8-15} as 16-bit pairs, so the accumulator
// of a product is the A fragment of the next one with no shuffle.

// m64n16k16, A and B from shared memory: 8 f32 accumulators a thread;
// TRANS_A / TRANS_B 1 read an MN-major A / B tile; T the product type
template <int TRANS_B, int TRANS_A = 0, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t da,
                                                   uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %10, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                     \
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                 \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// m64n24k16, A and B from shared memory: 12 f32 accumulators a thread;
// TRANS_A / TRANS_B 1 read an MN-major A / B tile; T the product type
template <int TRANS_B, int TRANS_A = 0, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n24k16_ss(float (&d)[12], uint64_t da,
                                                   uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %14, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n24k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11"                                                   \
      "}, %12, %13, p, 1, 1, %15, %16;\n}\n"                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11])                                           \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// m64n32k16, A and B from shared memory: 16 f32 accumulators a thread;
// TRANS_A / TRANS_B 1 read an MN-major A / B tile; T the product type
template <int TRANS_B, int TRANS_A = 0, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da,
                                                   uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %18, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15"                               \
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15])                                                        \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// m64n40k16, A and B from shared memory: 20 f32 accumulators a thread;
// TRANS_A / TRANS_B 1 read an MN-major A / B tile; T the product type
template <int TRANS_B, int TRANS_A = 0, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n40k16_ss(float (&d)[20], uint64_t da,
                                                   uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %22, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n40k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19"                                                 \
      "}, %20, %21, p, 1, 1, %23, %24;\n}\n"                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])    \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// m64n64k16, A and B from shared memory: 32 f32 accumulators a thread;
// TRANS_A / TRANS_B 1 read an MN-major A / B tile; T the product type
template <int TRANS_B, int TRANS_A = 0, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %34, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31"                             \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31])                                           \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// m64n128k16, A and B from shared memory: 64 f32 accumulators a thread;
// TRANS_A / TRANS_B 1 read an MN-major A / B tile; T the product type
template <int TRANS_B, int TRANS_A = 0, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %66, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                           \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                           \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                           \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                           \
      "%56, %57, %58, %59, %60, %61, %62, %63"                             \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),   \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),   \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),   \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),   \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                 \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// m64n128k32, s8 x s8 -> s32, A and B K-major from shared memory: 64 s32
// accumulators a thread
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n192k32, s8 x s8 -> s32, A and B K-major from shared memory: 96 s32
// accumulators a thread
__device__ __forceinline__ void wgmma_m64n192k32_s8(int (&d)[96], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n32k16, A from registers (four 16-bit pairs a thread), B from shared
// memory: 16 f32 accumulators a thread; T the product type
template <int TRANS_B, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %21, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15"                               \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15])                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
        "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// m64n64k16, A from registers (four 16-bit pairs a thread), B from shared
// memory: 32 f32 accumulators a thread; T the product type
template <int TRANS_B, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %37, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31"                             \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31])                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
        "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// m64n128k16, A from registers (four 16-bit pairs a thread), B from shared
// memory: 64 f32 accumulators a thread; T the product type
template <int TRANS_B, class T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
#define TPP_WGMMA(TY)                                                      \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %69, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                           \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                           \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                           \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                           \
      "%56, %57, %58, %59, %60, %61, %62, %63"                             \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),   \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),   \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),   \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),   \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
        "n"(TRANS_B))
  TPP_WGMMA_TYPED(T, TPP_WGMMA);
#undef TPP_WGMMA
}

// ---- device: products over the chunks of D-column 16-bit tiles --------

// a 16-bit (bf16 or f16) tile D columns wide: SW bytes a chunk row, CW
// columns a chunk
template <int D>
struct Chunks {
  static constexpr int SW = D >= 64 ? 128 : 64;
  static constexpr int CW = SW / 2;
};

// acc (m64 x n64) = A B^T over D columns, both operands K-major (D
// contiguous): A the 64 rows at `a` of a tile whose chunks hold A_ROWS
// rows, B a 64-row tile; T the product type (bf16 or f16). Issues the
// products only: the caller fences, commits and waits.
template <int D, int A_ROWS, class T = __nv_bfloat16>
__device__ __forceinline__ void ss_abt(float (&acc)[32],
                                       const unsigned char* a,
                                       const unsigned char* b) {
  using C = Chunks<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / C::CW, off = (kk * 16 % C::CW) * 2;
    const uint64_t da = make_desc<C::SW>(a + c * A_ROWS * C::SW + off, 16,
                                         8 * C::SW);
    const uint64_t db = make_desc<C::SW>(b + c * 64 * C::SW + off, 16,
                                         8 * C::SW);
    wgmma_m64n64k16_ss<0, 0, T>(acc, da, db, kk > 0);
  }
}

// acc (m64 x nD) += P X: P from registers (the four k16 A fragments of a
// 64-column accumulator), X a 64-row tile read MN-major (D contiguous,
// trans-b); T the product type (bf16 or f16). Issues the products only.
template <int D, class T = __nv_bfloat16>
__device__ __forceinline__ void rs_ab(float (&acc)[D / 2],
                                      const uint32_t (&p)[4][4],
                                      const unsigned char* x) {
  using C = Chunks<D>;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const uint64_t db = make_desc<C::SW>(x + kt * 16 * C::SW, 64 * C::SW,
                                         8 * C::SW);
    if constexpr (D == 32)
      wgmma_m64n32k16_rs<1, T>(acc, p[kt], db, 1);
    else if constexpr (D == 64)
      wgmma_m64n64k16_rs<1, T>(acc, p[kt], db, 1);
    else
      wgmma_m64n128k16_rs<1, T>(acc, p[kt], db, 1);
  }
}


}  // namespace hopper
}  // namespace tpp
