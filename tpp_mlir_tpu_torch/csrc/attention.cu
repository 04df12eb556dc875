// Attention for Hopper (sm_90a), token and flat layouts, with an in-kernel
// warm bench.
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:2232 _build_flash_mha_tokens (B7):
//   out[b, s, h*D:(h+1)*D] = softmax(Q_h K_h^T * scale [causal]) V_h
// on the token layout (B, S, H*D). Q/K/V are read by strides: split
// operands have row stride E = H*D; one packed (B, S, 3E) [Q|K|V] operand is
// read at column offsets 0, E, 2E with row stride 3E, so no slice is ever
// copied. The flat layout (B*H, S, D) is the same stride set with one head
// and row stride D, and so this kernel also replaces the five flat TPU
// kernels, which compute one function and differ only in how they schedule
// the TPU's VMEM: :1660 _build_flash_mha (B6, blocked online softmax),
// :2395 _build_flash_mha_qblock (B8), :2721 _build_flash_mha_grouped (B9),
// :2496 _build_flash_causal_twocall (B10a) and :2618
// _build_flash_causal_fold2 (B10b). Their causal mask keeps rows >= cols,
// aligned top-left.
//
// Training forward (replaces tpp_mlir_tpu/xsmm/flash_train.py:146
// build_flash_train_fwd, B14, for bf16 and f16 operands; flash_train.cu's
// tpp_flash_train_fwd calls tpp_attention_train_fwd below): the same
// function on the (B, S, H, D) layout, which is the token layout's memory,
// with differences that a compile-time mode (TRAIN) folds into the wgmma
// kernel: Q is staged rounded but unscaled and the S accumulators are
// multiplied by qscale in f32 before the row max, as the plain version
// scales the f32 product (B18 recomputes P from lse2); each row's base-2
// log-sum-exp lse2 = m + log2(l) is written, (B, H, S) f32; and P is
// rounded to bf16 and O stored in bf16 whatever the products' type, as
// B14 does (its `_pv_dtype`): with f16 operands P is rounded to bf16 and
// then converted to f16 for the .f16 product (hopper.cuh
// pack_bf16_as_f16), exact for P >= 2^-17.
//
// Warm bench (replaces :2091 _build_flash_bench, B11): with repeats > 0 a
// block loops over the repeats on its own Q tile. A tile's output rows
// depend only on its Q rows and on all of K/V, so no grid-wide sync is
// needed: O/l is rounded to the MXU dtype (the TPU's hbuf), scaled by
// qscale back into the Q tile in shared memory (in the swizzled layout the
// products read), the K/V loop runs again, and the output (still rounded
// to the MXU dtype) is written once, after the last repeat.
//
// The math follows B7: Q (in the MXU dtype) is scaled by scale*log2(e) in
// f32 and rounded to the MXU dtype again, the softmax is in the exp2
// domain, P is rounded to the MXU dtype before P.V, sums are f32. The MXU
// dtype is bf16 for bf16 and f32 "default" operands and f16 for f16 ones
// (ROADMAP A14): the wgmma kernel is instantiated at its product type E,
// and every rounding above, the warm bench's fed-back output included, is
// to E. Unlike
// B7, which normalizes P over the whole row before P.V, this kernel runs
// the online softmax over K/V tiles and divides by the row sum once at the
// end (as B6, B8, B9 and B11 do), so the (S x S) scores never exist
// anywhere.
//
// What bounds it on the H100: at the MHA suite's B8 key (B*H 16, S 2048,
// D 64) it is 17 GFLOP of tensor-core work over 12.6 MB of Q/K/V, 0.017 ms
// at 989 TFLOP/s against 0.004 ms at 3.35 TB/s: compute-bound, as
// attention is at any S past a few hundred. So the design keeps the tensor
// cores fed and everything else off their path:
//   - one block per (128 query rows, head, batch): two consumer warpgroups
//     of 64 rows and one producer warpgroup;
//   - K/V tiles of 64 rows go through a 3-stage ring in shared memory with
//     full/empty mbarriers: for 16-bit operands one producer thread fills
//     it by TMA (3D maps over (columns, rows, batch) of BFLOAT16 or FLOAT16
//     elements, 128-byte swizzle, 64 at D 32; the rows past seq_kv arrive
//     as zeros); for f32 operands at "default", and bf16 ones whose
//     strides TMA cannot take (the "convert" loaders), the producer
//     warpgroup loads them through registers, rounds f32 to bf16 (a bf16
//     value goes through as it is) and stores the same swizzled layout, so
//     the consumers run one code. f16 operands have the TMA loader only:
//     at D 32, 64 and 128 every stride and column offset is a multiple of
//     16 bytes;
//   - S = Q K^T on wgmma m64n64k16 (.bf16 or .f16) with Q and K from
//     shared memory, the
//     online softmax in registers (row max and sum across the four lanes
//     of a row by shuffles, columns past seq_kv and above the diagonal set
//     to -inf in registers), and O += P V on wgmma with P from registers as
//     the A operand (the S accumulator is the A fragment) and V MN-major
//     from shared memory; O stays in registers for the whole K/V loop;
//   - causal keys load no tile above the block's diagonal, a warpgroup
//     skips the tiles above its own, and q tiles are issued heaviest first
//     (the grid's slowest dimension, reversed), so the long rows do not run
//     last.
// With 64-row K/V tiles a consumer thread holds 32 S and D/2 O floats:
// ptxas fits D 128 in the 168 registers a 384-thread block allows, with no
// spill, so the warpgroups keep the same register budget (no setmaxnreg).
// MXU dtype f32 (f32 "highest") runs attention_fma_kernel below: f32 FMA
// (no TF32), one block of 4 warps per 64 query rows, K/V tiles staged
// through shared memory, the output accumulator in shared memory.
// D 32, 64 and 128.
#include <math.h>

#include <type_traits>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

namespace hw = tpp::hopper;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int seq, seq_kv;
  int ld_in;    // row stride of Q/K/V in elements: E, or 3E when packed
  int ld_out;   // row stride of out: E
  float qscale;  // scale * log2(e)
  int causal, out_dtype;
  int repeats;   // 0: one pass; > 0: the warm bench (B11)
  float* lse = nullptr;  // training mode: (B, H, seq) base-2 log-sum-exp
};

// ---- the 16-bit MXU path: wgmma, TMA or register loaders ---------------

// xsmm/kernels.py _ATTENTION_LOADER_CODE: code 3 is the f32-FMA kernel; each
// wgmma loader reads one operand dtype and runs products of one type E
enum Loader : int { kTma = 0, kConvertF32 = 1, kConvertBF16 = 2,
                    kTmaF16 = 4 };

__host__ __device__ constexpr bool is_tma(Loader ld) {
  return ld == kTma || ld == kTmaF16;
}

// the products' type of a loader: f16 for f16 operands, else bf16
template <Loader LD>
using Mma = typename std::conditional<LD == kTmaF16, __half,
                                      __nv_bfloat16>::type;

constexpr int WG = 128;          // threads of a warpgroup
constexpr int NCW = 2;           // consumer warpgroups
constexpr int BQ = 64 * NCW;     // query rows of a block
constexpr int BKV = 64;          // key/value rows of a tile
constexpr int STAGES = 3;        // K/V ring depth
constexpr int THREADS = WG * (NCW + 1);
static_assert(BKV == 64, "hopper.cuh's ss_abt / rs_ab: 64-row B tiles");

// hopper.cuh's chunked layout: SW bytes a chunk row, CW columns a chunk
template <int D>
struct Tile : hw::Chunks<D> {
  using hw::Chunks<D>::SW;
  using hw::Chunks<D>::CW;
  static constexpr int KV = BKV * D * 2;          // bytes of a K or V tile
  static constexpr int q_off = 0;
  static constexpr int ring_off = BQ * D * 2;
  static constexpr int bar_off = ring_off + STAGES * 2 * KV;
  static constexpr int bytes = bar_off + 2 * STAGES * 8;
  // the byte offset of (row, col) in a [rows x D] tile of row count `rows`
  __device__ static uint32_t at(int rows, int row, int col) {
    return (col / CW) * rows * SW +
           hw::swizzle<SW>(row * SW + (col % CW) * 2);
  }
};

// eight consecutive elements as f32 (a 16-byte unit of the 16-bit tile)
template <Loader LD>
__device__ __forceinline__ void load8(const void* base, size_t i,
                                      float (&x)[8]) {
  using E = Mma<LD>;
  if constexpr (LD == kConvertF32) {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    const float4 a = p[0], b = p[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (is_tma(LD)) {     // 16-byte aligned (the TMA gate)
    const uint4 u =
        *reinterpret_cast<const uint4*>(static_cast<const E*>(base) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = tpp::pair_f32<E>(w[j]);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  } else {
    const E* p = static_cast<const E*>(base) + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = tpp::to_f32(p[j]);
  }
}

// eight values rounded to E, as one 16-byte unit
template <class E>
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(hw::pack16<E>(x[0], x[1]), hw::pack16<E>(x[2], x[3]),
                    hw::pack16<E>(x[4], x[5]), hw::pack16<E>(x[6], x[7]));
}

// x rounded to E, as f32
template <class E>
__device__ __forceinline__ float round16(float x) {
  return tpp::to_f32(tpp::from_f32<E>(x));
}

// P's pair as the A fragment of P.V in the products' type E: rounded to E,
// or in training mode to bf16 first (B14 rounds P to bf16 for bf16 and f16
// operands), then converted to E
template <class E, bool TRAIN>
__device__ __forceinline__ uint32_t pack_p(float p0, float p1) {
  if constexpr (TRAIN && std::is_same<E, __half>::value)
    return hw::pack_bf16_as_f16(p0, p1);
  else
    return hw::pack16<E>(p0, p1);
}

// TRAIN: B14's forward (one pass, bf16 or f16 by TMA): Q staged unscaled, S
// scaled by qscale in f32 in registers, P rounded to bf16 (pack_p), each
// row's lse2 = m + log2(l) stored, and O stored in bf16.
template <Loader LD, int D, bool TRAIN = false>
__global__ void __launch_bounds__(THREADS, 1)
attention_kernel(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, Args a) {
  using T = Tile<D>;
  using E = Mma<LD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  unsigned char* qs = smem + T::q_off;
  unsigned char* ring = smem + T::ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bar_off);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / WG;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int col0 = h * D;
  const int kv_end = a.causal ? min(a.seq_kv, q0 + BQ) : a.seq_kv;
  const int tiles = (kv_end + BKV - 1) / BKV;
  const int passes = a.repeats > 0 ? a.repeats : 1;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], is_tma(LD) ? 1 : WG);
      hw::mbar_init(&empty[s], NCW * WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NCW) {  // ---- producer warpgroup: fills the K/V ring ----
    const int ptid = tid - NCW * WG;
    if constexpr (is_tma(LD)) {
      if (ptid != 0) return;
      int stage = 0, phase = 0;
      for (int rep = 0; rep < passes; ++rep)
        for (int t = 0; t < tiles; ++t) {
          hw::mbar_wait(&empty[stage], phase ^ 1);
          hw::mbar_arrive_tx(&full[stage], 2 * T::KV);
          unsigned char* ks = ring + stage * 2 * T::KV;
#pragma unroll
          for (int c = 0; c < D / T::CW; ++c) {
            hw::tma_load_3d(ks + c * BKV * T::SW, &kmap, &full[stage],
                            col0 + c * T::CW, t * BKV, b);
            hw::tma_load_3d(ks + T::KV + c * BKV * T::SW, &vmap,
                            &full[stage], col0 + c * T::CW, t * BKV, b);
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
    } else {
      const size_t kv_base = (size_t)b * a.seq_kv * a.ld_in + col0;
      int stage = 0, phase = 0;
      for (int rep = 0; rep < passes; ++rep)
        for (int t = 0; t < tiles; ++t) {
          hw::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* ks = ring + stage * 2 * T::KV;
#pragma unroll
          for (int it = 0; it < BKV * D / 8 / WG; ++it) {
            const int u = ptid + it * WG;
            const int r = u / (D / 8), c = (u % (D / 8)) * 8;
            const int kv = t * BKV + r;
            float xk[8], xv[8];
            if (kv < a.seq_kv) {
              const size_t i = kv_base + (size_t)kv * a.ld_in + c;
              load8<LD>(a.k, i, xk);
              load8<LD>(a.v, i, xv);
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) xk[j] = xv[j] = 0.f;
            }
            *reinterpret_cast<uint4*>(ks + T::at(BKV, r, c)) = pack8<E>(xk);
            *reinterpret_cast<uint4*>(ks + T::KV + T::at(BKV, r, c)) =
                pack8<E>(xv);
          }
          hw::fence_proxy_async();
          hw::mbar_arrive(&full[stage]);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 ----
  const int wtid = tid % WG, warp = wtid / 32, lane = tid % 32;
  const int r_wg = 64 * wg;                      // first row in the tile
  const int row0 = q0 + r_wg + 16 * warp + lane / 4;  // and row0 + 8
  const int cq = 2 * (lane % 4);                 // first column of a pair
  const size_t q_base = (size_t)b * a.seq * a.ld_in + col0;

  // stage Q: rounded to E, scaled by qscale in f32, rounded again (in
  // training mode rounded only: S is scaled instead)
#pragma unroll
  for (int it = 0; it < 64 * D / 8 / WG; ++it) {
    const int u = wtid + it * WG;
    const int r = u / (D / 8), c = (u % (D / 8)) * 8;
    const int qi = q0 + r_wg + r;
    float x[8];
    if (qi < a.seq) {
      load8<LD>(a.q, q_base + (size_t)qi * a.ld_in + c, x);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = TRAIN ? round16<E>(x[j]) : round16<E>(x[j]) * a.qscale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    *reinterpret_cast<uint4*>(qs + T::at(BQ, r_wg + r, c)) = pack8<E>(x);
  }
  hw::fence_proxy_async();
  hw::bar_sync(1 + wg, WG);

  const unsigned char* qa = qs + r_wg * T::SW;   // this warpgroup's A rows
  const int kv_end_wg = a.causal ? min(a.seq_kv, q0 + r_wg + 64) : a.seq_kv;
  float o[D / 2], l[2];
  int stage = 0, phase = 0;
  for (int rep = 0; rep < passes; ++rep) {
    float m[2] = {-INFINITY, -INFINITY};
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const int kv0 = t * BKV;
      hw::mbar_wait(&full[stage], phase);
      if (kv0 < kv_end_wg) {
        const unsigned char* ks = ring + stage * 2 * T::KV;
        float s[BKV / 2];
        hw::wgmma_fence();
        hw::ss_abt<D, BQ, E>(s, qa, ks);   // S = Q K^T
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(s);
        if constexpr (TRAIN) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) s[i] *= a.qscale;
        }
        if (kv0 + BKV > a.seq_kv ||
            (a.causal && kv0 + BKV - 1 > q0 + r_wg)) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            const int col = kv0 + 8 * (i / 4) + cq + (i & 1);
            const int row = row0 + 8 * ((i / 2) & 1);
            if (col >= a.seq_kv || (a.causal && col > row)) s[i] = -INFINITY;
          }
        }
        // online softmax of the tile: rows row0 (h 0) and row0 + 8 (h 1)
        // (mu: the max, or 0 while a row has seen only -inf)
        float mx[2] = {m[0], m[1]}, mu[2], sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i)
          mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          mu[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];
          alpha[hh] = exp2f(m[hh] - mu[hh]);
          m[hh] = mx[hh];
        }
        uint32_t p[BKV / 16][4];
#pragma unroll
        for (int i = 0; i < BKV / 2; i += 2) {
          const int hh = (i / 2) & 1;
          const float p0 = exp2f(s[i] - mu[hh]);
          const float p1 = exp2f(s[i + 1] - mu[hh]);
          sum[hh] += p0 + p1;
          // S columns 16 kt .. 16 kt + 15 (s[8 kt .. 8 kt + 7]) are the A
          // fragment of P.V's step kt
          p[i / 8][(i % 8) / 2] = pack_p<E, TRAIN>(p0, p1);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + sum[hh];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) & 1];
        hw::fence_regs(o);
        hw::wgmma_fence();
        hw::rs_ab<D, E>(o, p, ks + T::KV);   // O += P V, V MN-major
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(o);
      }
      hw::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    if constexpr (TRAIN) {   // the quad's four lanes agree: one stores
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = row0 + 8 * hh;
        if (lane % 4 == 0 && qi < a.seq)
          a.lse[((size_t)b * gridDim.x + h) * a.seq + qi] =
              m[hh] + log2f(l[hh]);
      }
    }
    if (rep + 1 == passes) break;
    // warm bench: the output, rounded to E, is the next Q
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int hh = (i / 2) & 1, r = r_wg + 16 * warp + lane / 4 + 8 * hh;
      const bool in = row0 + 8 * hh < a.seq;
      const float x0 = in ? round16<E>(o[i] / l[hh]) : 0.f;
      const float x1 = in ? round16<E>(o[i + 1] / l[hh]) : 0.f;
      *reinterpret_cast<uint32_t*>(qs + T::at(BQ, r, 8 * (i / 4) + cq)) =
          hw::pack16<E>(x0 * a.qscale, x1 * a.qscale);
    }
    hw::fence_proxy_async();
    hw::bar_sync(1 + wg, WG);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hh = (i / 2) & 1, qi = row0 + 8 * hh;
    if (qi >= a.seq) continue;
    float x0 = o[i] / l[hh], x1 = o[i + 1] / l[hh];
    if (a.repeats > 0) {
      x0 = round16<E>(x0);
      x1 = round16<E>(x1);
    }
    const size_t at = ((size_t)b * a.seq + qi) * a.ld_out + col0 +
                      8 * (i / 4) + cq;
    if constexpr (TRAIN) {   // B14's O: E, or bf16 over f16 products
      if (a.out_dtype == tpp::dtype_code<E>())
        *reinterpret_cast<uint32_t*>(static_cast<E*>(a.out) + at) =
            hw::pack16<E>(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) +
                                     at) = hw::pack_bf16(x0, x1);
    } else if (a.out_dtype == tpp::kF32) {
      *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) =
          make_float2(x0, x1);
    } else {   // bf16 or f16, whatever E
      *reinterpret_cast<uint32_t*>(static_cast<unsigned short*>(a.out) +
                                   at) = tpp::pair_bits16(a.out_dtype, x0, x1);
    }
  }
}

// The K and V maps of a TMA launch: (columns E, rows seq_kv, batch) of
// 16-bit elements of type H over the operand's head-0 pointer, boxes of
// (SW / 2 columns, BKV rows, 1).
template <int D, class H>
int kv_maps(const Args& a, int heads, int batch, CUtensorMap* kmap,
            CUtensorMap* vmap) {
  using T = Tile<D>;
  const uint64_t dims[3] = {static_cast<uint64_t>(heads) * D,
                            static_cast<uint64_t>(a.seq_kv),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[2] = {static_cast<uint64_t>(a.ld_in) * 2,
                               static_cast<uint64_t>(a.seq_kv) * a.ld_in * 2};
  const uint32_t box[3] = {T::CW, BKV, 1};
  int rc = hw::make_map<H>(kmap, a.k, 3, dims, strides, box, T::SW);
  if (rc == 0)
    rc = hw::make_map<H>(vmap, a.v, 3, dims, strides, box, T::SW);
  return rc;
}

template <Loader LD, int D, bool TRAIN = false>
int launch_mma(const Args& a, int batch, int heads, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap kmap{}, vmap{};
  if constexpr (is_tma(LD)) {
    const int rc = kv_maps<D, Mma<LD>>(a, heads, batch, &kmap, &vmap);
    if (rc) return rc;
  }
  auto kernel = attention_kernel<LD, D, TRAIN>;
  const int smem = T::bytes + 1024;     // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch, (a.seq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(kmap, vmap, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- MXU dtype f32 ("highest"): f32 FMA --------------------------------

constexpr int FBQ = 64, FBKV = 64, FWARPS = 4, FTHREADS = FWARPS * 32;

// Shared-memory plan of one FMA block. K has an odd row stride so lanes
// reading K[lane][d] hit distinct banks.
template <int D>
struct Plan {
  static constexpr int QLD = D + 1;  // Q and K rows
  static constexpr int VLD = D + 4;
  static constexpr int SLD = FBKV + 4;  // f32 scores
  static constexpr int PLD = FBKV + 4;
  static constexpr int OLD = D + 4;     // f32 output acc
  static constexpr size_t up(size_t x) { return (x + 127) / 128 * 128; }
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = up(q_off + FBQ * QLD * sizeof(float));
  static constexpr size_t v_off = up(k_off + FBKV * QLD * sizeof(float));
  static constexpr size_t s_off = up(v_off + FBKV * VLD * sizeof(float));
  static constexpr size_t p_off = up(s_off + FBQ * SLD * sizeof(float));
  static constexpr size_t o_off = up(p_off + FBQ * PLD * sizeof(float));
  static constexpr size_t r_off = up(o_off + FBQ * OLD * sizeof(float));
  static constexpr size_t bytes = up(r_off + 3 * FBQ * sizeof(float));
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
__global__ void __launch_bounds__(FTHREADS) attention_fma_kernel(Args a) {
  using L = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Ps = reinterpret_cast<float*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* Ms = reinterpret_cast<float*>(smem + L::r_off);  // running max
  float* Ls = Ms + FBQ;                                    // running sum
  float* As = Ls + FBQ;                                    // tile rescale

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * FBQ, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)h * D;
  const float* Q = static_cast<const float*>(a.q) +
                   (size_t)b * a.seq * a.ld_in + head;
  const float* K = static_cast<const float*>(a.k) +
                   (size_t)b * a.seq_kv * a.ld_in + head;
  const float* V = static_cast<const float*>(a.v) +
                   (size_t)b * a.seq_kv * a.ld_in + head;

  for (int i = tid; i < FBQ * D; i += FTHREADS) {
    const int r = i / D, c = i % D;
    const float x = q0 + r < a.seq ? Q[(size_t)(q0 + r) * a.ld_in + c] : 0.f;
    Qs[r * L::QLD + c] = x * a.qscale;
  }

  const int r0 = warp * 16;  // this warp's 16 query rows of the tile
  const int kv_end = a.causal ? min(a.seq_kv, q0 + FBQ) : a.seq_kv;
  const int passes = a.repeats > 0 ? a.repeats : 1;
  for (int rep = 0; rep < passes; ++rep) {
    for (int i = tid; i < FBQ * D; i += FTHREADS)
      Os[(i / D) * L::OLD + i % D] = 0.f;
    if (tid < FBQ) {
      Ms[tid] = -INFINITY;
      Ls[tid] = 0.f;
    }
    for (int kv0 = 0; kv0 < kv_end; kv0 += FBKV) {
      __syncthreads();  // Q staged; the previous tile's K/V no longer read
      for (int i = tid; i < FBKV * D; i += FTHREADS) {
        const int r = i / D, c = i % D;
        const bool in = kv0 + r < a.seq_kv;
        const size_t g = (size_t)(kv0 + r) * a.ld_in + c;
        Ks[r * L::QLD + c] = in ? K[g] : 0.f;
        Vs[r * L::VLD + c] = in ? V[g] : 0.f;
      }
      __syncthreads();

      // S = Q K^T for the warp's rows (already in the exp2 domain)
      {
        float acc[16][2];
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) acc[rr][0] = acc[rr][1] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float k0 = Ks[lane * L::QLD + d];
          const float k1 = Ks[(lane + 32) * L::QLD + d];
#pragma unroll
          for (int rr = 0; rr < 16; ++rr) {
            const float qv = Qs[(r0 + rr) * L::QLD + d];
            acc[rr][0] = fmaf(qv, k0, acc[rr][0]);
            acc[rr][1] = fmaf(qv, k1, acc[rr][1]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          Ss[(r0 + rr) * L::SLD + lane] = acc[rr][0];
          Ss[(r0 + rr) * L::SLD + lane + 32] = acc[rr][1];
        }
      }
      __syncwarp();

      // online softmax of the tile, row by row: lane owns columns lane and
      // lane + 32
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr, qi = q0 + r;
        float s[2], mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int kj = kv0 + lane + 32 * t;
          float v = Ss[r * L::SLD + lane + 32 * t];
          if (kj >= a.seq_kv || (a.causal && kj > qi)) v = -INFINITY;
          s[t] = v;
          mx = fmaxf(mx, v);
        }
        mx = warp_max(mx);
        const float m_old = Ms[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float p = m_new == -INFINITY ? 0.f : exp2f(s[t] - m_new);
          sum += p;
          Ps[r * L::PLD + lane + 32 * t] = p;
        }
        sum = warp_sum(sum);
        __syncwarp();
        if (lane == 0) {
          const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
          Ls[r] = Ls[r] * alpha + sum;
          Ms[r] = m_new;
          As[r] = alpha;
        }
      }
      __syncwarp();

      // O = alpha * O + P V for the warp's rows
      {
        constexpr int NT = D / 32;  // output columns lane + 32 t
        float acc[16][NT];
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float alpha = As[r0 + rr];
#pragma unroll
          for (int t = 0; t < NT; ++t)
            acc[rr][t] = Os[(r0 + rr) * L::OLD + lane + 32 * t] * alpha;
        }
        for (int j = 0; j < FBKV; ++j) {
          float vv[NT];
#pragma unroll
          for (int t = 0; t < NT; ++t) vv[t] = Vs[j * L::VLD + lane + 32 * t];
#pragma unroll
          for (int rr = 0; rr < 16; ++rr) {
            const float p = Ps[(r0 + rr) * L::PLD + j];
#pragma unroll
            for (int t = 0; t < NT; ++t)
              acc[rr][t] = fmaf(p, vv[t], acc[rr][t]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 16; ++rr)
#pragma unroll
          for (int t = 0; t < NT; ++t)
            Os[(r0 + rr) * L::OLD + lane + 32 * t] = acc[rr][t];
      }
    }
    __syncthreads();
    if (rep + 1 == passes) break;
    // warm bench: the output is the next Q
    for (int i = tid; i < FBQ * D; i += FTHREADS) {
      const int r = i / D, c = i % D;
      const float o = Os[r * L::OLD + c] / Ls[r];
      Qs[r * L::QLD + c] = (q0 + r < a.seq ? o : 0.f) * a.qscale;
    }
    __syncthreads();
  }  // repeats

  if (a.out_dtype == tpp::kF16) {    // f16: the generic store, apart
    for (int i = tid; i < FBQ * D; i += FTHREADS) {
      const int r = i / D, c = i % D, qi = q0 + r;
      if (qi >= a.seq) continue;
      tpp::store_any(a.out, ((size_t)b * a.seq + qi) * a.ld_out + head + c,
                     a.out_dtype, Os[r * L::OLD + c] / Ls[r]);
    }
    return;
  }
  for (int i = tid; i < FBQ * D; i += FTHREADS) {
    const int r = i / D, c = i % D, qi = q0 + r;
    if (qi >= a.seq) continue;
    tpp::store_out(a.out, ((size_t)b * a.seq + qi) * a.ld_out + head + c,
                   a.out_dtype, Os[r * L::OLD + c] / Ls[r]);
  }
}

template <int D>
int launch_fma(const Args& a, int batch, int heads, cudaStream_t stream) {
  using L = Plan<D>;
  auto kernel = attention_fma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + FBQ - 1) / FBQ, heads, batch);
  kernel<<<grid, FTHREADS, L::bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Args& a, int batch, int heads, int loader,
             cudaStream_t st) {
  switch (loader) {
    case kTma: return launch_mma<kTma, D>(a, batch, heads, st);
    case kConvertF32: return launch_mma<kConvertF32, D>(a, batch, heads, st);
    case kConvertBF16: return launch_mma<kConvertBF16, D>(a, batch, heads, st);
    case kTmaF16: return launch_mma<kTmaF16, D>(a, batch, heads, st);
    default: return launch_fma<D>(a, batch, heads, st);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). q/k/v/out point at
// the first element of head 0 of Q/K/V and of the output; ld_in is their row
// stride in elements (E, or 3E for one packed operand), the output's is E.
// The flat layout is heads = 1 with ld_in = D. `loader` is the route
// xsmm/reference.py attention_loader chose, for the operands' dtype: 0 TMA
// (bf16 operands, 16-byte aligned pointers and strides), 1 the register
// loader of f32 operands at "default", 2 that of bf16 operands TMA cannot
// take, 3 f32 FMA (MXU dtype f32), 4 TMA of f16 operands (f16 products).
// A loader given operands of
// another dtype is refused; the output is f32, bf16 or f16 (one rounding
// of the f32 output, or with repeats, B11, of the state held in the
// products' type, as the reference's B11 casts). The batch goes in
// gridDim.y (gridDim.z for FMA), so
// it is at most 65535.
extern "C" int tpp_attention(const void* q, const void* k, const void* v,
                             void* out, int batch, int seq, int seq_kv,
                             int heads, int head_dim, int ld_in,
                             int in_dtype, int loader, int out_dtype,
                             int causal, int repeats, float qscale,
                             void* stream) {
  const Args a{q,     k,      v,      out,    seq,      seq_kv,
               ld_in, heads * head_dim, qscale, causal, out_dtype, repeats};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the loader must match the operands' dtype
  const int want_in = loader == kTmaF16 ? tpp::kF16
                      : loader == kTma || loader == kConvertBF16 ? tpp::kBF16
                                                                 : tpp::kF32;
  if (loader < 0 || loader > 4 || in_dtype != want_in ||
      !tpp::epilogue_dtypes_ok(out_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32: return launch_d<32>(a, batch, heads, loader, st);
    case 64: return launch_d<64>(a, batch, heads, loader, st);
    case 128: return launch_d<128>(a, batch, heads, loader, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

template <Loader LD>
int launch_train(const Args& a, int batch, int heads, int head_dim,
                 cudaStream_t st) {
  switch (head_dim) {
    case 32: return launch_mma<LD, 32, true>(a, batch, heads, st);
    case 64: return launch_mma<LD, 64, true>(a, batch, heads, st);
    case 128: return launch_mma<LD, 128, true>(a, batch, heads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// B14, the training forward (replaces tpp_mlir_tpu/xsmm/flash_train.py:146
// build_flash_train_fwd), bf16 or f16 operands (`dtype`, epilogue.cuh's
// code): the wgmma kernel above in its training mode over the (B, S, H, D)
// layout (row stride H*D, the TMA loader of the operands' type, products
// of that type), causal or not, P rounded to bf16, O in bf16 and lse2
// (B, H, S) f32. flash_train.cu's tpp_flash_train_fwd sends its 16-bit
// keys here. Returns the cudaError_t of the launch (0 on success).
extern "C" int tpp_attention_train_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse2,
                                       int batch, int seq, int heads,
                                       int head_dim, int dtype, int causal,
                                       float qscale, void* stream) {
  Args a{q,      k,      v,      o,           seq, seq,
         heads * head_dim, heads * head_dim, qscale, causal, tpp::kBF16, 0};
  a.lse = lse2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tpp::kBF16)
    return launch_train<kTma>(a, batch, heads, head_dim, st);
  if (dtype == tpp::kF16)
    return launch_train<kTmaF16>(a, batch, heads, head_dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
