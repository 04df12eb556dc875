// One pipelined TMA + wgmma GEMM mainloop for Hopper (sm_90a), shared by
// the batch-reduce GEMM (csrc/brgemm.cu: B1, B2) and the packed blocked
// matmul (csrc/blocked_matmul.cu: B19), and the consumer loop of the
// grouped GEMMs (csrc/grouped_gemm.cu: B16, B17), the implicit-GEMM conv
// (csrc/conv.cu) and the int8 GEMM (csrc/int8_gemm.cu: B15, s8 products
// with s32 accumulators on the same ring, walked across a persistent
// block's tiles).
//
// The problem is always the packed one:
//   out[i, j] = unary( (C[i, j]) + sum_{r < Kb} A[i, r] . B[j, r]  OP  D )
// with A [Mb, Kb, mb, kb], B [Nb, Kb, kb, nb] (MN-major), [Nb, Kb, nb, kb]
// (K-major: a brgemm's transpose_b) or VNNI [Nb, Kb, kb/2, nb, 2], and C
// and out [Mb, Nb, mb, nb]. A flat brgemm is the case Mb = Nb = 1 (A
// [batch, m, k], B [batch, k, n], out [m, n]): the two kernels differ only
// in how a tile is addressed, and that is one set of tensor-map
// coordinates. The reduction over r (a brgemm's batch) just lengthens the
// k loop: the accumulators never leave registers between batches.
//
// A block computes one BM x BN tile of one (i, j) block (BM = 64 NCW rows,
// BN 64 or 128 columns) over its share of the k slices (64 deep: one
// 128-byte swizzled bf16 row chunk) with:
//   - one producer: a warp whose one thread keeps a ring of STAGES (A tile,
//     B tile) stages full by TMA (loader "tma": 3D maps whose per-dimension
//     out-of-bounds zero fill masks a partial mb, nb or kb, so a tile never
//     reads a neighbouring block), or a warpgroup that loads through
//     registers, rounds to bf16 and stores the same swizzled layout (loader
//     "convert": f32 operands, VNNI B re-laid as MN-major, strides TMA
//     cannot take), so the consumers run one code;
//   - NCW consumer warpgroups of 64 rows running wgmma m64nBNk16 with f32
//     accumulators in registers, one slice's products in flight while the
//     previous slice's stage goes back to the producer (consume_ring);
//   - with the LayerNorm prologue, A arrives raw (bf16 by TMA) and each
//     consumer warpgroup normalizes its 64 rows of the stage in place,
//     (x - mean) rstd gamma + beta in f32 and one rounding to bf16, while
//     the previous stage's products run (LnPrep); the convert loader
//     normalizes as it loads, before its one rounding;
//   - the epilogue through shared memory: the accumulators go to an f32
//     tile in the ring (so they are dead before the epilogue and the
//     mainloop keeps its registers), then rows of it go out with + C, OP D
//     under its broadcast, the unary (one copy per unary, chosen outside
//     the loop) and one rounding to the output dtype; C and D are read in
//     their stored dtype and widened in registers, a row at a time.
// Where the grid is under half a wave even at 64 x 64, k is split into
// `split` slices: each block writes its f32 partial tile to a workspace,
// and split_reduce sums the partials in slice order and runs the epilogue
// once, on the sum, so the result is bit-repeatable. The plan (tile,
// split) is gemm_plan() below.
#pragma once

#include <algorithm>
#include <type_traits>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace tpp {
namespace sm90 {

namespace hw = tpp::hopper;

constexpr int BK = 64;     // k depth of a stage
constexpr int WG = 128;    // threads of a warpgroup

// ---- the consumer loop -------------------------------------------------

// A consume_ring hook that does nothing to a stage.
struct NoPrep {
  __device__ __forceinline__ void operator()(unsigned char*, int) {}
};

// A consumer's place in the ring when it walks several tiles' slices (a
// persistent block): the next stage and its phase.
struct RingPos {
  int stage = 0, phase = 0;
};

// `slices` stages in order, each four products of warpgroup wg's 64 rows
// into acc, one slice's products kept in flight while the previous slice's
// stage goes back to the producer. A stage is an A tile of A_BYTES
// (warpgroup wg's 64 rows at wg * 8 KB) then a B tile of BN columns, 128
// bytes deep. f32 acc: bf16 k16 products, 64 k a stage; A_MN 0: A is
// [M][64 k] K-major; 1: [64 k][64 M] MN-major chunks; B_MN 0: B is
// [BN][64 k] K-major; 1: [64 k][64 N] MN-major chunks. s32 acc: s8 k32
// products, 128 k a stage, both operands K-major (A_MN = B_MN = 0: wgmma
// takes 8-bit operands K-major only). prep(a, kt) runs on warpgroup wg's A
// rows of slice kt once they have landed, before its products (the
// LayerNorm prologue; the others pass none). With `pos` the walk starts at
// *pos, the last stage goes back too once its products are done, and *pos
// is left at the next stage: the producer may already fill it for the next
// tile while this one's epilogue runs. Without it the walk starts at stage
// 0 and keeps the last stage (a block of one tile).
template <int A_MN, int B_MN, int A_BYTES, int BN, int STAGES,
          class Prep = NoPrep, class Acc = float>
__device__ __forceinline__ void consume_ring(Acc (&acc)[BN / 2],
                                             unsigned char* smem,
                                             uint64_t* full, uint64_t* empty,
                                             int slices, int wg,
                                             Prep prep = Prep(),
                                             RingPos* pos = nullptr) {
  constexpr bool S8 = std::is_same<Acc, int>::value;
  static_assert(S8 ? (BN == 128 || BN == 192) && A_MN == 0 && B_MN == 0
                   : BN == 64 || BN == 128,
                "wgmma m64n64/n128 bf16, or m64n128/n192 s8 (K-major)");
  constexpr int STAGE = A_BYTES + BK * BN * 2;
  int stage = pos ? pos->stage : 0, phase = pos ? pos->phase : 0, prev = -1;
  for (int kt = 0; kt < slices; ++kt) {
    hw::mbar_wait(&full[stage], phase);
    // warpgroup wg's A rows: 64 rows of 128 bytes (K-major), or chunk wg
    // of 64 k-rows of 128 bytes (MN-major): 8 KB in either layout
    unsigned char* sa = smem + stage * STAGE + wg * 64 * 128;
    const unsigned char* sb = smem + stage * STAGE + A_BYTES;
    prep(sa, kt);
    hw::fence_regs(acc);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da =
          A_MN ? hw::make_desc<128>(sa + kk * 16 * 128, BK * 128, 1024)
               : hw::make_desc<128>(sa + kk * 32, 16, 1024);
      const uint64_t db =
          B_MN ? hw::make_desc<128>(sb + kk * 16 * 128, BK * 128, 1024)
               : hw::make_desc<128>(sb + kk * 32, 16, 1024);
      if constexpr (S8 && BN == 192)
        hw::wgmma_m64n192k32_s8(acc, da, db, 1);
      else if constexpr (S8)
        hw::wgmma_m64n128k32_s8(acc, da, db, 1);
      else if constexpr (BN == 128)
        hw::wgmma_m64n128k16_ss<B_MN, A_MN>(acc, da, db, 1);
      else
        hw::wgmma_m64n64k16_ss<B_MN, A_MN>(acc, da, db, 1);
    }
    hw::wgmma_commit();
    // the previous slice's products are done: its stage goes back
    hw::wgmma_wait<1>();
    hw::fence_regs(acc);
    if (prev >= 0) hw::mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  hw::wgmma_wait<0>();
  hw::fence_regs(acc);
  if (pos != nullptr) {
    if (prev >= 0) hw::mbar_arrive(&empty[prev]);
    pos->stage = stage;
    pos->phase = phase;
  }
}

// ---- the packed GEMM ---------------------------------------------------

enum BMode : int { kBMn = 0, kBK = 1, kBVnni = 2 };
enum Loader : int { kTma = 0, kConvert = 1 };
// the wrappers' route codes (xsmm/kernels.py _GEMM_ROUTE_CODE): f32
// "highest" stays on each kernel's f32-FMA body
enum Route : int { kRouteFma = 0, kRouteTma = 1, kRouteConvert = 2 };
// LayerNorm prologue: none; on the raw bf16 rows TMA delivers, normalized
// in place by each consumer warpgroup before its products (LnPrep); or by
// the convert loader as it loads (the f32 values are normalized before
// their one rounding)
enum Ln : int { kLnNone = 0, kLnSmem = 1, kLnLoad = 2 };

struct Gemm {
  const void* a;
  const void* b;
  const void* c;
  const void* d;
  void* out;
  float* work;             // split > 1: [split][Mb Nb mb nb] f32 partials
  const float2* stats;     // LayerNorm: (mean, rstd) of each A row
  float2* rowpart;         // ln_stats_out (Mb = Nb = 1, split 1): the (sum,
                           // sum of squares) of each output row's stored
                           // values in each BN-column tile, [nb / BN][mb]
  const float* gamma;      // LayerNorm affine, or null
  const float* beta;
  int Mb, Nb, Kb, mb, nb, kb;
  int in_f32;              // the convert loader's source dtype
  int vec_a, vec_b;        // the convert loader may read 16-byte vectors
  int vec_c, vec_d;        // C and D bases are 16-byte aligned
  int has_c, c_dtype, binary, bcast, d_dtype, unary, out_dtype;
  int split;
};

template <int NCW, int BN>
struct Tile {
  static constexpr int BM = 64 * NCW;
  static constexpr int STAGES = NCW == 2 ? 3 : 4;
  static constexpr int A_BYTES = BM * 128;     // a row: one 128-byte chunk
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int bar_off = STAGES * STAGE;
  // the LayerNorm prologue's (mean, rstd) of the tile's rows
  static constexpr int stats_off = bar_off + 2 * STAGES * 8;
  static constexpr int bytes = stats_off + BM * 8;
};

__device__ __forceinline__ float ld_f32(const void* p, size_t i, int dtype) {
  return dtype == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// N consecutive source elements (f32 or bf16) from element i as f32; the
// ones at or past `valid` read as zero. 16-byte vectors where `vec` says
// the row and the base allow them and the run is whole.
template <int N>
__device__ __forceinline__ void load_run(float (&x)[N], const void* p,
                                         size_t i, int valid, int f32,
                                         int vec) {
  if (vec && valid == N) {
    if (f32) {
      const float4* q =
          reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
#pragma unroll
      for (int v = 0; v < N / 4; ++v) {
        const float4 f = q[v];
        x[4 * v] = f.x; x[4 * v + 1] = f.y;
        x[4 * v + 2] = f.z; x[4 * v + 3] = f.w;
      }
      return;
    }
    if constexpr (N % 8 == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(p) + i);
#pragma unroll
      for (int v = 0; v < N / 8; ++v) {
        const uint4 u = q[v];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          x[8 * v + 2 * e] = f.x;
          x[8 * v + 2 * e + 1] = f.y;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    x[e] = e < valid ? ld_f32(p, i + e, f32 ? kF32 : kBF16) : 0.f;
}

__device__ __forceinline__ uint4 pack8(const float* x) {
  return make_uint4(hw::pack_bf16(x[0], x[1]), hw::pack_bf16(x[2], x[3]),
                    hw::pack_bf16(x[4], x[5]), hw::pack_bf16(x[6], x[7]));
}

__device__ __forceinline__ int clamp_run(int left, int n) {
  return left < 0 ? 0 : (left > n ? n : left);
}

// byte offset of 16-byte unit u (8 bf16 columns) of row `row` in a chunk of
// 128-byte rows, 128-byte swizzled
__device__ __forceinline__ uint32_t unit_at(int row, int u) {
  return row * 128 + ((u ^ (row & 7)) << 4);
}

// The convert loader's units: a unit is 8 (A, B) or 16 (VNNI B)
// consecutive source elements that become one or two 16-byte units of the
// stage. A is [BM][64 k] (8 columns a unit); B is [64 q][BN t] MN-major
// chunks (8 columns), [BN t][64 q] K-major (8 k), or a VNNI2 pair of k rows
// (Q, Q + 1) of 8 columns: 16 interleaved elements, split into rows Q and
// Q + 1.
constexpr int A_ROW_UNITS = 8;   // 16-byte units of 8 columns in an A row

template <int BMODE, int BN>
struct BUnits {
  static constexpr int W = BMODE == kBVnni ? 16 : 8;
  static constexpr int ROW = BMODE == kBK ? 8 : BN / 8;   // units a row
  static constexpr int COUNT = BMODE == kBVnni ? (BK / 2) * ROW
                                               : (BMODE == kBK ? BN : BK) * ROW;
};

// The LayerNorm of 8 values x of row P at columns q.. (q + 8 <= kb, or
// the columns past kb are 0): (x - mean) rstd gamma + beta in f32, 0 past
// kb, with (mean, rstd) = st and gamma/beta the 8 values of the columns
// (gamma null: no affine).
__device__ __forceinline__ void ln8(float (&x)[8], float2 st, int n,
                                    const float (&ga)[8],
                                    const float (&be)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = e < n ? (x[e] - st.x) * st.y * ga[e] + be[e] : 0.f;
}

// gamma and beta at columns q .. q + 7 (1 and 0 without the affine or past
// kb)
__device__ __forceinline__ void ln_affine(const Gemm& g, int q,
                                          float (&ga)[8], float (&be)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool in = g.gamma != nullptr && q + e < g.kb;
    ga[e] = in ? g.gamma[q + e] : 1.f;
    be[e] = in ? g.beta[q + e] : 0.f;
  }
}

template <int LN>
__device__ __forceinline__ void load_a(float (&x)[8], const Gemm& g,
                                       int unit, size_t a_row, int p0,
                                       int q0, const float (&ga)[8],
                                       const float (&be)[8]) {
  const int P = p0 + unit / A_ROW_UNITS;
  const int q = q0 + (unit % A_ROW_UNITS) * 8;
  const int n = P < g.mb ? clamp_run(g.kb - q, 8) : 0;
  load_run<8>(x, g.a, (a_row + P) * g.kb + q, n, g.in_f32, g.vec_a);
  if constexpr (LN == kLnLoad)
    ln8(x, P < g.mb ? g.stats[P] : make_float2(0.f, 0.f), n, ga, be);
}

__device__ __forceinline__ void store_a(unsigned char* sa, int unit,
                                        const float (&x)[8]) {
  *reinterpret_cast<uint4*>(
      sa + unit_at(unit / A_ROW_UNITS, unit % A_ROW_UNITS)) = pack8(x);
}

template <int BMODE, int BN>
__device__ __forceinline__ void load_b(float (&x)[BUnits<BMODE, BN>::W],
                                       const Gemm& g, int unit, size_t b_blk,
                                       int t0, int q0) {
  using U = BUnits<BMODE, BN>;
  if constexpr (BMODE == kBMn) {
    const int Q = q0 + unit / U::ROW, t = t0 + (unit % U::ROW) * 8;
    load_run<8>(x, g.b, (b_blk * g.kb + Q) * g.nb + t,
                Q < g.kb ? clamp_run(g.nb - t, 8) : 0, g.in_f32, g.vec_b);
  } else if constexpr (BMODE == kBK) {
    const int T = t0 + unit / 8, q = q0 + (unit % 8) * 8;
    load_run<8>(x, g.b, (b_blk * g.nb + T) * g.kb + q,
                T < g.nb ? clamp_run(g.kb - q, 8) : 0, g.in_f32, g.vec_b);
  } else {
    const int Q = q0 + 2 * (unit / U::ROW), t = t0 + (unit % U::ROW) * 8;
    load_run<16>(x, g.b, ((b_blk * (g.kb / 2) + Q / 2) * g.nb + t) * 2,
                 Q < g.kb ? 2 * clamp_run(g.nb - t, 8) : 0, g.in_f32,
                 g.vec_b);
  }
}

template <int BMODE, int BN>
__device__ __forceinline__ void store_b(
    unsigned char* sb, int unit, const float (&x)[BUnits<BMODE, BN>::W]) {
  using U = BUnits<BMODE, BN>;
  if constexpr (BMODE == kBK) {
    *reinterpret_cast<uint4*>(sb + unit_at(unit / 8, unit % 8)) = pack8(x);
  } else {
    const int u = unit % U::ROW;
    unsigned char* chunk = sb + (u / 8) * BK * 128;
    if constexpr (BMODE == kBMn) {
      *reinterpret_cast<uint4*>(chunk + unit_at(unit / U::ROW, u % 8)) =
          pack8(x);
    } else {
      const int q = 2 * (unit / U::ROW);
      float lo[8], hi[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        lo[c] = x[2 * c];
        hi[c] = x[2 * c + 1];
      }
      *reinterpret_cast<uint4*>(chunk + unit_at(q, u % 8)) = pack8(lo);
      *reinterpret_cast<uint4*>(chunk + unit_at(q + 1, u % 8)) = pack8(hi);
    }
  }
}

// The convert loader: the producer warpgroup (thread ptid) fills stage
// after stage through registers, rounding to bf16 (with the LayerNorm
// prologue, after normalizing in f32), in the layouts TMA would write;
// elements past the block's mb, nb or kb are zero. A stage's loads go out
// in one round (two for the larger tiles, to bound the registers) before
// any of its stores, so one thread keeps up to 64 values in flight.
template <int NCW, int BN, int BMODE, int LN>
__device__ __forceinline__ void produce_convert(const Gemm& g,
                                                unsigned char* smem,
                                                uint64_t* full,
                                                uint64_t* empty, int ptid,
                                                int i, int j, int p0, int t0,
                                                int s_lo, int s_hi, int kpb) {
  using T = Tile<NCW, BN>;
  using UB = BUnits<BMODE, BN>;
  constexpr int NA = T::BM * A_ROW_UNITS / WG, NB = UB::COUNT / WG;
  constexpr int R = (T::BM == 128 || BN == 128) ? 2 : 1;
  static_assert(NA % R == 0 && NB % R == 0, "whole rounds");
  static_assert(WG % A_ROW_UNITS == 0, "a thread's A columns are fixed");
  constexpr int RA = NA / R, RB = NB / R;
  float ga[8], be[8];   // the LayerNorm affine at the thread's A columns
  int stage = 0, phase = 0;
  for (int kt = s_lo; kt < s_hi; ++kt) {
    const int r = kt / kpb, q0 = (kt % kpb) * BK;
    if constexpr (LN == kLnLoad)
      ln_affine(g, q0 + (ptid % A_ROW_UNITS) * 8, ga, be);
    hw::mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* sa = smem + stage * T::STAGE;
    unsigned char* sb = sa + T::A_BYTES;
    const size_t a_row = ((size_t)i * g.Kb + r) * g.mb;   // A row of p = 0
    const size_t b_blk = (size_t)j * g.Kb + r;
#pragma unroll
    for (int h = 0; h < R; ++h) {
      float xa[RA][8], xb[RB][UB::W];
#pragma unroll
      for (int e = 0; e < RA; ++e)
        load_a<LN>(xa[e], g, ptid + (h * RA + e) * WG, a_row, p0, q0, ga,
                   be);
#pragma unroll
      for (int e = 0; e < RB; ++e)
        load_b<BMODE, BN>(xb[e], g, ptid + (h * RB + e) * WG, b_blk, t0, q0);
#pragma unroll
      for (int e = 0; e < RA; ++e)
        store_a(sa, ptid + (h * RA + e) * WG, xa[e]);
#pragma unroll
      for (int e = 0; e < RB; ++e)
        store_b<BMODE, BN>(sb, ptid + (h * RB + e) * WG, xb[e]);
    }
    hw::fence_proxy_async();
    hw::mbar_arrive(&full[stage]);
    if (++stage == T::STAGES) { stage = 0; phase ^= 1; }
  }
}

// The LayerNorm prologue on the raw bf16 A rows TMA delivered: consumer
// warpgroup wg normalizes its 64 rows of a stage in place (thread ctid
// takes the 16-byte units of column group ctid % 8 in rows ctid / 8 +
// 16 e), in f32 from the rows' (mean, rstd) (in shared memory: the block
// loads its rows' once), one rounding to bf16, then makes the writes
// visible to wgmma (the async proxy) and waits for its warpgroup.
struct LnPrep {
  const Gemm* g;
  const float2* st;   // (mean, rstd) of warpgroup wg's 64 rows
  int s_lo, kpb, wg, ctid;

  __device__ __forceinline__ LnPrep(const Gemm& gm, const float2* stats,
                                    int lo, int kp, int w)
      : g(&gm), st(stats + w * 64), s_lo(lo), kpb(kp), wg(w),
        ctid(threadIdx.x % WG) {}

  __device__ __forceinline__ void operator()(unsigned char* sa, int kt) {
    const int u = ctid % A_ROW_UNITS;
    const int q = ((s_lo + kt) % kpb) * BK + u * 8;
    const int n = clamp_run(g->kb - q, 8);
    float ga[8], be[8];
    ln_affine(*g, q, ga, be);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ctid / A_ROW_UNITS + 16 * e;
      uint4* at = reinterpret_cast<uint4*>(sa + unit_at(row, u));
      const uint4 raw = *at;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float x[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 f = __bfloat1622float2(h[c]);
        x[2 * c] = f.x;
        x[2 * c + 1] = f.y;
      }
      ln8(x, st[row], n, ga, be);
      *at = pack8(x);
    }
    hw::fence_proxy_async();
    hw::bar_sync(2 + wg, WG);
  }
};

// D's element for output element o = (block (i, j), row p, column t)
__device__ __forceinline__ float d_at(const Gemm& g, size_t o, int i, int j,
                                      int p, int t) {
  switch (g.bcast) {
    case kBcastCol: return ld_f32(g.d, (size_t)j * g.nb + t, g.d_dtype);
    case kBcastRow: return ld_f32(g.d, (size_t)i * g.mb + p, g.d_dtype);
    case kBcastScalar: return ld_f32(g.d, 0, g.d_dtype);
    default: return ld_f32(g.d, o, g.d_dtype);
  }
}

// n (<= 4) consecutive f32 or bf16 values from element i, zero past n; one
// 16-byte (f32) or 8-byte (bf16) load where `vec`
__device__ __forceinline__ void load4(float (&x)[4], const void* p, size_t i,
                                      int dtype, bool vec, int n) {
  if (vec && dtype == kBF16) {
    const uint2 u =
        *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) +
                                        i);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
  } else if (vec) {
    const float4 f =
        *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = e < n ? ld_f32(p, i + e, dtype) : 0.f;
  }
}

// The f32 output tile [BM][BN + 8] in shared memory (the ring's, once every
// consumer is done with it) out to device memory: thread ctid takes the
// four-column run ctid % (BN / 4) of every (THREADS / (BN / 4))-th row, so
// C, D and the output go a row at a time. A column bias is loaded once;
// the loads of R rows (the tile, C, D) are issued before their stores: the
// compiler cannot know the output aliases nothing, and loads behind stores
// would wait a round trip each. With split > 1 the raw partial goes to
// slice ks of the workspace; otherwise + C, OP D, the unary U, one
// rounding. With g.rowpart, each row's stored values (after that rounding)
// are summed, and squared and summed, over the tile's columns: a thread's
// run in column order, then a shuffle tree over the RUNS threads of the row
// (within one warp), so the partial is the same at every launch; the row's
// lead thread writes it to g.rowpart[tile column][row].
template <int BM, int BN, int THREADS, int U>
__device__ __forceinline__ void epilogue_rows(const Gemm& g,
                                              const float* tile, int i,
                                              int j, int p0, int t0, int ks,
                                              int ctid) {
  constexpr int LD = BN + 8, RUNS = BN / 4, STEP = THREADS / RUNS, R = 4;
  static_assert(THREADS % RUNS == 0 && BM % (STEP * R) == 0, "whole rows");
  const size_t blk = ((size_t)i * g.Nb + j) * g.mb;
  static_assert(32 % RUNS == 0, "a row's runs lie in one warp");
  const int t = t0 + (ctid % RUNS) * 4, n = clamp_run(g.nb - t, 4);
  const bool stats = g.rowpart != nullptr;   // the same for every thread
  if (n == 0 && !stats) return;   // with stats it joins the row's shuffles
  const bool vec = (g.nb & 3) == 0 && n == 4;
  const bool epi = g.split == 1;
  float dcol[4] = {0.f, 0.f, 0.f, 0.f};
  if (epi && g.binary != kBinNone && g.bcast == kBcastCol)
    load4(dcol, g.d, (size_t)j * g.nb + t, g.d_dtype, vec && g.vec_d, n);
#pragma unroll 1
  for (int r0 = ctid / RUNS; r0 < BM; r0 += STEP * R) {
    float v[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r0 + r * STEP, p = p0 + row;
      const float4 f = *reinterpret_cast<const float4*>(tile + row * LD +
                                                        (ctid % RUNS) * 4);
      v[r][0] = f.x; v[r][1] = f.y; v[r][2] = f.z; v[r][3] = f.w;
      if (!epi || p >= g.mb || n == 0) continue;
      const size_t o = (blk + p) * g.nb + t;
      float c[4] = {0.f, 0.f, 0.f, 0.f}, d[4];
      if (g.has_c) load4(c, g.c, o, g.c_dtype, vec && g.vec_c, n);
      if (g.binary == kBinNone || g.bcast == kBcastCol) {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = dcol[e];
      } else if (g.bcast == kBcastNone) {
        load4(d, g.d, o, g.d_dtype, vec && g.vec_d, n);
      } else {
        const float x = ld_f32(
            g.d, g.bcast == kBcastRow ? (size_t)i * g.mb + p : 0, g.d_dtype);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = x;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = v[r][e] + c[e];
        v[r][e] = g.binary != kBinNone ? apply_binary(g.binary, x, d[e]) : x;
      }
    }
    float s1[R], s2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r0 + r * STEP;
      s1[r] = s2[r] = 0.f;
      // a run with no column takes part in the shuffles below and in
      // nothing else. The skip (and the first loop's) is load-bearing on
      // the card: without them (scripts/exp_column_run.py's "noskip"
      // build) every ln_stats_out key stored into the next row's first
      // columns (rel 0.58-0.84 at n 136, 200 and 3000, f32 and bf16),
      // though each store below is predicated off at n == 0 (e < n; vec is
      // false there); keys without ln_stats_out, whose no-column threads
      // return above, and the FMA body were right. The cause lies below
      // the source (the compiled code was not read): keep such a run out
      // of the row's I/O entirely.
      if (p >= g.mb || n == 0) continue;
      const size_t o = (blk + p) * g.nb + t;
      float* x = v[r];
      if (!epi) {
        float* w = g.work + (size_t)ks * g.Mb * g.Nb * g.mb * g.nb + o;
        if (vec) {
          *reinterpret_cast<float4*>(w) = make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < n) w[e] = x[e];
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = apply_unary(U, x[e]);
      if (stats) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = e < n ? round_out(g.out_dtype, x[e]) : 0.f;
          s1[r] += y;
          s2[r] += y * y;
        }
      }
      if (vec && g.out_dtype == kBF16) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(g.out) + o) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      } else if (vec) {
        *reinterpret_cast<float4*>(static_cast<float*>(g.out) + o) =
            make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < n) store_out(g.out, o + e, g.out_dtype, x[e]);
      }
    }
    if (stats) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int off = RUNS / 2; off > 0; off >>= 1) {
          s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], off);
          s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], off);
        }
        const int p = p0 + r0 + r * STEP;
        if (ctid % RUNS == 0 && p < g.mb)
          g.rowpart[(size_t)(t0 / BN) * g.mb + p] = make_float2(s1[r], s2[r]);
      }
    }
  }
}

// The accumulators of warpgroup wg (rows p0 + 64 wg + ...) into the shared
// f32 tile, then the block's epilogue over it. acc[4 jj + 2 h + e] is row
// 16 warp + lane / 4 + 8 h, column 8 jj + 2 (lane % 4) + e of the
// warpgroup's 64 rows. Every consumer thread of the block takes part
// (named barrier 1).
template <int NCW, int BN>
__device__ __forceinline__ void store_tile(float (&acc)[BN / 2],
                                           unsigned char* smem,
                                           const Gemm& g, int i, int j,
                                           int p0, int t0, int ks) {
  constexpr int BM = 64 * NCW, LD = BN + 8, THREADS = NCW * WG;
  const int ctid = threadIdx.x, lane = ctid % 32;
  const int row = (ctid / WG) * 64 + ((ctid % WG) / 32) * 16 + lane / 4;
  float* tile = reinterpret_cast<float*>(smem);
  hw::bar_sync(1, THREADS);   // every warpgroup is done with the ring
#pragma unroll
  for (int x = 0; x < BN / 2; x += 2) {
    const int r = row + 8 * ((x / 2) & 1), c = 8 * (x / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(tile + r * LD + c) =
        make_float2(acc[x], acc[x + 1]);
  }
  hw::bar_sync(1, THREADS);
  switch (g.split > 1 ? kIdentity : g.unary) {
#define TPP_EPILOGUE(U)                                                    \
  case U:                                                                  \
    epilogue_rows<BM, BN, THREADS, U>(g, tile, i, j, p0, t0, ks, ctid);    \
    break;
    TPP_EPILOGUE(kRelu)
    TPP_EPILOGUE(kExp)
    TPP_EPILOGUE(kSquare)
    TPP_EPILOGUE(kSqrt)
    TPP_EPILOGUE(kRsqrt)
    TPP_EPILOGUE(kTanh)
    TPP_EPILOGUE(kGelu)
    TPP_EPILOGUE(kGeluTanh)
    TPP_EPILOGUE(kNegate)
    TPP_EPILOGUE(kZero)
#undef TPP_EPILOGUE
    default:
      epilogue_rows<BM, BN, THREADS, kIdentity>(g, tile, i, j, p0, t0, ks,
                                                ctid);
  }
}

template <int NCW, int BN, int BMODE, int LOADER, int LN>
// Two blocks an SM where the registers allow it without spilling (ptxas,
// 112 a thread at 288 threads); a 128-row block with a convert warpgroup
// or the LayerNorm prologue takes one.
__global__ void __launch_bounds__(
    NCW * WG + (LOADER == kTma ? 32 : WG),
    (NCW == 2 && (LOADER == kConvert || LN != kLnNone)) ? 1 : 2)
gemm_kernel(const __grid_constant__ CUtensorMap amap,
            const __grid_constant__ CUtensorMap bmap,
            const __grid_constant__ Gemm g) {
  using T = Tile<NCW, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bar_off);
  uint64_t* empty = full + T::STAGES;

  const int tid = threadIdx.x, wg = tid / WG;
  const int mt = (g.mb + T::BM - 1) / T::BM, nt = (g.nb + BN - 1) / BN;
  const int i = blockIdx.x / mt, p0 = (blockIdx.x % mt) * T::BM;
  const int j = blockIdx.y / nt, t0 = (blockIdx.y % nt) * BN;
  const int kpb = (g.kb + BK - 1) / BK, KT = g.Kb * kpb, ks = blockIdx.z;
  const int s_lo = static_cast<int>((long long)ks * KT / g.split);
  const int s_hi = static_cast<int>((long long)(ks + 1) * KT / g.split);

  float2* stats = reinterpret_cast<float2*>(smem + T::stats_off);
  if constexpr (LN == kLnSmem)
    for (int r = tid; r < T::BM; r += blockDim.x)
      stats[r] = p0 + r < g.mb ? g.stats[p0 + r] : make_float2(0.f, 0.f);
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hw::mbar_init(&full[s], LOADER == kTma ? 1 : WG);
      hw::mbar_init(&empty[s], NCW * WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NCW) {  // ---- producer ----
    if constexpr (LOADER == kTma) {
      if (tid != NCW * WG) return;
      int stage = 0, phase = 0;
      for (int kt = s_lo; kt < s_hi; ++kt) {
        const int r = kt / kpb, q0 = (kt % kpb) * BK;
        hw::mbar_wait(&empty[stage], phase ^ 1);
        hw::mbar_arrive_tx(&full[stage], T::STAGE);
        unsigned char* sa = smem + stage * T::STAGE;
        unsigned char* sb = sa + T::A_BYTES;
        hw::tma_load_3d(sa, &amap, &full[stage], q0, p0, i * g.Kb + r);
        if constexpr (BMODE == kBK) {
          hw::tma_load_3d(sb, &bmap, &full[stage], q0, t0, j * g.Kb + r);
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            hw::tma_load_3d(sb + c * BK * 128, &bmap, &full[stage],
                            t0 + 64 * c, q0, j * g.Kb + r);
        }
        if (++stage == T::STAGES) { stage = 0; phase ^= 1; }
      }
    } else {
      produce_convert<NCW, BN, BMODE, LN>(g, smem, full, empty, tid - NCW * WG,
                                          i, j, p0, t0, s_lo, s_hi, kpb);
    }
    return;
  }

  // ---- consumer warpgroup wg: rows p0 + 64 wg .. + 63 ----
  float acc[BN / 2];
#pragma unroll
  for (int x = 0; x < BN / 2; ++x) acc[x] = 0.f;
  constexpr int B_MN = BMODE == kBK ? 0 : 1;
  if constexpr (LN == kLnSmem)
    consume_ring<0, B_MN, T::A_BYTES, BN, T::STAGES>(
        acc, smem, full, empty, s_hi - s_lo, wg,
        LnPrep(g, stats, s_lo, kpb, wg));
  else
    consume_ring<0, B_MN, T::A_BYTES, BN, T::STAGES>(
        acc, smem, full, empty, s_hi - s_lo, wg);
  static_assert(T::BM * (BN + 8) * 4 <= T::bar_off,
                "the output tile fits in the ring");
  store_tile<NCW, BN>(acc, smem, g, i, j, p0, t0, ks);
}

// The split partials summed in slice order, then the epilogue, once an
// output element. (static: each source that includes this header has its
// own copy.)
static __global__ void __launch_bounds__(256) split_reduce(const Gemm g) {
  const size_t total = (size_t)g.Mb * g.Nb * g.mb * g.nb;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    float v = g.work[o];
    for (int s = 1; s < g.split; ++s) v += g.work[(size_t)s * total + o];
    const int t = static_cast<int>(o % g.nb);
    const size_t row = o / g.nb;
    const int p = static_cast<int>(row % g.mb);
    const int j = static_cast<int>((row / g.mb) % g.Nb);
    const int i = static_cast<int>(row / ((size_t)g.mb * g.Nb));
    if (g.has_c) v += ld_f32(g.c, o, g.c_dtype);
    if (g.binary != kBinNone)
      v = apply_binary(g.binary, v, d_at(g, o, i, j, p, t));
    store_out(g.out, o, g.out_dtype, apply_unary(g.unary, v));
  }
}

// ---- host: the plan and the launch --------------------------------------

inline int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 132;
  }
  return cache[dev];
}

struct Plan {
  int bm, bn, split;
};

// The tile and the k split for a packed problem on this card: the largest
// tile of 128 x 128, 64 x 128, 64 x 64 whose grid fills at least half a
// wave of the card's SMs (a 128-row tile's two warpgroups share each B
// tile: half the L2 traffic a flop of two 64-row blocks, which at the
// slice's sizes outweighs the SMs a smaller grid leaves idle); under that,
// 64 x 64 tiles and k split into as many slices as fill the wave, each
// slice at least four 64-deep stages. no_split (the row statistics of
// ln_stats_out are taken in the tile epilogue, which a split defers to
// split_reduce) keeps 64 x 64 tiles unsplit there.
inline Plan gemm_plan(int Mb, int Nb, int Kb, int mb, int nb, int kb,
                      bool no_split = false) {
  const int sms = sm_count();
  auto tiles = [&](int bm, int bn) {
    return (long long)Mb * ((mb + bm - 1) / bm) * Nb * ((nb + bn - 1) / bn);
  };
  const int cand[3][2] = {{128, 128}, {64, 128}, {64, 64}};
  for (const auto& c : cand)
    if (2 * tiles(c[0], c[1]) >= sms) return {c[0], c[1], 1};
  if (no_split) return {64, 64, 1};
  const long long t = tiles(64, 64);
  const long long kt = (long long)Kb * ((kb + BK - 1) / BK);
  const long long s = std::min<long long>(sms / t, kt / 4);
  return {64, 64, static_cast<int>(std::max<long long>(s, 1))};
}

// bytes of the f32 split partials (0 without a split), after them the
// LayerNorm statistics of `ln_rows` rows, and after those the ln_stats_out
// row partials of `part_rows` rows ([nb / bn tiles][part_rows] float2)
inline size_t work_bytes(const Plan& p, int Mb, int Nb, int mb, int nb,
                         int ln_rows, int part_rows = 0) {
  const size_t part = p.split > 1
                          ? (size_t)p.split * Mb * Nb * mb * nb * sizeof(float)
                          : 0;
  const size_t tiles = (size_t)(nb + p.bn - 1) / p.bn;
  return (part + 15) / 16 * 16 +
         ((size_t)ln_rows + tiles * part_rows) * sizeof(float2);
}

// ---- forced plans (xsmm/tune.py) ---------------------------------------
// A launch runs the plan its wrapper asked tpp_gemm_plan for, with the
// workspace sized for that plan: the plan is made once, on the host, and
// checked here again, never recomputed.

// tpp_gemm_plan's flags: a LayerNorm prologue of either kind (the (mean,
// rstd) of the rows in the workspace), ln_stats_out (no k split; the rows'
// partials of each column tile), the f32-FMA body of f32 "highest"
enum PlanFlag : int { kPlanLn = 1, kPlanStatsOut = 2, kPlanFma = 4 };
constexpr int kFmaTile = 64;   // the FMA bodies' one tile, no split

// the launcher's own plan
inline Plan heuristic_plan(int Mb, int Nb, int Kb, int mb, int nb, int kb,
                           int flags) {
  if (flags & kPlanFma) return {kFmaTile, kFmaTile, 1};
  return gemm_plan(Mb, Nb, Kb, mb, nb, kb, (flags & kPlanStatsOut) != 0);
}

// whether the mainloop runs plan p: a tile it is instantiated at (launch_plan
// below; the FMA body: its one tile), and 1 <= split <= the 64-deep k
// stages, no split for the FMA body or ln_stats_out (xsmm/reference.py
// check_gemm_plan is the mirror the CPU tests hold)
inline bool plan_legal(const Plan& p, int Kb, int kb, int flags) {
  const bool tile =
      (flags & kPlanFma)
          ? p.bm == kFmaTile && p.bn == kFmaTile
          : (p.bm == 128 && p.bn == 128) || (p.bm == 64 && p.bn == 128) ||
                (p.bm == 64 && p.bn == 64);
  const long long stages = (long long)Kb * ((kb + BK - 1) / BK);
  const long long most = (flags & (kPlanFma | kPlanStatsOut)) ? 1 : stages;
  return tile && p.split >= 1 && p.split <= most;
}

// The plan at a forced {bm, bn, split} (null: none), zeros where the
// heuristic decides: its tile, and its split where the tile is its own,
// else no split. False for a plan the mainloop does not run.
inline bool resolve_plan(int Mb, int Nb, int Kb, int mb, int nb, int kb,
                         int flags, const int* force, Plan* out) {
  const Plan h = heuristic_plan(Mb, Nb, Kb, mb, nb, kb, flags);
  Plan p = h;
  if (force != nullptr) {
    if (force[0] != 0 || force[1] != 0) {
      p.bm = force[0];
      p.bn = force[1];
    }
    p.split = force[2] != 0                       ? force[2]
              : (p.bm == h.bm && p.bn == h.bn) ? h.split
                                               : 1;
  }
  *out = p;
  return plan_legal(p, Kb, kb, flags);
}

// the workspace of plan p under `flags`: the split partials, the rows'
// LayerNorm statistics, the ln_stats_out row partials (work_bytes)
inline size_t plan_work(const Plan& p, int Mb, int Nb, int mb, int nb,
                        int flags) {
  return work_bytes(p, Mb, Nb, mb, nb, (flags & kPlanLn) ? Mb * mb : 0,
                    (flags & kPlanStatsOut) ? Mb * mb : 0);
}

// A launch's plan {bm, bn, split, workspace bytes} as tpp_gemm_plan gave
// it: false for a missing or illegal plan, or one whose bytes are not this
// plan's (a workspace sized for another plan would be overrun).
inline bool launch_plan_ok(const long long* plan, int Mb, int Nb, int Kb,
                           int mb, int nb, int kb, int flags, Plan* p) {
  if (plan == nullptr) return false;
  *p = Plan{static_cast<int>(plan[0]), static_cast<int>(plan[1]),
            static_cast<int>(plan[2])};
  return plan_legal(*p, Kb, kb, flags) &&
         static_cast<long long>(plan_work(*p, Mb, Nb, mb, nb, flags)) ==
             plan[3];
}

template <int NCW, int BN, int BMODE, int LOADER, int LN>
int launch(const Gemm& g, const CUtensorMap& amap, const CUtensorMap& bmap,
           cudaStream_t st) {
  using T = Tile<NCW, BN>;
  auto kernel = gemm_kernel<NCW, BN, BMODE, LOADER, LN>;
  constexpr int smem = T::bytes + 1024;  // + the 1024-byte alignment
  static unsigned long long opted = 0;   // devices the attribute is set on
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(opted >> (dev & 63) & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted |= 1ull << (dev & 63);
  }
  const dim3 grid(g.Mb * ((g.mb + T::BM - 1) / T::BM),
                  g.Nb * ((g.nb + BN - 1) / BN), g.split);
  kernel<<<grid, NCW * WG + (LOADER == kTma ? 32 : WG), smem, st>>>(amap,
                                                                    bmap, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.split == 1) return static_cast<int>(err);
  const size_t total = (size_t)g.Mb * g.Nb * g.mb * g.nb;
  const int blocks = static_cast<int>(
      std::min<size_t>((total + 255) / 256, (size_t)sm_count() * 8));
  split_reduce<<<blocks, 256, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// launch() at the plan's tile
template <int BMODE, int LOADER, int LN>
int launch_plan(const Plan& p, const Gemm& g, const CUtensorMap& amap,
                const CUtensorMap& bmap, cudaStream_t st) {
  if (p.bm == 128)
    return launch<2, 128, BMODE, LOADER, LN>(g, amap, bmap, st);
  if (p.bn == 128) return launch<1, 128, BMODE, LOADER, LN>(g, amap, bmap, st);
  return launch<1, 64, BMODE, LOADER, LN>(g, amap, bmap, st);
}

// The 3D tensor maps of the "tma" loader over bf16 operands. A [Mb, Kb,
// mb, kb] is (kb, mb, Mb Kb) (Mb's stride is Kb times Kb's, so the two are
// one dimension, coordinate i Kb + r), in (64 k x BM rows) boxes; B [Nb,
// Kb, kb, nb] is (nb, kb, Nb Kb) in (64 n x 64 k) boxes (MN-major), or
// [Nb, Kb, nb, kb] (kb, nb, Nb Kb) in (64 k x BN n) boxes (K-major).
// Out-of-bounds rows and columns of a block read as zero.
inline int make_maps(CUtensorMap* amap, CUtensorMap* bmap, const Gemm& g,
                     const Plan& p, int bmode) {
  const uint64_t mb = g.mb, nb = g.nb, kb = g.kb;
  const uint64_t a_dims[3] = {kb, mb, (uint64_t)g.Mb * g.Kb};
  const uint64_t a_strides[2] = {kb * 2, mb * kb * 2};
  const uint32_t a_box[3] = {BK, static_cast<uint32_t>(p.bm), 1};
  int rc = hw::make_map(amap, g.a, 3, a_dims, a_strides, a_box, 128);
  if (rc) return rc;
  const uint64_t inner = bmode == kBK ? kb : nb, outer = bmode == kBK ? nb : kb;
  const uint64_t b_dims[3] = {inner, outer, (uint64_t)g.Nb * g.Kb};
  const uint64_t b_strides[2] = {inner * 2, outer * inner * 2};
  const uint32_t b_box[3] = {
      64, static_cast<uint32_t>(bmode == kBK ? p.bn : BK), 1};
  return hw::make_map(bmap, g.b, 3, b_dims, b_strides, b_box, 128);
}

// whether 16-byte vector loads can read rows of `row_elems` elements of
// `es` bytes from `base`
inline int vec_ok(const void* base, long long row_elems, int es) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
         (row_elems * es) % 16 == 0;
}

}  // namespace sm90
}  // namespace tpp
