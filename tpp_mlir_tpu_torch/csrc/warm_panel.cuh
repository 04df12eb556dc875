// The warm-panel engine for Hopper (sm_90a): a row panel carried through a
// fixed sequence of GEMM steps inside one launch, each step's output fed
// back as the next step's input, the rows independent. It runs the
// whole-chain MLP (csrc/chain.cu: B3, B4 and B5's ping-pong) and the packed
// warm bench (csrc/blocked_matmul.cu: B20); the two differ only in how the
// input, the weights and the output are addressed.
//
// The TPU kernels keep every weight resident in VMEM and loop the repeats
// over an "arbitrary" grid axis (tpp_mlir_tpu/xsmm/kernels.py:870-878,
// :1919-1928, :2001-2008). On the H100 one block cannot hold the weights
// nor fill the card, so a row panel of P rows (16, 24, 32, 40 or 64: a
// multiple of 8, wgmma's N, chosen so the panels fit one wave; the H100
// holds 7 clusters of 16) is shared by a cluster of C blocks (C <= 16;
// above 8 the launch allows non-portable cluster sizes) and each block
// owns a share of every step's output columns: the 64-column tiles rank,
// rank + C, rank + 2C, ... A block is a consumer warpgroup, a feeder warp
// and a sender warp. Per step:
//   - products with the batch rows as wgmma's N ("swap AB"): the
//     consumers compute D[64 columns x P rows] = W_slice^T . H^T with
//     wgmma.m64nPk16, A the 64 x 64 weight slice in shared memory (MN-major
//     through trans-a for the forward step, h W; K-major for B5's backward
//     step, h W^T, W's rows read in place), B the panel H [P][K] in the
//     K-major 128-byte swizzled chunks of 64 columns it is stored in, each
//     chunk waited on as it lands; f32 accumulators in registers, eight
//     independent chains (a chain of dependent small products is bound by
//     their latency);
//   - the epilogue in registers (OP D along the columns, the unary, one
//     rounding to the 16-bit product type E -- bf16, or f16 for an f16 key
//     (ROADMAP A14) -- exactly where the plain version rounds) into a
//     local staging tile (two, used in turns); columns past N are zero and
//     never stored;
//   - the exchange: the consumers arrive at every block's `freed` barrier
//     once their products are done and hand the staging to the sender
//     (named barrier 2); once every block has freed its panel, the sender
//     arms its own chunks' `landed` barriers with the next panel's bytes
//     and copies each staging tile into the panel of every block of the
//     cluster, its own included, by the bulk-copy engine (distributed
//     shared memory), each copy completing on the receiver's barrier of
//     that chunk. One panel buffer, no cluster-wide barrier a step, no
//     thread stores into a peer.
// The last step stores its tiles to device memory from registers instead
// (f32 unrounded for B3, else the state in E), so a run reads x once and
// writes the output once; rows past m are zero in the panel and never
// stored. Weights are either resident (every slice a block owns at every
// step, loaded once at the start through registers, rounded to E there: f32
// and VNNI-packed weights read in place, so no conversion runs on the
// repeat loop; an f16 weight's values pass unchanged) or streamed from L2
// (row-major weights in E by 2D TMA
// through a ring of STAGES 64 x 64 slices that the feeder keeps full: the
// weight sequence does not depend on the data, so the next step's slices
// land while this step's exchange runs). No atomics and a fixed sum order:
// every launch is bit-repeatable.
//
// What bounds it (NVIDIA H100 80GB HBM3, scripts/exp_warm_plan.py's
// timeline): every block receives the whole next panel, P x N x 2 bytes a
// step, at the distributed-shared-memory rate (~14 bytes a cycle an SM);
// streamed weights come from L2 at ~20 GB/s an SM.
//
// The plan (P, C, resident or streamed, the shared-memory bytes) is the
// wrapper's, from xsmm/reference.py warm_plan, a pure function of the key;
// run() recomputes the layout and refuses a plan whose bytes disagree.
#pragma once

#include <algorithm>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace tpp {
namespace warm {

namespace hw = tpp::hopper;

constexpr int WG = 128;                   // the consumer warpgroup
constexpr int THREADS = WG + 64;          // + a feeder and a sender warp
constexpr int TILE = 64;                  // a tile's columns, a slice's depth
constexpr int SLICE = TILE * TILE * 2;    // a 64 x 64 16-bit weight slice
constexpr int STAGES = 8;                 // the streamed ring
constexpr int MAXS = 32;                  // steps of a period (chain.cu MAXL)
constexpr int MAPS = 8;                   // streamed weights (tensor maps)
constexpr int MAXKT = 40;                 // panel chunks (K up to 2560)
// the barriers: the ring's full and empty, each panel chunk's, `freed`
constexpr int BARRIERS = 2 * STAGES + MAXKT + 1;
constexpr int OPTIN = 232448;             // sm_90's shared memory a block

// one GEMM step: out[:, :N] = unary(H[:, :K] . W OP d) (fwd), or
// H[:, :K] . W^T with W (N x K) read in place (!fwd)
struct Step {
  const void* d;    // the binary operand along the columns, or null
  int K, N, fwd, w, slot, binary, unary;
  int d_dtype;      // d's type: f32, bf16 or f16 (epilogue.cuh)
};

struct Params {
  CUtensorMap maps[MAPS];   // streamed: weight w as a 2D map, box 64 x 64
  Step steps[MAXS];         // one period; step g runs steps[g % period]
  const void* w[MAXS];      // the weights' base pointers
  const void* x;            // [groups][K0 / xkb][mb][xkb]: flat when xkb = K0
  void* out;                // [groups][N / onb][mb][onb]
  int period, total;        // steps of a period, steps of the run
  int groups, mb;           // row groups (B20's Mb) and their rows
  int xkb, onb;             // x's and out's block widths
  int wkb, wnb, wv;         // packed weights [N/wnb][K/wkb][wkb/wv][wnb][wv]
                            // (wkb 0: flat K x N row-major)
  int x_dtype, w_dtype, out_dtype, round_out;
  int C, resident;
  int stage_off, stage_len, w_off, bar_off;
};

// the wrapper's plan (xsmm/reference.py WarmPlan)
struct Plan {
  int rows, cluster, resident, smem;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the 64-column output tiles the block of rank `rank` owns at a step of N
// columns: rank, rank + C, ...
__device__ __forceinline__ int owned(int N, int rank, int C) {
  const int nt = cdiv(N, TILE);
  return rank < nt ? cdiv(nt - rank, C) : 0;
}

// element i of an f32 or E (the products' type: bf16, or f16) operand
template <class E>
__device__ __forceinline__ float ld(const void* p, size_t i, int dtype) {
  return dtype == dtype_code<E>() ? to_f32(static_cast<const E*>(p)[i])
                                  : static_cast<const float*>(p)[i];
}

// eight consecutive f32 or E elements at element i of base (16-byte
// aligned), widened to f32
template <class E>
__device__ __forceinline__ void ld8(const void* base, size_t i, int dtype,
                                    float (&v)[8]) {
  if (dtype == dtype_code<E>()) {
    const uint4 u =
        *reinterpret_cast<const uint4*>(static_cast<const E*>(base) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = pair_f32<E>(w[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
    const float4* f =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    const float4 a = f[0], b = f[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// eight values in the product type E (bf16 or f16) into one 16-byte unit
// of shared memory
template <class E>
__device__ __forceinline__ void store8(unsigned char* dst,
                                       const float (&v)[8]) {
  uint4 u;
  u.x = hw::pack16<E>(v[0], v[1]);
  u.y = hw::pack16<E>(v[2], v[3]);
  u.z = hw::pack16<E>(v[4], v[5]);
  u.w = hw::pack16<E>(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// element (k, n) of a K x N weight: flat row-major, or packed blocks
// [N/nb][K/kb][kb/V][nb][V] (VNNI when V is 2, read in place)
__device__ __forceinline__ size_t w_index(const Params& p, int k, int n,
                                          int Kw, int Nw) {
  if (p.wkb == 0) return (size_t)k * Nw + n;
  const int kb = p.wkb, nb = p.wnb, V = p.wv, kk = k % kb, nn = n % nb;
  return ((size_t)(n / nb) * (Kw / kb) + k / kb) * kb * nb +
         (size_t)(kk - kk % V) * nb + (size_t)nn * V + kk % V;
}

template <int P, int TRANS_A, class E>
__device__ __forceinline__ void mma(float (&d)[P / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (P == 16)
    hw::wgmma_m64n16k16_ss<0, TRANS_A, E>(d, da, db, 1);
  else if constexpr (P == 24)
    hw::wgmma_m64n24k16_ss<0, TRANS_A, E>(d, da, db, 1);
  else if constexpr (P == 32)
    hw::wgmma_m64n32k16_ss<0, TRANS_A, E>(d, da, db, 1);
  else if constexpr (P == 40)
    hw::wgmma_m64n40k16_ss<0, TRANS_A, E>(d, da, db, 1);
  else
    hw::wgmma_m64n64k16_ss<0, TRANS_A, E>(d, da, db, 1);
}

// the four k16 products of one 64-deep slice, each into its own chain
template <int P, int FWD, class E>
__device__ __forceinline__ void slice_products(float (&ch)[4][P / 2],
                                               const unsigned char* a,
                                               const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint64_t da =
        FWD ? hw::make_desc<128>(a + kk * 16 * 128, SLICE, 1024)
            : hw::make_desc<128>(a + kk * 32, 16, 1024);
    mma<P, FWD, E>(ch[kk], da, hw::make_desc<128>(b + kk * 32, 16, 1024));
  }
}

template <int P>
__device__ __forceinline__ void fence_chains(float (&ch)[4][P / 2]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) hw::fence_regs(ch[k]);
}

// acc = one output tile's products over KT slices: A the slices (resident
// at `res`, or the ring's next ones, each stage given back on `empty` once
// its products are done), B the panel's chunks (each waited on `landed`
// with its parity bit in `ph`, unless `landed` is null: the first step's
// panel is the block's own). FWD 1: an MN-major A (a (k, n) slice of W,
// trans-a); 0: K-major (W's rows). An m64nPk16 product is a few cycles of
// tensor work behind a long latency, so no product waits on the one before
// it: the k16 steps go to independent accumulator chains (8: four a slice,
// even and odd slices apart; 4 above P = 32, for registers), summed in a
// fixed order at the end. `c` counts the ring's slices.
template <int P, int FWD, class E>
__device__ __forceinline__ void tile_products(
    float (&acc)[P / 2], const unsigned char* panel, const unsigned char* res,
    unsigned char* ring, uint64_t* full, uint64_t* empty, uint64_t* landed,
    uint64_t ph, int KT, int& c) {
  constexpr int CHUNK = P * 128, SETS = P > 32 ? 1 : 2;
  float ch[SETS][4][P / 2];
#pragma unroll
  for (int q = 0; q < SETS; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < P / 2; ++r) ch[q][k][r] = 0.f;
  const int c0 = c;
  for (int kt = 0; kt < KT; kt += SETS) {
#pragma unroll
    for (int q = 0; q < SETS; ++q) {
      if (kt + q >= KT) break;
      const unsigned char* a;
      if (res) {
        a = res + (size_t)(kt + q) * SLICE;
      } else {
        hw::mbar_wait(&full[c % STAGES], (c / STAGES) & 1);
        a = ring + (c % STAGES) * SLICE;
      }
      if (landed) hw::mbar_wait(&landed[kt + q], (ph >> (kt + q)) & 1);
#pragma unroll
      for (int u = 0; u < SETS; ++u) fence_chains<P>(ch[u]);
      hw::wgmma_fence();
      slice_products<P, FWD, E>(ch[q], a, panel + (kt + q) * CHUNK);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();
#pragma unroll
      for (int u = 0; u < SETS; ++u) fence_chains<P>(ch[u]);
      // the previous slice's products are done: its stage goes back
      if (!res && c > c0) hw::mbar_arrive(&empty[(c - 1) % STAGES]);
      ++c;
    }
  }
  hw::wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < SETS; ++u) fence_chains<P>(ch[u]);
  if (!res && c > c0) hw::mbar_arrive(&empty[(c - 1) % STAGES]);
#pragma unroll
  for (int r = 0; r < P / 2; ++r) {
    float v = ch[0][0][r];
#pragma unroll
    for (int q = 0; q < SETS; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (q + k > 0) v += ch[q][k][r];
    acc[r] = v;
  }
}

// one tile's epilogue from registers, the unary U and an add (or no) D a
// compile-time choice (one straight copy each, not switches inlined P/2
// times; U < 0 and ADD false: both at run time, for other binaries): OP D
// (dv, this thread's two columns of it) along the columns, U, then to the
// output (the last step, in its own type: rounded to E first where
// round_out says the reference casts a state held in E, B4/B5/B20) or,
// rounded to E, into the staging tile. Accumulator (4 j + 2 h + e) is
// column t*64 + 16 warp + lane/4 + 8 h (wgmma's M), panel row
// 8 j + 2 (lane % 4) + e (its N).
template <int P, int U, bool ADD, class E>
__device__ __forceinline__ void tile_epilogue(const Params& p, const Step& s,
                                              const float (&acc)[P / 2],
                                              const float (&dv)[2], int t,
                                              int grp, int r0, bool last,
                                              unsigned char* staging) {
  const int lane = threadIdx.x % 32;
  const int cb = t * TILE + 16 * (threadIdx.x / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cb + 8 * h, row = 8 * j + 2 * (lane % 4) + e;
        float v = acc[4 * j + 2 * h + e];
        if (ADD)
          v += dv[h];
        else
          v = apply_binary(s.binary, v, dv[h]);
        v = col < s.N ? apply_unary(U < 0 ? s.unary : U, v) : 0.f;
        if (last) {
          const int gm = r0 + row;
          if (col < s.N && gm < p.mb) {
            if (p.round_out) v = to_f32(from_f32<E>(v));
            store_any(p.out,
                      (((size_t)grp * (s.N / p.onb) + col / p.onb) * p.mb +
                       gm) * p.onb + col % p.onb,
                      p.out_dtype, v);
          }
        } else {
          *reinterpret_cast<E*>(
              staging + hw::swizzle<128>(row * 128 + (col % TILE) * 2)) =
              from_f32<E>(v);
        }
      }
}

// one tile's epilogue, U and D's add chosen outside the tile's loops
template <int P, class E>
__device__ __forceinline__ void epilogue(const Params& p, const Step& s,
                                         const float (&acc)[P / 2],
                                         const float (&dv)[2], int t,
                                         int grp, int r0, bool last,
                                         unsigned char* st) {
  if (s.binary != kBinNone && s.binary != kAdd) {
    tile_epilogue<P, -1, false, E>(p, s, acc, dv, t, grp, r0, last, st);
    return;
  }
  switch (s.unary) {
#define TPP_WARM_EPILOGUE(U)                                        \
  case U:                                                           \
    tile_epilogue<P, U, true, E>(p, s, acc, dv, t, grp, r0, last, st); \
    break;
    TPP_WARM_EPILOGUE(kRelu)
    TPP_WARM_EPILOGUE(kExp)
    TPP_WARM_EPILOGUE(kSquare)
    TPP_WARM_EPILOGUE(kSqrt)
    TPP_WARM_EPILOGUE(kRsqrt)
    TPP_WARM_EPILOGUE(kTanh)
    TPP_WARM_EPILOGUE(kGelu)
    TPP_WARM_EPILOGUE(kGeluTanh)
    TPP_WARM_EPILOGUE(kNegate)
    TPP_WARM_EPILOGUE(kZero)
#undef TPP_WARM_EPILOGUE
    default:
      tile_epilogue<P, kIdentity, true, E>(p, s, acc, dv, t, grp, r0, last,
                                           st);
  }
}

// Warps 0-3 compute (the consumer warpgroup); warp 4 feeds the streamed
// weights through the ring; warp 5 sends each step's output tiles to the
// cluster. A step: the consumers run the products (waiting on each panel
// chunk as it lands), tell every block of the cluster they are done with
// their panel (a remote arrival on its `freed` barrier), write the
// epilogue into the staging and hand it to the sender (named barrier 2);
// the sender waits until every block of the cluster has freed its panel,
// arms its own chunks' barriers with the bytes of the next panel, and
// copies each tile to every block by the bulk-copy engine. The consumers
// signal by predicate, not by branch, between their products. E is the
// products' type: bf16, or f16 for an f16 key.
template <int P, class E>
__global__ void __launch_bounds__(THREADS, 1)
warm_panel_kernel(const __grid_constant__ Params p) {
  constexpr int CHUNK = P * 128;   // a 64-column chunk of the panel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  unsigned char* panel = smem;
  unsigned char* stage = smem + p.stage_off;
  unsigned char* wsm = smem + p.w_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);  // ring
  uint64_t* empty = full + STAGES;
  uint64_t* landed = empty + STAGES;   // each chunk of the panel
  uint64_t* freed = landed + MAXKT;    // every block has read its panel
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = p.C, rank = static_cast<int>(hw::cluster_rank());
  const int ppg = cdiv(p.mb, P), q = blockIdx.x / C;
  const int grp = q / ppg, r0 = (q % ppg) * P;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hw::mbar_init(&full[i], 1);
      hw::mbar_init(&empty[i], WG);
    }
    for (int i = 0; i < MAXKT; ++i) hw::mbar_init(&landed[i], 1);
    hw::mbar_init(freed, C);
    hw::mbar_fence_init();
  }
  // Loads of the prologue go four 16-byte units a thread at a time, all
  // issued before their stores (which the compiler may not hoist them
  // over), as vectors where eight elements lie side by side.
  constexpr int BATCH = 4;
  if (p.resident) {
    // every slice this block owns, rounded to E, once: [step][tile][k];
    // a flat or packed (not VNNI) weight's unit is eight side by side
    const bool vec = (p.wkb == 0 || p.wv == 1) &&
                     reinterpret_cast<uintptr_t>(p.w[0]) % 16 == 0;
    for (int si = 0; si < p.period; ++si) {
      const Step& s = p.steps[si];
      const int KT = cdiv(s.K, TILE);
      const int Kw = s.fwd ? s.K : s.N, Nw = s.fwd ? s.N : s.K;
      const int n = owned(s.N, rank, C) * KT * (TILE * 8);
      for (int u0 = tid; u0 < n; u0 += BATCH * THREADS) {
        float v[BATCH][8];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int u = u0 + b * THREADS, sl = u / (TILE * 8);
          const int t = rank + (sl / KT) * C, kt = sl % KT;
          const int row = (s.fwd ? kt : t) * TILE + (u / 8) % TILE;
          const int cb = (s.fwd ? t : kt) * TILE + (u % 8) * 8;
          if (u < n && row < Kw && cb < Nw && vec) {
            ld8<E>(p.w[s.w], w_index(p, row, cb, Kw, Nw), p.w_dtype, v[b]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[b][e] = u < n && row < Kw && cb + e < Nw
                            ? ld<E>(p.w[s.w],
                                    w_index(p, row, cb + e, Kw, Nw),
                                    p.w_dtype)
                            : 0.f;
          }
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int u = u0 + b * THREADS;
          if (u < n)
            store8<E>(wsm + (size_t)(s.slot + u / (TILE * 8)) * SLICE +
                       hw::swizzle<128>(((u / 8) % TILE) * 128 + (u % 8) * 16),
                   v[b]);
        }
      }
    }
  }

  // the panel: rows r0.. of group grp, every column of x, in E; rows
  // past mb and columns past K0 (to the chunk's end) zero
  {
    const int K0 = p.steps[0].K, KT0 = cdiv(K0, TILE), xkb = p.xkb;
    const int n = P * KT0 * 8;
    const bool vec =
        xkb % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
    for (int u0 = tid; u0 < n; u0 += BATCH * THREADS) {
      float v[BATCH][8];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int u = u0 + b * THREADS, k0 = (u % (KT0 * 8)) * 8;
        const int gm = r0 + u / (KT0 * 8);
        const size_t i0 =
            (((size_t)grp * (K0 / xkb) + k0 / xkb) * p.mb + gm) * xkb +
            k0 % xkb;
        if (u < n && gm < p.mb && k0 < K0 && vec) {
          ld8<E>(p.x, i0, p.x_dtype, v[b]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int k = k0 + e;
            v[b][e] = u < n && gm < p.mb && k < K0
                          ? ld<E>(p.x,
                               (((size_t)grp * (K0 / xkb) + k / xkb) * p.mb +
                                gm) * xkb + k % xkb,
                               p.x_dtype)
                          : 0.f;
          }
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int u = u0 + b * THREADS, k0 = (u % (KT0 * 8)) * 8;
        if (u < n)
          store8<E>(panel + (k0 / TILE) * CHUNK +
                     hw::swizzle<128>((u / (KT0 * 8)) * 128 + (k0 % TILE) * 2),
                 v[b]);
      }
    }
  }
  hw::fence_proxy_async();
  __syncthreads();
  // every block's barriers exist before a peer signals them
  hw::cluster_arrive();
  hw::cluster_wait();

  if (warp == WG / 32) {
    // the feeder: every streamed slice in the products' order, STAGES
    // ahead, each stage taken back once its products are done
    if (!p.resident && lane == 0) {
      int j = 0;
      for (int g = 0; g < p.total; ++g) {
        const Step& s = p.steps[g % p.period];
        const int nt = owned(s.N, rank, C), KT = cdiv(s.K, TILE);
        for (int i = 0; i < nt; ++i)
          for (int kt = 0; kt < KT; ++kt, ++j) {
            const int slot = j % STAGES, t = rank + i * C;
            if (j >= STAGES)
              hw::mbar_wait(&empty[slot], ((j / STAGES) - 1) & 1);
            hw::mbar_arrive_tx(&full[slot], SLICE);
            hw::tma_load_2d(wsm + slot * SLICE, &p.maps[s.w], &full[slot],
                            (s.fwd ? t : kt) * TILE, (s.fwd ? kt : t) * TILE);
          }
      }
    }
    __syncwarp();
  } else if (warp == WG / 32 + 1) {
    // the sender: the whole warp keeps step (named barrier 2), lane 0
    // signals and copies
    for (int g = 0; g + 1 < p.total; ++g) {
      const Step& s = p.steps[g % p.period];
      const int nt = owned(s.N, rank, C);
      unsigned char* staging = stage + (g & 1) * p.stage_len;
      hw::bar_sync(2, WG + 32);        // the staging is written
      hw::mbar_wait(freed, g & 1);     // every block has read its panel
      for (int kt = 0; kt < cdiv(s.N, TILE); ++kt)
        hw::mbar_arrive_tx_if(&landed[kt], CHUNK, lane == 0);
      // each tile to every block of the cluster, this block's own
      // included, the peers in turn from the next rank on
      for (int k = 0; k < C; ++k)
        for (int i = 0; i < nt; ++i)
          hw::bulk_to_peer(panel + (rank + i * C) * CHUNK,
                           staging + i * CHUNK, CHUNK, &landed[rank + i * C],
                           (rank + k) % C, lane == 0);
      hw::bulk_commit();
      // the copies have read the staging before the consumers next write
      // it (two steps on, past the next named barrier)
      hw::bulk_wait_read<0>();
    }
    hw::bulk_wait<0>();
    __syncwarp();
  } else {
    uint64_t ph = 0;   // each panel chunk's barrier parity
    int c = 0;         // streamed slices consumed
    for (int g = 0; g < p.total; ++g) {
      const Step& s = p.steps[g % p.period];
      const int nt = owned(s.N, rank, C), KT = cdiv(s.K, TILE);
      const bool last = g == p.total - 1;
      unsigned char* staging = stage + (g & 1) * p.stage_len;
      for (int i = 0; i < nt; ++i) {
        const int t = rank + i * C;
        const unsigned char* res =
            p.resident ? wsm + (size_t)(s.slot + i * KT) * SLICE : nullptr;
        // the epilogue's D, loaded before the products hide its latency
        const int cb = t * TILE + 16 * warp + lane / 4;
        float dv[2] = {0.f, 0.f};
        if (s.binary != kBinNone)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (cb + 8 * h < s.N)
              dv[h] = load_any(s.d, cb + 8 * h, s.d_dtype);
        float acc[P / 2];
        uint64_t* lw = g > 0 ? landed : nullptr;
        if (s.fwd)
          tile_products<P, 1, E>(acc, panel, res, wsm, full, empty, lw, ph,
                                 KT, c);
        else
          tile_products<P, 0, E>(acc, panel, res, wsm, full, empty, lw, ph,
                                 KT, c);
        __syncwarp();
        // the block's last products are done: its panel is free, in every
        // block's count, once this arrives there (thread k arrives at
        // block k's barrier: the C arrivals go out at once)
        if (i + 1 == nt && !last)
          hw::mbar_arrive_peer_if(freed, tid % C, tid < C);
        epilogue<P, E>(p, s, acc, dv, t, grp, r0, last, staging + i * CHUNK);
      }
      if (nt == 0 && !last) {
        // no tile here: the panel's chunks land all the same, before the
        // sender arms their next phase
        if (g > 0)
          for (int kt = 0; kt < KT; ++kt)
            hw::mbar_wait(&landed[kt], (ph >> kt) & 1);
        hw::mbar_arrive_peer_if(freed, tid % C, tid < C);
      }
      if (g > 0) ph ^= (2ull << (KT - 1)) - 1;   // the chunks it waited on
      if (last) break;
      hw::fence_proxy_async();   // the staging, before the copies read it
      hw::bar_sync(2, WG + 32);
    }
  }
  // no block leaves while a peer may still reach its shared memory
  hw::cluster_arrive();
  hw::cluster_wait();
}

// the shared-memory layout of a plan: the panel (the widest K's chunks),
// two staging buffers (the most tiles a block owns at a step), the weights
// (every owned slice resident, or the ring), the ring's and the panel's
// barriers; fills each
// step's resident slot. Returns the dynamic shared memory to ask for,
// 1024 bytes of alignment included; xsmm/reference.py warm_smem_bytes
// mirrors it.
inline int layout(Params& p, int rows, int resident) {
  int kt_max = 0, t_max = 0, slices = 0;
  for (int s = 0; s < p.period; ++s) {
    Step& st = p.steps[s];
    const int KT = cdiv(st.K, TILE), T = cdiv(cdiv(st.N, TILE), p.C);
    kt_max = std::max(kt_max, KT);
    t_max = std::max(t_max, T);
    st.slot = slices;
    slices += T * KT;
  }
  p.stage_off = kt_max * rows * 128;
  p.stage_len = t_max * rows * 128;
  p.w_off = p.stage_off + 2 * p.stage_len;
  p.bar_off = p.w_off + (resident ? slices : STAGES) * SLICE;
  return p.bar_off + BARRIERS * 8 + 1024;
}

template <int P, class E>
cudaError_t set_attributes() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        warm_panel_kernel<P, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        OPTIN);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(warm_panel_kernel<P, E>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    return e;
  }();
  return err;
}

template <int P, class E>
int launch_rows(const Params& p, int clusters, int smem, cudaStream_t st) {
  cudaError_t err = set_attributes<P, E>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * p.C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, warm_panel_kernel<P, E>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launches a filled Params (steps, pointers, geometry, dtypes) on `plan`,
// the products in E (bf16, or f16: run_f16). Returns a cudaError_t:
// cudaErrorInvalidValue for a plan the engine does not take (rows not
// 16/24/32/40/64, cluster not 1..16, bytes that disagree with layout(),
// streamed weights that are not flat in E or more than MAPS, a width past
// MAXKT chunks).
template <class E = __nv_bfloat16>
int run(Params& p, const Plan& plan, cudaStream_t st) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((plan.rows != 16 && plan.rows != 24 && plan.rows != 32 &&
       plan.rows != 40 && plan.rows != 64) ||
      plan.cluster < 1 || plan.cluster > 16 || p.period < 1 ||
      p.period > MAXS || p.total < 1)
    return bad;
  p.C = plan.cluster;
  p.resident = plan.resident;
  for (int i = 0; i < p.period; ++i)
    if (cdiv(p.steps[i].K, TILE) > MAXKT || cdiv(p.steps[i].N, TILE) > MAXKT)
      return bad;
  const int smem = layout(p, plan.rows, plan.resident);
  if (smem != plan.smem || smem > OPTIN) return bad;
  if (!plan.resident) {
    if (p.w_dtype != dtype_code<E>() || p.wkb != 0) return bad;
    bool made[MAPS] = {};
    for (int s = 0; s < p.period; ++s) {
      const Step& sp = p.steps[s];
      if (sp.w >= MAPS) return bad;
      if (made[sp.w]) continue;
      const uint64_t Kw = sp.fwd ? sp.K : sp.N, Nw = sp.fwd ? sp.N : sp.K;
      const uint64_t dims[2] = {Nw, Kw}, strides[1] = {Nw * 2};
      const uint32_t box[2] = {TILE, TILE};
      const int rc = hw::make_map<E>(&p.maps[sp.w], p.w[sp.w], 2, dims,
                                     strides, box, 128);
      if (rc) return rc;
      made[sp.w] = true;
    }
  }
  const int clusters = p.groups * cdiv(p.mb, plan.rows);
  switch (plan.rows) {
    case 16: return launch_rows<16, E>(p, clusters, smem, st);
    case 24: return launch_rows<24, E>(p, clusters, smem, st);
    case 32: return launch_rows<32, E>(p, clusters, smem, st);
    case 40: return launch_rows<40, E>(p, clusters, smem, st);
    default: return launch_rows<64, E>(p, clusters, smem, st);
  }
}

// run() with f16 products (ROADMAP A14): its five kernels live in
// csrc/warm_panel_f16.cu, a translation unit of their own that nvcc builds
// beside chain.cu and blocked_matmul.cu
int run_f16(Params& p, const Plan& plan, cudaStream_t st);

// cudaOccupancyMaxActiveClusters for the engine at (rows, cluster, smem):
// how many clusters of `cluster` blocks the card holds at once (the bf16
// kernel's; the f16 one asks for the same threads, one block an SM, and
// the same shared memory)
template <int P>
int max_clusters_rows(int cluster, int smem, int* n) {
  cudaError_t err = set_attributes<P, __nv_bfloat16>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(n, warm_panel_kernel<P, __nv_bfloat16>,
                                     &cfg));
}

inline int max_clusters(int rows, int cluster, int smem, int* n) {
  switch (rows) {
    case 16: return max_clusters_rows<16>(cluster, smem, n);
    case 24: return max_clusters_rows<24>(cluster, smem, n);
    case 32: return max_clusters_rows<32>(cluster, smem, n);
    case 40: return max_clusters_rows<40>(cluster, smem, n);
    case 64: return max_clusters_rows<64>(cluster, smem, n);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace warm
}  // namespace tpp
