// int8 compute GEMM for Hopper (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:1365 _build_int8_gemm (B15):
//   out = unary((Xq @ Wq) * xscale[row] * wscale[col] [+ bias[col]])
// Xq (m, k) and Wq (k, n) are row-major int8, the scales f32 and the bias
// f32 or bf16. The products accumulate exactly in s32 (k * 127^2 stays far
// below 2^31 at every width the engine uses), and the epilogue follows the
// TPU kernel's order: the s32 sum rounded to f32, times the row scale,
// times the column scale, plus the bias (multiplies and add pinned with
// __fmul_rn / __fadd_rn: no FMA contraction), then the unary (epilogue.cuh,
// so gelu is the same exp2-domain gelu_exp2), one rounding to the output
// dtype: f32, bf16 or f16 (ROADMAP A14: the s8 products are unchanged,
// only the stores know a third type). Both bodies below give the same
// bits.
//
// What bounds it on the H100: 1,979 int8 TOP/s against one byte an operand
// element, so at the serving prefill's shapes (m 4096, k 768 or 3072) the
// f32 output is the byte bound (the LM head writes 824 MB) but for fc2, and
// the operands' L2 -> SM traffic is what a tile pays.
//
// Route "wgmma" (int8_gemm_route: every key; the plan is
// reference.int8_gemm_plan, recomputed here and refused if it differs):
//   - the weight K-major, as wgmma takes 8-bit operands: the wrapper passes
//     Wt (n, k), the engine's copy made once when it places int8-compute
//     weights (QTensor.qt), so the mainloop runs on TMA alone and nothing
//     transposes per call;
//   - a persistent grid of min(tiles, 132) blocks walking BM x BN output
//     tiles (128 x 192: 4096 x 768 is 128 tiles, one wave; the LM head
//     8,384), m fastest so the blocks in flight share each weight tile in
//     L2; one producer warp keeps a ring of (X, Wt) stages full by TMA with
//     128-byte swizzle (a 128-byte row is 128 k values: four k32
//     products), the out-of-bounds fill masking a ragged m, n or k, and
//     walks on to the next tile's stages while the consumers finish this
//     one's epilogue;
//   - one or two consumer warpgroups of 64 rows running wgmma
//     m64nBNk32.s32.s8.s8 with s32 accumulators in registers
//     (gemm_sm90.cuh's consumer loop, the one B1/B2/B19 run), which hand
//     each tile's sums over through an s32 staging buffer of its own and
//     go on to the next tile's mainloop;
//   - an epilogue warpgroup that stores the handed-over tile while that
//     mainloop runs: each thread keeps one 4-column run's column scales
//     and bias (read in their stored dtype and widened) in registers,
//     loaded while it waits for the sums, walks that run down the rows and
//     stores 16-byte (f32) or 8-byte (bf16 or f16) runs, coalesced along
//     the rows; a ragged n stores element by element. (Done by the consumers
//     between two mainloops, the rows took twice a k-768 mainloop's time:
//     scripts/exp_int8_epilogue.py);
//   - under half a wave of tiles, k is split: each split stores its s32
//     partial and a second pass sums them (exact in any order) and runs
//     the epilogue once.
// Route "wmma" (the first design, forced only): one 128 x 128 output tile
// per block of 8 warps, each warp 32 x 64 of it as 2 x 4 WMMA s8 16x16x16
// fragments with s32 accumulators; k steps of 64 staged through shared
// memory without pipelining, W transposed byte by byte on the way in.
// Both need k a multiple of 16 (TMA's row stride, WMMA's fragment).
#include <mma.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 64, KC = BK / 16;
constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int WM = 32, WN = 64;  // one warp's part of the tile (4 x 2 warps)

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  const float* bias;
  void* out;
  int m, n, k, unary, out_dtype;
};

__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(Args a) {
  __shared__ __align__(128) int8_t As[KC][BM][16];
  __shared__ __align__(128) int8_t Bs[KC][BN][16];
  __shared__ __align__(128) int Cs[WARPS][16 * 16];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp % 4) * WM, wn = (warp / 4) * WN;
  const bool n_vec = a.n % 16 == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < a.k; k0 += BK) {
    // X tile: BM rows x BK bytes, one 16-byte chunk per (row, slab)
    for (int i = tid; i < BM * KC; i += THREADS) {
      const int r = i / KC, kc = i % KC, row = m0 + r, col = k0 + kc * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < a.m && col < a.k)
        v = *reinterpret_cast<const uint4*>(a.x + (size_t)row * a.k + col);
      *reinterpret_cast<uint4*>(&As[kc][r][0]) = v;
    }
    // W tile: BK rows x BN bytes, stored transposed per 16-row slab
    for (int i = tid; i < BK * (BN / 16); i += THREADS) {
      const int kr = i / (BN / 16), nc = i % (BN / 16);
      const int row = k0 + kr, col = n0 + nc * 16;
      alignas(16) int8_t v[16];
      if (row < a.k && n_vec && col + 16 <= a.n) {
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(a.w + (size_t)row * a.n + col);
      } else {
#pragma unroll
        for (int t = 0; t < 16; ++t)
          v[t] = row < a.k && col + t < a.n ? a.w[(size_t)row * a.n + col + t]
                                             : int8_t(0);
      }
#pragma unroll
      for (int t = 0; t < 16; ++t) Bs[kr / 16][nc * 16 + t][kr % 16] = v[t];
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const signed char*>(&As[kc][wm + i * 16][0]),
            16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const signed char*>(&Bs[kc][wn + j * 16][0]),
            16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j],
                                                   acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, one 16 x 16 fragment at a time through the warp's scratch
  int* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane * 8 + t, r = e / 16, c = e % 16;
        const int row = m0 + wm + i * 16 + r, col = n0 + wn + j * 16 + c;
        if (row >= a.m || col >= a.n) continue;
        // the TPU kernel's order with no contraction, as the wgmma body
        // (an FMA here would leave the two designs apart by an ulp)
        float y = __fmul_rn(__fmul_rn(static_cast<float>(cs[e]), a.xs[row]),
                            a.ws[col]);
        if (a.bias != nullptr) y = __fadd_rn(y, a.bias[col]);
        tpp::store_any(a.out, (size_t)row * a.n + col, a.out_dtype,
                  tpp::apply_unary(a.unary, y));
      }
      __syncwarp();
    }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x (m, k) and w
// (k, n) int8, row-major, k a multiple of 16 and x 16-byte aligned; xs (m,),
// ws (n,) and bias (n,) f32, bias null without one; out (m, n) in out_dtype
// (f32, bf16 or f16).
extern "C" int tpp_int8_gemm(const void* x, const void* w, const void* xs,
                             const void* ws, const void* bias, void* out,
                             int m, int n, int k, int unary, int out_dtype,
                             void* stream) {
  if (k % 16 || out_dtype < tpp::kF32 || out_dtype > tpp::kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(xs), static_cast<const float*>(ws),
               static_cast<const float*>(bias), out, m, n, k, unary,
               out_dtype};
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// ---- route "wgmma" ------------------------------------------------------

namespace {

namespace hw = tpp::hopper;
namespace sm = tpp::sm90;

constexpr int I8_SMS = 132;     // the plan is pinned to the H100's SMs
constexpr int I8_BK = 128;      // k a stage: one 128-byte swizzled row

struct I8Gemm {
  const void* xs;
  const void* ws;
  const void* bias;
  void* out;
  int32_t* work;          // split > 1: [split][m][n] s32 partials
  int m, n, k, unary, out_dtype, xs_dtype, ws_dtype, bias_dtype, has_bias;
  int split, tiles_m, tiles;   // tiles: tiles_m * tiles_n * split
  int vec;                // 4-column runs are whole vectors (n % 4 == 0)
};

template <int NCW, int BN>
struct I8Tile {
  static constexpr int BM = 64 * NCW;
  static constexpr int STAGES = (NCW == 2 && BN == 192) ? 3 : 4;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = A_BYTES + BN * 128;
  static constexpr int LD = BN + 4;    // s32 words a staged row
  static constexpr int tile_off = STAGES * STAGE;
  // the row scales of a tile's BM rows, widened to f32, for the epilogue
  static constexpr int xs_off = tile_off + BM * LD * 4;
  static constexpr int bar_off = xs_off + BM * 4;
  static constexpr int bytes = bar_off + 2 * STAGES * 8;
  // threads: NCW consumer warpgroups, the epilogue warpgroup, the producer
  // warp; named barriers: the staging tile full (consumers arrive, the
  // epilogue waits), empty (the reverse), and the epilogue's own
  static constexpr int THREADS = (NCW + 1) * 128 + 32;
  static constexpr int HANDOFF = (NCW + 1) * 128;
  static constexpr int BAR_FULL = 1, BAR_EMPTY = 2, BAR_EPI = 3;
};

// the plan (reference.int8_gemm_plan): tile rows and columns, k split,
// tiles, grid, dynamic shared memory (with 1024 bytes of alignment)
struct I8Plan {
  int bm, bn, split, tiles, grid, smem;
};

template <int NCW, int BN>
constexpr int i8_smem() {
  return I8Tile<NCW, BN>::bytes + 1024;
}

inline I8Plan i8_plan(int m, int n, int k) {
  const int bm = m > 64 ? 128 : 64, bn = n > 128 ? 192 : 128;
  const int smem = bm == 128 ? (bn == 192 ? i8_smem<2, 192>()
                                          : i8_smem<2, 128>())
                             : (bn == 192 ? i8_smem<1, 192>()
                                          : i8_smem<1, 128>());
  const long long mn = (long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn);
  const int kt = (k + I8_BK - 1) / I8_BK;
  long long split = 1;
  if (2 * mn <= I8_SMS)
    split = std::max<long long>(1, std::min<long long>(I8_SMS / mn, kt / 4));
  const long long tiles = mn * split;
  return {bm, bn, static_cast<int>(split), static_cast<int>(tiles),
          static_cast<int>(std::min<long long>(tiles, I8_SMS)), smem};
}

// tile t: split slice fastest, then m tiles, then n tiles
__device__ __forceinline__ void i8_tile(const I8Gemm& g, int t, int& mt,
                                        int& nt, int& ks) {
  ks = t % g.split;
  const int r = t / g.split;
  mt = r % g.tiles_m;
  nt = r / g.tiles_m;
}

// the 4-column output run at row p, columns t.. (n of them valid): out =
// unary(acc * xs * ws + bias), or with a split the raw s32 partial to
// slice ks of the workspace
template <int U>
__device__ __forceinline__ void i8_store(const I8Gemm& g, const int4& a,
                                         float xs, const float (&ws)[4],
                                         const float (&b)[4], int p, int t,
                                         int n, int ks) {
  const size_t o = (size_t)p * g.n + t;
  const int raw[4] = {a.x, a.y, a.z, a.w};
  if (g.split > 1) {
    int32_t* w = g.work + (size_t)ks * g.m * g.n + o;
    if (g.vec) {
      *reinterpret_cast<int4*>(w) = a;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) w[e] = raw[e];
    }
    return;
  }
  // in the TPU kernel's order, with no contraction
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = __fmul_rn(__fmul_rn(static_cast<float>(raw[e]), xs), ws[e]);
    if (g.has_bias) v = __fadd_rn(v, b[e]);
    y[e] = tpp::apply_unary(U, v);
  }
  if (g.vec && g.out_dtype == tpp::kBF16) {
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(g.out) + o) =
        make_uint2(hw::pack_bf16(y[0], y[1]), hw::pack_bf16(y[2], y[3]));
  } else if (g.vec && g.out_dtype == tpp::kF16) {
    *reinterpret_cast<uint2*>(static_cast<__half*>(g.out) + o) =
        make_uint2(hw::pack_f16(y[0], y[1]), hw::pack_f16(y[2], y[3]));
  } else if (g.vec) {
    *reinterpret_cast<float4*>(static_cast<float*>(g.out) + o) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) tpp::store_any(g.out, o + e, g.out_dtype, y[e]);
  }
}

// The staged BM x BN tile (rows from p0, columns from t0) out, by the
// epilogue warpgroup: 128 / (BN / 4) rows a step (2 at BN 192), thread
// etid the 4-column run etid % (BN / 4) of every step's row etid / (BN / 4)
// (threads past the last whole row wait), so its column scales and bias
// (ws, b) are in registers for the whole tile; R rows' s32 sums and row
// scales are read from shared memory before any is stored, and the stores
// go out in 16-byte runs along the rows.
template <int BM, int BN, int LD, int U>
__device__ __forceinline__ void i8_rows(const I8Gemm& g, const int32_t* tile,
                                        const float* xs_s,
                                        const float (&ws)[4],
                                        const float (&b)[4], int p0, int t0,
                                        int ks, int etid) {
  constexpr int RUNS = BN / 4, STEP = sm::WG / RUNS, R = 8;
  static_assert(BM % (STEP * R) == 0, "whole rounds");
  const int run = etid % RUNS, t = t0 + run * 4;
  const int n = sm::clamp_run(g.n - t, 4);
  if (etid >= STEP * RUNS || n == 0) return;
#pragma unroll 1
  for (int r0 = etid / RUNS; r0 < BM; r0 += STEP * R) {
    int4 a[R];
    float xs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r0 + r * STEP;
      a[r] = *reinterpret_cast<const int4*>(tile + row * LD + run * 4);
      xs[r] = xs_s[row];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r0 + r * STEP;
      if (p < g.m) i8_store<U>(g, a[r], xs[r], ws, b, p, t, n, ks);
    }
  }
}

// Block roles: NCW consumer warpgroups (the mainloop, each 64 rows of the
// tile), the epilogue warpgroup, one producer warp. The consumers hand
// each tile's s32 sums over through the staging buffer and go on to the
// next tile's mainloop while the epilogue warpgroup stores the last one.
template <int NCW, int BN>
__global__ void __launch_bounds__(I8Tile<NCW, BN>::THREADS, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ I8Gemm g) {
  using T = I8Tile<NCW, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bar_off);
  uint64_t* empty = full + T::STAGES;
  int32_t* staged = reinterpret_cast<int32_t*>(smem + T::tile_off);
  const int tid = threadIdx.x, wg = tid / sm::WG;
  const int KT = (g.k + I8_BK - 1) / I8_BK;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], NCW * sm::WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NCW + 1) {  // ---- producer: one thread ----
    if (tid != (NCW + 1) * sm::WG) return;
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      int mt, nt, ks;
      i8_tile(g, t, mt, nt, ks);
      const int s_lo = ks * KT / g.split, s_hi = (ks + 1) * KT / g.split;
      for (int kt = s_lo; kt < s_hi; ++kt) {
        hw::mbar_wait(&empty[stage], phase ^ 1);
        hw::mbar_arrive_tx(&full[stage], T::STAGE);
        unsigned char* sa = smem + stage * T::STAGE;
        hw::tma_load_2d(sa, &xmap, &full[stage], kt * I8_BK, mt * T::BM);
        hw::tma_load_2d(sa + T::A_BYTES, &wmap, &full[stage], kt * I8_BK,
                        nt * BN);
        if (++stage == T::STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  if (wg == NCW) {  // ---- the epilogue warpgroup ----
    constexpr int RUNS = BN / 4;
    float* xs_s = reinterpret_cast<float*>(smem + T::xs_off);
    const int etid = tid - NCW * sm::WG;
    hw::bar_arrive(T::BAR_EMPTY, T::HANDOFF);   // the staging starts free
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      int mt, nt, ks;
      i8_tile(g, t, mt, nt, ks);
      const int p0 = mt * T::BM, t0 = nt * BN;
      // this thread's column scales and bias, and the tile's row scales,
      // loaded while the consumers finish the tile's sums
      float ws[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
      const int tc = t0 + (etid % RUNS) * 4, n = sm::clamp_run(g.n - tc, 4);
      if (g.split == 1 && n > 0) {
        sm::load4(ws, g.ws, tc, g.ws_dtype, g.vec, n);
        if (g.has_bias) sm::load4(b, g.bias, tc, g.bias_dtype, g.vec, n);
      }
      hw::bar_sync(T::BAR_EPI, sm::WG);   // the last tile's rows are out
      if (g.split == 1)
        for (int r = etid; r < T::BM; r += sm::WG)
          xs_s[r] = p0 + r < g.m ? sm::ld_f32(g.xs, p0 + r, g.xs_dtype)
                                 : 0.f;
      hw::bar_sync(T::BAR_FULL, T::HANDOFF);
      switch (g.split > 1 ? tpp::kIdentity : g.unary) {
#define TPP_I8_ROWS(U)                                                   \
  case U:                                                                \
    i8_rows<T::BM, BN, T::LD, U>(g, staged, xs_s, ws, b, p0, t0, ks,     \
                                 etid);                                  \
    break;
        TPP_I8_ROWS(tpp::kRelu)
        TPP_I8_ROWS(tpp::kExp)
        TPP_I8_ROWS(tpp::kSquare)
        TPP_I8_ROWS(tpp::kSqrt)
        TPP_I8_ROWS(tpp::kRsqrt)
        TPP_I8_ROWS(tpp::kTanh)
        TPP_I8_ROWS(tpp::kGelu)
        TPP_I8_ROWS(tpp::kGeluTanh)
        TPP_I8_ROWS(tpp::kNegate)
        TPP_I8_ROWS(tpp::kZero)
#undef TPP_I8_ROWS
        default:
          i8_rows<T::BM, BN, T::LD, tpp::kIdentity>(g, staged, xs_s, ws, b,
                                                    p0, t0, ks, etid);
      }
      if (t + (int)gridDim.x < g.tiles)
        hw::bar_arrive(T::BAR_EMPTY, T::HANDOFF);
    }
    return;
  }

  // ---- consumer warpgroup wg: rows 64 wg .. + 63 of each tile ----
  sm::RingPos pos;
  int32_t* tile = staged + wg * 64 * T::LD;
  const int ctid = tid % sm::WG, lane = tid % 32;
  const int row = (ctid / 32) * 16 + lane / 4;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    int mt, nt, ks;
    i8_tile(g, t, mt, nt, ks);
    const int s_lo = ks * KT / g.split, s_hi = (ks + 1) * KT / g.split;
    int acc[BN / 2];
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) acc[x] = 0;
    sm::consume_ring<0, 0, T::A_BYTES, BN, T::STAGES>(
        acc, smem, full, empty, s_hi - s_lo, wg, sm::NoPrep(), &pos);
    // the epilogue warpgroup is done with the last tile's sums
    hw::bar_sync(T::BAR_EMPTY, T::HANDOFF);
    // acc[4 jj + 2 h + e]: row 16 warp + lane / 4 + 8 h, column 8 jj +
    // 2 (lane % 4) + e of the warpgroup's 64 rows
#pragma unroll
    for (int x = 0; x < BN / 2; x += 2) {
      const int r = row + 8 * ((x / 2) & 1), c = 8 * (x / 4) + 2 * (lane % 4);
      *reinterpret_cast<int2*>(tile + r * T::LD + c) =
          make_int2(acc[x], acc[x + 1]);
    }
    hw::bar_arrive(T::BAR_FULL, T::HANDOFF);
  }
}

// the split partials summed (exact in any order), then the epilogue once
// an output element
__global__ void __launch_bounds__(256) int8_split_reduce(const I8Gemm g) {
  const size_t total = (size_t)g.m * g.n;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    int s = g.work[o];
    for (int k = 1; k < g.split; ++k) s += g.work[(size_t)k * total + o];
    const int p = static_cast<int>(o / g.n), t = static_cast<int>(o % g.n);
    float v = __fmul_rn(__fmul_rn(static_cast<float>(s),
                                  sm::ld_f32(g.xs, p, g.xs_dtype)),
                        sm::ld_f32(g.ws, t, g.ws_dtype));
    if (g.has_bias) v = __fadd_rn(v, sm::ld_f32(g.bias, t, g.bias_dtype));
    tpp::store_any(g.out, o, g.out_dtype, tpp::apply_unary(g.unary, v));
  }
}

template <int NCW, int BN>
int i8_launch(const I8Gemm& g, const void* x, const void* wt, int grid,
              cudaStream_t st) {
  using T = I8Tile<NCW, BN>;
  auto kernel = int8_wgmma_kernel<NCW, BN>;
  constexpr int smem = i8_smem<NCW, BN>();
  static unsigned long long opted = 0;   // devices the attribute is set on
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(opted >> (dev & 63) & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted |= 1ull << (dev & 63);
  }
  // X (m, k) and Wt (n, k) int8, K-major: (k, rows) maps in boxes of
  // (128 k, BM or BN rows), 128-byte swizzled; out of bounds reads zero
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)g.k, (uint64_t)g.m};
  const uint64_t wdims[2] = {(uint64_t)g.k, (uint64_t)g.n};
  const uint64_t strides[1] = {(uint64_t)g.k};
  const uint32_t xbox[2] = {I8_BK, static_cast<uint32_t>(T::BM)};
  const uint32_t wbox[2] = {I8_BK, static_cast<uint32_t>(BN)};
  int rc = hw::make_map_typed(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 2,
                              xdims, strides, xbox, 128);
  if (rc) return rc;
  rc = hw::make_map_typed(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wt, 2, wdims,
                          strides, wbox, 128);
  if (rc) return rc;
  kernel<<<grid, T::THREADS, smem, st>>>(xmap, wmap, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.split == 1) return static_cast<int>(err);
  const size_t total = (size_t)g.m * g.n;
  const int blocks = static_cast<int>(
      std::min<size_t>((total + 255) / 256, (size_t)I8_SMS * 8));
  int8_split_reduce<<<blocks, 256, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// the scales' and the bias's types: f32 or bf16 (sm::ld_f32 and load4 at
// their default E)
bool scale_dtype_ok(int dtype) {
  return dtype == tpp::kF32 || dtype == tpp::kBF16;
}

}  // namespace

// Route "wgmma". Returns the cudaError_t of the launch (0 on success). x
// (m, k) and wt (n, k) int8, k a multiple of 16, both 16-byte aligned; xs
// (m,), ws (n,) and bias (n,) in their dtypes (f32 or bf16; another code
// is refused), bias null without one; out (m, n) in out_dtype (f32, bf16 or
// f16); work the [split][m][n] s32
// partials where the plan splits k (else null). `plan` is the caller's
// reference.int8_gemm_plan (tile rows, tile columns, k split, tiles,
// grid, dynamic shared memory); a plan that differs from the launcher's
// own is refused (cudaErrorInvalidValue).
extern "C" int tpp_int8_gemm_wgmma(const void* x, const void* wt,
                                   const void* xs, const void* ws,
                                   const void* bias, void* out, void* work,
                                   int m, int n, int k, int unary,
                                   int out_dtype, int xs_dtype, int ws_dtype,
                                   int bias_dtype, const int* plan,
                                   void* stream) {
  if (k % 16 || m < 1 || n < 1 || out_dtype < tpp::kF32 ||
      out_dtype > tpp::kF16 ||
      !scale_dtype_ok(xs_dtype) || !scale_dtype_ok(ws_dtype) ||
      (bias != nullptr && !scale_dtype_ok(bias_dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  const I8Plan p = i8_plan(m, n, k);
  const int v[6] = {p.bm, p.bn, p.split, p.tiles, p.grid, p.smem};
  for (int i = 0; i < 6; ++i)
    if (plan[i] != v[i]) return static_cast<int>(cudaErrorInvalidValue);
  if (p.split > 1 && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_m = (m + p.bm - 1) / p.bm;
  const int vec = n % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(ws) % 16 == 0 &&
                  (bias == nullptr || reinterpret_cast<uintptr_t>(bias) % 16 == 0) &&
                  reinterpret_cast<uintptr_t>(work) % 16 == 0;
  const I8Gemm g{xs, ws, bias, out, static_cast<int32_t*>(work), m, n, k,
                 unary, out_dtype, xs_dtype, ws_dtype, bias_dtype,
                 bias != nullptr, p.split, tiles_m, p.tiles, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.bm == 128)
    return p.bn == 192 ? i8_launch<2, 192>(g, x, wt, p.grid, st)
                       : i8_launch<2, 128>(g, x, wt, p.grid, st);
  return p.bn == 192 ? i8_launch<1, 192>(g, x, wt, p.grid, st)
                     : i8_launch<1, 128>(g, x, wt, p.grid, st);
}
