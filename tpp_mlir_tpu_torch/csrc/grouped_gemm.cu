// Grouped (ragged-batch) GEMM and grouped weight gradient, for Hopper
// (sm_90a): the two GEMMs of the dropless grouped-expert MoE FFN.
//
// B16 replaces tpp_mlir_tpu/xsmm/kernels.py:1138 _build_grouped_gemm:
//   O[i*bm:(i+1)*bm] = unary(A[i*bm:(i+1)*bm] @ B[ge[i]])
// A (m, k) holds rows sorted by group and padded per group to a multiple of
// bm (padding rows are zero and come out zero: every unary here maps 0 to
// 0); B is (G, k, n), or (G, n, k) under transpose_b (the dgrad), or with
// `layers` the stacked (L, G, ., .) table, its layer read from a device
// int. ge (m / bm) int32 is read on the device, so one kernel serves every
// routing and the caller never copies the routing to the host.
//
// B17 replaces :1283 _build_grouped_wgrad:
//   dW[g] = sum_{i : ge[i] == g} A_i^T @ dY_i     (f32 (G, k, n))
// with A given as xt (k, m) through two strides, so the transpose of a
// contiguous (m, k) tensor is read in place. The TPU kernel walks the row
// blocks in order and writes a group's block on its last step; Hopper
// blocks run in no order, so here one block owns one (group, k tile,
// n tile): it finds its group's run of row blocks by a binary search of ge
// (non-decreasing: rows are sorted by group), loops over the run and
// writes its tile once. No atomics, so the result is bit-repeatable, and a
// group that owns no block writes zeros (the TPU kernel leaves it
// unwritten, kernels.py:1295-1297).
//
// What bounds them on the H100: at the MoE shapes (A_pad 9216 rows, E 768,
// F 3072) each product is 43.5 GFLOP, 0.044 ms at 989 TFLOP/s, against
// 0.030 ms for fc2's 101 MB of A, weights and output at 3.35 TB/s (B17:
// 0.041 ms, most of it the 75 MB of f32 dW): both are compute-bound by the
// card's measure, so the tensor cores must never wait on a copy.
//
// B16 takes one of two routes, which xsmm/reference.py grouped_gemm_route
// chooses from the key:
//   "wgmma" (bf16 operands, bm a multiple of 64, k and n multiples of 8 so
//   that TMA takes the row strides; every key of the MoE slice): one block
//   computes a BM x 128 tile with BM = 128 where 128 divides bm, else 64,
//   so a tile never straddles two row blocks: one consumer warpgroup per
//   64 rows and one producer warp, two blocks to an SM, so that one block's
//   first loads and epilogue overlap the other's products. The producer
//   thread reads the tile's group and layer on the device and keeps a
//   3-stage ring of BK 64 slices full by TMA: A through a (k, m) map, B
//   through one map over the whole (L*G, ., .) table whose third
//   coordinate is layer * G + group, 128-byte swizzled; transpose_b is the
//   B map's major-ness (the (n, k) weight K-major, the (k, n) one MN-major),
//   not a copy. The consumers run wgmma m64n128k16 with f32 accumulators in
//   registers, keeping one k slice's products in flight while the previous
//   slice's stage goes back to the producer, and apply the epilogue
//   (unary, conversion, store; columns past n masked) from registers, one
//   straight-line copy per unary. TMA's zero fill covers a ragged last k
//   or n slice. The grid walks row blocks fastest, so neighbouring blocks
//   read one expert's weight tile from L2.
//   "wmma" (f32 operands, a bm that 64 does not divide, strides TMA cannot
//   take): one 64-column output tile per block, staged through shared
//   memory without pipelining, WMMA bf16 (mma.sync
//   16x16x16, f32 accumulators) for bf16 and f32 "default" operands, f32
//   FMA for f32 "highest". Its rows BM are the largest of 64, 32, 16 that
//   divide bm (the wrapper refuses a bm that is not a multiple of 16).
//
// B17 takes one of the same two routes, which xsmm/reference.py
// grouped_wgrad_route chooses from the key and xt's strides:
//   "wgmma" (bf16 operands, bm a multiple of 64, n a multiple of 8, xt with
//   one unit stride and the other a multiple of 8; every key of the MoE
//   slice): one block per (128 n columns, 128 k rows, group), the group
//   slowest, with B16's ring, producer warp and consumer loop
//   (consume_ring, csrc/gemm_sm90.cuh's, which B1 and B19 share). Both
//   operands carry the reduction (the token rows) on their slow axis: dY's
//   slice is an MN-major B tile, and xt's an MN-major A tile (wgmma's
//   trans-a) when xt is the transpose of a contiguous x, a K-major one when
//   xt itself is contiguous. f32 stored from registers, masked at the k
//   and n edges.
//   "wmma": one 64 x 64 tile per block on TileMma's staging and products.
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"
#include "gemm_sm90.cuh"
#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 64, BK = 32;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;

// The products of one BM x BN output tile over a staged BK slice, with 4*BM
// threads: BM/16 x 2 warps of 16 x 32 on the tensor cores, or BM/4 x 16
// threads of 4 x 4 outputs on f32 FMA.
template <int BM, typename Tmma>
struct TileMma {
  static constexpr bool kTensor = std::is_same<Tmma, __nv_bfloat16>::value;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  float facc[4][4];

  __device__ void zero() {
    if constexpr (kTensor) {
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
    }
  }

  __device__ void step(const Tmma (*As)[BK + APAD],
                       const Tmma (*Bs)[BN + BPAD], int tid) {
    if constexpr (kTensor) {
      const int warp = tid / 32, wr = warp / 2, wc = warp % 2;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &As[wr * 16][kk], BK + APAD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &Bs[kk][wc * 32 + j * 16], BN + BPAD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    } else {
      const int ty = tid / 16, tx = tid % 16;
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = tpp::to_f32(As[ty + BM / 4 * i][kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = tpp::to_f32(Bs[kk][tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
      }
    }
  }

  // the accumulators into a shared f32 tile (the caller syncs after)
  __device__ void store(float (*Cs)[BN + CPAD], int tid) {
    if constexpr (kTensor) {
      const int warp = tid / 32, wr = warp / 2, wc = warp % 2;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&Cs[wr * 16][wc * 32 + j * 16], acc[j],
                                BN + CPAD, wmma::mem_row_major);
    } else {
      const int ty = tid / 16, tx = tid % 16;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Cs[ty + BM / 4 * i][tx + 16 * j] = facc[i][j];
    }
  }
};

// Tin: dtype of A/B in device memory; Tmma: dtype the products see.
template <int BM, typename Tin, typename Tmma>
__global__ void __launch_bounds__(4 * BM)
grouped_gemm_kernel(const Tin* __restrict__ A, const Tin* __restrict__ B,
                    const int* __restrict__ ge, const int* __restrict__ li,
                    void* __restrict__ out, int groups, int layers, int m,
                    int n, int k, int bm, int transpose_b, int unary,
                    int out_dtype) {
  constexpr int THREADS = 4 * BM;
  __shared__ __align__(128) Tmma As[BM][BK + APAD];
  __shared__ __align__(128) Tmma Bs[BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // BM divides bm: the tile lies in row block m0 / bm, one group. The
  // clamps keep a bad map or layer from reading outside the weight table.
  const int g = min(max(ge[m0 / bm], 0), groups - 1);
  const size_t layer = li != nullptr ? min(max(*li, 0), layers - 1) : 0;
  const Tin* Bg = B + (layer * groups + g) * static_cast<size_t>(k) * n;

  TileMma<BM, Tmma> tile;
  tile.zero();
  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      const float v =
          (gm < m && gk < k) ? tpp::to_f32(A[(size_t)gm * k + gk]) : 0.f;
      As[r][c] = tpp::from_f32<Tmma>(v);
    }
    if (transpose_b) {  // B[g] is [n, k]: walk k fastest
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int c = i / BK, r = i % BK;
        const int gk = k0 + r, gn = n0 + c;
        const float v =
            (gk < k && gn < n) ? tpp::to_f32(Bg[(size_t)gn * k + gk]) : 0.f;
        Bs[r][c] = tpp::from_f32<Tmma>(v);
      }
    } else {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const int gk = k0 + r, gn = n0 + c;
        const float v =
            (gk < k && gn < n) ? tpp::to_f32(Bg[(size_t)gk * n + gn]) : 0.f;
        Bs[r][c] = tpp::from_f32<Tmma>(v);
      }
    }
    __syncthreads();
    tile.step(As, Bs, tid);
    __syncthreads();
  }
  tile.store(Cs, tid);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= m || gn >= n) continue;
    tpp::store_out(out, (size_t)gm * n + gn, out_dtype,
                   tpp::apply_unary(unary, Cs[r][c]));
  }
}

__device__ int first_at_least(const int* __restrict__ a, int count, int v) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One block per (n tile, k tile, group); 256 threads, a 64 x 64 tile of
// dW[g] accumulated over the group's rows, BK rows at a time.
constexpr int WG_BM = 64;

template <typename Tin, typename Tmma>
__global__ void __launch_bounds__(4 * WG_BM)
grouped_wgrad_kernel(const Tin* __restrict__ xt, const Tin* __restrict__ dy,
                     const int* __restrict__ ge, float* __restrict__ out,
                     int m, int k, int n, int bm, long long xs0,
                     long long xs1) {
  constexpr int THREADS = 4 * WG_BM;
  __shared__ __align__(128) Tmma As[WG_BM][BK + APAD];
  __shared__ __align__(128) Tmma Bs[BK][BN + BPAD];
  __shared__ __align__(128) float Cs[WG_BM][BN + CPAD];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * WG_BM, g = blockIdx.z;
  const int nb = m / bm;
  const int r_begin = first_at_least(ge, nb, g) * bm;
  const int r_end = first_at_least(ge, nb, g + 1) * bm;

  TileMma<WG_BM, Tmma> tile;
  tile.zero();
  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    // As[kk][rr] = xt[k0 + kk, r0 + rr]: walk whichever index is
    // contiguous in memory fastest
    for (int i = tid; i < WG_BM * BK; i += THREADS) {
      const int kk = xs0 == 1 ? i % WG_BM : i / BK;
      const int rr = xs0 == 1 ? i / WG_BM : i % BK;
      const int gk = k0 + kk, gr = r0 + rr;
      const float v = (gk < k && gr < r_end)
                          ? tpp::to_f32(xt[gk * xs0 + gr * xs1])
                          : 0.f;
      As[kk][rr] = tpp::from_f32<Tmma>(v);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int rr = i / BN, c = i % BN;
      const int gr = r0 + rr, gn = n0 + c;
      const float v = (gr < r_end && gn < n)
                          ? tpp::to_f32(dy[(size_t)gr * n + gn])
                          : 0.f;
      Bs[rr][c] = tpp::from_f32<Tmma>(v);
    }
    __syncthreads();
    tile.step(As, Bs, tid);
    __syncthreads();
  }
  tile.store(Cs, tid);
  __syncthreads();
  float* og = out + static_cast<size_t>(g) * k * n;
  for (int i = tid; i < WG_BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gk = k0 + r, gn = n0 + c;
    if (gk < k && gn < n) og[(size_t)gk * n + gn] = Cs[r][c];
  }
}

template <int BM, typename Tin, typename Tmma>
void launch_gemm(const void* a, const void* b, const int* ge, const int* li,
                 void* out, int groups, int layers, int m, int n, int k,
                 int bm, int transpose_b, int unary, int out_dtype,
                 cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, m / BM);
  grouped_gemm_kernel<BM, Tin, Tmma><<<grid, 4 * BM, 0, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b), ge, li, out,
      groups, layers, m, n, k, bm, transpose_b, unary, out_dtype);
}

template <typename Tin, typename Tmma>
int gemm_by_bm(const void* a, const void* b, const int* ge, const int* li,
               void* out, int groups, int layers, int m, int n, int k,
               int bm, int transpose_b, int unary, int out_dtype,
               cudaStream_t stream) {
  if (bm % 64 == 0)
    launch_gemm<64, Tin, Tmma>(a, b, ge, li, out, groups, layers, m, n, k,
                               bm, transpose_b, unary, out_dtype, stream);
  else if (bm % 32 == 0)
    launch_gemm<32, Tin, Tmma>(a, b, ge, li, out, groups, layers, m, n, k,
                               bm, transpose_b, unary, out_dtype, stream);
  else if (bm % 16 == 0)
    launch_gemm<16, Tin, Tmma>(a, b, ge, li, out, groups, layers, m, n, k,
                               bm, transpose_b, unary, out_dtype, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// ---- B16 on wgmma: bf16 operands, bm a multiple of 64 -------------------

namespace hw = tpp::hopper;

constexpr int G_BN = 128, G_BK = 64, G_STAGES = 3, G_WG = 128;

template <int NCW>  // consumer warpgroups: BM = 64 NCW rows
struct GTile {
  static constexpr int BM = 64 * NCW;
  static constexpr int A_BYTES = BM * G_BK * 2;
  static constexpr int B_BYTES = G_BK * G_BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int bar_off = G_STAGES * STAGE;
  static constexpr int bytes = bar_off + 2 * G_STAGES * 8;
};

// The accumulator tile, unary(acc) converted, stored from registers:
// acc[4 j + 2 h + e] is row `row` + 8 h, column `col` + 8 j + e; rows at or
// past `m` are dropped; n is a multiple of 8, so a pair is in or out as a
// whole.
template <int U>
__device__ __forceinline__ void store_tile(const float (&acc)[64], void* out,
                                           int row, int col, int m, int n,
                                           int out_dtype) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int gm = row + 8 * ((i / 2) & 1), gn = col + 8 * (i / 4);
    if (gm >= m || gn >= n) continue;
    const float x0 = tpp::apply_unary(U, acc[i]);
    const float x1 = tpp::apply_unary(U, acc[i + 1]);
    const size_t at = (size_t)gm * n + gn;
    if (out_dtype == tpp::kBF16)
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                         at) = __floats2bfloat162_rn(x0, x1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
          make_float2(x0, x1);
  }
}

// The consumer side of the ring is csrc/gemm_sm90.cuh's consume_ring, which
// B1 and B19 run too: a stage is an A tile of 128 M rows (GTile<2>, or
// GTile<1>'s 64) then a B tile of 128 N columns, 64 deep.
static_assert(G_BK == tpp::sm90::BK, "the shared ring is 64 deep");

// TRANS_B 0: B[g] is (k, n), staged as two [64 k][64 n] MN-major chunks;
// 1: B[g] is (n, k), staged as one [128 n][64 k] K-major tile. NCW consumer
// warpgroups and one producer warp; two blocks share an SM, so one block's
// first loads and epilogue overlap the other's products.
template <int NCW, int TRANS_B>
__global__ void __launch_bounds__(G_WG * NCW + 32, 2)
grouped_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap bmap,
                          const int* __restrict__ ge,
                          const int* __restrict__ li, void* __restrict__ out,
                          int groups, int layers, int n, int k, int bm,
                          int unary, int out_dtype) {
  using T = GTile<NCW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bar_off);
  uint64_t* empty = full + G_STAGES;

  const int tid = threadIdx.x, wg = tid / G_WG;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * G_BN;
  const int ktiles = (k + G_BK - 1) / G_BK;

  if (tid == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], NCW * G_WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NCW) {  // ---- producer warp: one thread issues every copy ----
    if (tid != NCW * G_WG) return;
    // BM divides bm: the tile lies in row block m0 / bm, one group. The
    // clamps keep a bad map or layer from reading outside the weight table.
    const int g = min(max(ge[m0 / bm], 0), groups - 1);
    const int layer = li != nullptr ? min(max(*li, 0), layers - 1) : 0;
    const int z = layer * groups + g;
    int stage = 0, phase = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      hw::mbar_wait(&empty[stage], phase ^ 1);
      hw::mbar_arrive_tx(&full[stage], T::STAGE);
      unsigned char* sa = smem + stage * T::STAGE;
      unsigned char* sb = sa + T::A_BYTES;
      hw::tma_load_2d(sa, &amap, &full[stage], kt * G_BK, m0);
      if constexpr (TRANS_B) {
        hw::tma_load_3d(sb, &bmap, &full[stage], kt * G_BK, n0, z);
      } else {
        hw::tma_load_3d(sb, &bmap, &full[stage], n0, kt * G_BK, z);
        hw::tma_load_3d(sb + G_BK * 128, &bmap, &full[stage], n0 + 64,
                        kt * G_BK, z);
      }
      if (++stage == G_STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows m0 + 64 wg .. + 63 ----
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  tpp::sm90::consume_ring<0, TRANS_B ? 0 : 1, T::A_BYTES, G_BN, G_STAGES>(
      acc, smem, full, empty, ktiles, wg);

  // epilogue from registers, one straight-line copy per unary (the switch
  // inside the unrolled loop would inline every unary 64 times)
  const int warp = (tid % G_WG) / 32, lane = tid % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  const int col = n0 + 2 * (lane % 4);
  const int m = gridDim.x * T::BM;     // BM divides m: every row is in
  switch (unary) {
#define TPP_EPILOGUE(U)                                          \
  case U:                                                        \
    store_tile<U>(acc, out, row, col, m, n, out_dtype);          \
    break;
    TPP_EPILOGUE(tpp::kRelu)
    TPP_EPILOGUE(tpp::kExp)
    TPP_EPILOGUE(tpp::kSquare)
    TPP_EPILOGUE(tpp::kSqrt)
    TPP_EPILOGUE(tpp::kRsqrt)
    TPP_EPILOGUE(tpp::kTanh)
    TPP_EPILOGUE(tpp::kGelu)
    TPP_EPILOGUE(tpp::kGeluTanh)
    TPP_EPILOGUE(tpp::kNegate)
    TPP_EPILOGUE(tpp::kZero)
#undef TPP_EPILOGUE
    default:
      store_tile<tpp::kIdentity>(acc, out, row, col, m, n, out_dtype);
  }
}

template <int NCW, int TRANS_B>
int launch_gemm_wgmma(const void* a, const void* b, const int* ge,
                      const int* li, void* out, int groups, int layers, int m,
                      int n, int k, int bm, int unary, int out_dtype,
                      cudaStream_t stream) {
  using T = GTile<NCW>;
  const uint64_t lg = static_cast<uint64_t>(groups) * (layers ? layers : 1);
  CUtensorMap amap, bmap;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(k),
                              static_cast<uint64_t>(m)};
  const uint64_t a_strides[1] = {static_cast<uint64_t>(k) * 2};
  const uint32_t a_box[2] = {G_BK, T::BM};
  int rc = hw::make_map(&amap, a, 2, a_dims, a_strides, a_box, 128);
  if (rc) return rc;
  const uint64_t inner = TRANS_B ? k : n, outer = TRANS_B ? n : k;
  const uint64_t b_dims[3] = {inner, outer, lg};
  const uint64_t b_strides[2] = {inner * 2, inner * outer * 2};
  const uint32_t b_box[3] = {64, static_cast<uint32_t>(TRANS_B ? G_BN : G_BK),
                             1};
  rc = hw::make_map(&bmap, b, 3, b_dims, b_strides, b_box, 128);
  if (rc) return rc;
  auto kernel = grouped_gemm_wgmma_kernel<NCW, TRANS_B>;
  const int smem = T::bytes + 1024;     // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m / T::BM, (n + G_BN - 1) / G_BN);
  kernel<<<grid, G_WG * NCW + 32, smem, stream>>>(
      amap, bmap, ge, li, out, groups, layers, n, k, bm, unary, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

int gemm_wgmma(const void* a, const void* b, const int* ge, const int* li,
               void* out, int groups, int layers, int m, int n, int k, int bm,
               int transpose_b, int unary, int out_dtype,
               cudaStream_t stream) {
  if (bm % 64 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm % 128 == 0)
    return transpose_b
               ? launch_gemm_wgmma<2, 1>(a, b, ge, li, out, groups, layers, m,
                                         n, k, bm, unary, out_dtype, stream)
               : launch_gemm_wgmma<2, 0>(a, b, ge, li, out, groups, layers, m,
                                         n, k, bm, unary, out_dtype, stream);
  return transpose_b
             ? launch_gemm_wgmma<1, 1>(a, b, ge, li, out, groups, layers, m, n,
                                       k, bm, unary, out_dtype, stream)
             : launch_gemm_wgmma<1, 0>(a, b, ge, li, out, groups, layers, m, n,
                                       k, bm, unary, out_dtype, stream);
}

// ---- B17 on wgmma: bf16 operands, bm a multiple of 64 -------------------

// One block per (128 n columns, 128 k rows, group), the group slowest, so a
// group's x and dY slabs stay in L2 while its tiles run. The reduction runs
// over the group's token rows, the slow axis of both operands: the A tile
// (an xt slice, 128 k x 64 rows) is MN-major when xt's k axis is
// unit-stride (A_MN 1: the transpose of a contiguous (m, k) x, read as two
// [64 rows][64 k] boxes of a (k, m) map) and K-major when its row axis is
// (A_MN 0: one [128 k][64 rows] box of an (m, k) map); the B tile (a dY
// slice, 64 rows x 128 n) is MN-major. The producer finds the group's run
// of row blocks by a binary search of ge and streams its 64-row slices
// (bm a multiple of 64: no slice straddles two groups); the consumers sum
// them in order, so the result is bit-repeatable, and a group that owns no
// block runs no slice and stores its zero accumulators.
template <int A_MN>
__global__ void __launch_bounds__(G_WG * 2 + 32, 2)
grouped_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap ymap,
                           const int* __restrict__ ge,
                           float* __restrict__ out, int m, int k, int n,
                           int bm) {
  using T = GTile<2>;     // A 128 x 64, B 64 x 128: 16 KB each a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - hw::smem_u32(smem_raw) % 1024)
                                    % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bar_off);
  uint64_t* empty = full + G_STAGES;

  const int tid = threadIdx.x, wg = tid / G_WG;
  const int n0 = blockIdx.x * G_BN, k0 = blockIdx.y * T::BM, g = blockIdx.z;
  const int nb = m / bm;
  const int r_begin = first_at_least(ge, nb, g) * bm;
  const int slices = (first_at_least(ge, nb, g + 1) * bm - r_begin) / G_BK;

  if (tid == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 2 * G_WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer warp: one thread starts every copy ----
    if (tid != 2 * G_WG) return;
    // a 64-wide half box wholly past k or n is not loaded: the rows and
    // columns it would fill are never stored
    const bool x_hi = !A_MN || k0 + 64 < k, y_hi = n0 + 64 < n;
    const uint32_t bytes = T::STAGE - (x_hi ? 0 : G_BK * 128) -
                           (y_hi ? 0 : G_BK * 128);
    int stage = 0, phase = 0;
    for (int t = 0; t < slices; ++t) {
      const int r0 = r_begin + t * G_BK;
      hw::mbar_wait(&empty[stage], phase ^ 1);
      hw::mbar_arrive_tx(&full[stage], bytes);
      unsigned char* sa = smem + stage * T::STAGE;
      unsigned char* sb = sa + T::A_BYTES;
      if constexpr (A_MN) {
        hw::tma_load_2d(sa, &xmap, &full[stage], k0, r0);
        if (x_hi)
          hw::tma_load_2d(sa + G_BK * 128, &xmap, &full[stage], k0 + 64, r0);
      } else {
        hw::tma_load_2d(sa, &xmap, &full[stage], r0, k0);
      }
      hw::tma_load_2d(sb, &ymap, &full[stage], n0, r0);
      if (y_hi)
        hw::tma_load_2d(sb + G_BK * 128, &ymap, &full[stage], n0 + 64, r0);
      if (++stage == G_STAGES) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumer warpgroup wg: dW rows k0 + 64 wg .. + 63 ----
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  tpp::sm90::consume_ring<A_MN, 1, T::A_BYTES, G_BN, G_STAGES>(
      acc, smem, full, empty, slices, wg);
  const int warp = (tid % G_WG) / 32, lane = tid % 32;
  store_tile<tpp::kIdentity>(acc, out + static_cast<size_t>(g) * k * n,
                             k0 + wg * 64 + warp * 16 + lane / 4,
                             n0 + 2 * (lane % 4), k, n, tpp::kF32);
}

// xt (k, m) bf16 with element (kk, r) at xt[kk * xs0 + r * xs1]: xs0 == 1
// takes the MN-major A tile, xs1 == 1 the K-major one; the other stride,
// n and bm as xsmm/reference.py grouped_wgrad_route requires.
int wgrad_wgmma(const void* xt, const void* dy, const int* ge, float* out,
                int groups, int m, int k, int n, int bm, long long xs0,
                long long xs1, cudaStream_t stream) {
  if (bm % 64 || n % 8 || (xs0 != 1 && xs1 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = GTile<2>;
  const int a_mn = xs0 == 1;
  CUtensorMap xmap, ymap;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(a_mn ? k : m),
                              static_cast<uint64_t>(a_mn ? m : k)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(a_mn ? xs1 : xs0) *
                                 2};
  const uint32_t x_box[2] = {64, a_mn ? 64u : 128u};
  int rc = hw::make_map(&xmap, xt, 2, x_dims, x_strides, x_box, 128);
  if (rc) return rc;
  const uint64_t y_dims[2] = {static_cast<uint64_t>(n),
                              static_cast<uint64_t>(m)};
  const uint64_t y_strides[1] = {static_cast<uint64_t>(n) * 2};
  const uint32_t y_box[2] = {64, 64};
  rc = hw::make_map(&ymap, dy, 2, y_dims, y_strides, y_box, 128);
  if (rc) return rc;
  auto kernel = a_mn ? &grouped_wgrad_wgmma_kernel<1>
                     : &grouped_wgrad_wgmma_kernel<0>;
  const int smem = T::bytes + 1024;     // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + G_BN - 1) / G_BN, (k + T::BM - 1) / T::BM, groups);
  kernel<<<grid, G_WG * 2 + 32, smem, stream>>>(xmap, ymap, ge, out, m, k, n,
                                                bm);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tmma>
int launch_wgrad(const void* xt, const void* dy, const int* ge, float* out,
                 int groups, int m, int k, int n, int bm, long long xs0,
                 long long xs1, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (k + WG_BM - 1) / WG_BM, groups);
  grouped_wgrad_kernel<Tin, Tmma><<<grid, 4 * WG_BM, 0, stream>>>(
      static_cast<const Tin*>(xt), static_cast<const Tin*>(dy), ge, out, m,
      k, n, bm, xs0, xs1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). A and B are
// in_dtype, ge int32 (m / bm), li a device int32 (the layer of a stacked
// (layers, groups, ., .) table) or null, out out_dtype (m, n). route is
// xsmm/reference.py grouped_gemm_route's choice: 1 "wgmma" (bf16 operands,
// bm a multiple of 64, k and n multiples of 8), 0 "wmma" (bm a multiple of
// 16).
extern "C" int tpp_grouped_gemm(const void* a, const void* b, const void* ge,
                                const void* li, void* out, int groups,
                                int layers, int m, int n, int k, int bm,
                                int in_dtype, int mma_dtype, int out_dtype,
                                int transpose_b, int unary, int route,
                                void* stream) {
  if (bm <= 0 || m % bm) return static_cast<int>(cudaErrorInvalidValue);
  const int* gp = static_cast<const int*>(ge);
  const int* lp = static_cast<const int*>(li);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (in_dtype != tpp::kBF16 || mma_dtype != tpp::kBF16)
      return static_cast<int>(cudaErrorInvalidValue);
    return gemm_wgmma(a, b, gp, lp, out, groups, layers, m, n, k, bm,
                      transpose_b, unary, out_dtype, st);
  }
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    return gemm_by_bm<float, float>(a, b, gp, lp, out, groups, layers, m, n,
                                    k, bm, transpose_b, unary, out_dtype, st);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    return gemm_by_bm<float, __nv_bfloat16>(a, b, gp, lp, out, groups,
                                            layers, m, n, k, bm, transpose_b,
                                            unary, out_dtype, st);
  if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    return gemm_by_bm<__nv_bfloat16, __nv_bfloat16>(
        a, b, gp, lp, out, groups, layers, m, n, k, bm, transpose_b, unary,
        out_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// xt is in_dtype, element (kk, r) at xt[kk * xs0 + r * xs1]; dy in_dtype
// (m, n) contiguous; ge int32 (m / bm), non-decreasing; out f32 (G, k, n).
// route is xsmm/reference.py grouped_wgrad_route's choice: 1 "wgmma" (bf16
// operands, bm a multiple of 64, n a multiple of 8, xt with one unit
// stride and the other a multiple of 8), 0 "wmma".
extern "C" int tpp_grouped_wgrad(const void* xt, const void* dy,
                                 const void* ge, void* out, int groups,
                                 int m, int k, int n, int bm, long long xs0,
                                 long long xs1, int in_dtype, int mma_dtype,
                                 int route, void* stream) {
  if (bm <= 0 || m % bm) return static_cast<int>(cudaErrorInvalidValue);
  const int* gp = static_cast<const int*>(ge);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (in_dtype != tpp::kBF16 || mma_dtype != tpp::kBF16)
      return static_cast<int>(cudaErrorInvalidValue);
    return wgrad_wgmma(xt, dy, gp, o, groups, m, k, n, bm, xs0, xs1, st);
  }
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    return launch_wgrad<float, float>(xt, dy, gp, o, groups, m, k, n, bm,
                                      xs0, xs1, st);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    return launch_wgrad<float, __nv_bfloat16>(xt, dy, gp, o, groups, m, k, n,
                                              bm, xs0, xs1, st);
  if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    return launch_wgrad<__nv_bfloat16, __nv_bfloat16>(
        xt, dy, gp, o, groups, m, k, n, bm, xs0, xs1, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
