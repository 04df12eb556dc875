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
// F 3072) each product is 43.5 GFLOP, 0.044 ms at 989 TFLOP/s, so both
// are compute-bound by the card's measure. This first version keeps
// brgemm.cu's design: one 64-column output tile per block, staged through
// shared memory with no pipelining, WMMA bf16 (mma.sync 16x16x16, f32
// accumulators) for bf16 and f32 "default" operands, f32 FMA for f32
// "highest"; it is bound by the latency of the global->shared copies.
// A B16 tile must not straddle two row blocks, which may belong to
// different groups: its rows BM are the largest of 64, 32, 16 that divide
// bm (the wrapper refuses a bm that is not a multiple of 16). wgmma, TMA
// and a persistent schedule that keeps a group's weights in L2 are the
// next PRs' work.
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"

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
// (layers, groups, ., .) table) or null, out out_dtype (m, n). bm must be
// a multiple of 16.
extern "C" int tpp_grouped_gemm(const void* a, const void* b, const void* ge,
                                const void* li, void* out, int groups,
                                int layers, int m, int n, int k, int bm,
                                int in_dtype, int mma_dtype, int out_dtype,
                                int transpose_b, int unary, void* stream) {
  if (bm <= 0 || m % bm) return static_cast<int>(cudaErrorInvalidValue);
  const int* gp = static_cast<const int*>(ge);
  const int* lp = static_cast<const int*>(li);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
extern "C" int tpp_grouped_wgrad(const void* xt, const void* dy,
                                 const void* ge, void* out, int groups,
                                 int m, int k, int n, int bm, long long xs0,
                                 long long xs1, int in_dtype, int mma_dtype,
                                 void* stream) {
  if (bm <= 0 || m % bm) return static_cast<int>(cudaErrorInvalidValue);
  const int* gp = static_cast<const int*>(ge);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
