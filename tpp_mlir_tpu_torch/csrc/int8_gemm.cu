// int8 compute GEMM for Hopper (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:1365 _build_int8_gemm (B15):
//   out = unary((Xq @ Wq) * xscale[row] * wscale[col] [+ bias[col]])
// Xq (m, k) and Wq (k, n) are row-major int8, the scales and the bias f32.
// The products accumulate exactly in s32 (k * 127^2 stays far below 2^31 at
// every width the engine uses), and the epilogue follows the TPU kernel's
// order: the s32 sum rounded to f32, times the row scale, times the column
// scale, plus the bias, then the unary (epilogue.cuh, so gelu is the same
// exp2-domain gelu_exp2), one rounding to the output dtype.
//
// What bounds it on the H100: at the serving prefill shapes (m 4096, k 768
// or 3072) it is compute-bound (1,979 int8 TOP/s dense against 1 byte per
// operand element). This first version is bound by its instruction rate: one
// 128 x 128 output tile per block of 8 warps, each warp 32 x 64 of it as
// 2 x 4 WMMA s8 16x16x16 fragments with s32 accumulators; k steps of 64
// staged through shared memory without pipelining. WMMA wants 32-byte
// aligned fragment pointers, which an int8 row at a 16-column offset is
// not, so both tiles are kept in 16-column slabs: X as [k/16][row][16],
// W transposed as [k/16][col][16] (the matrix_b col_major form), every
// fragment a 256-byte aligned 16 x 16 block. Rows past m and columns past
// n read as zero and are not written; k must be a multiple of 16 (the
// wrapper checks). wgmma, TMA and a pipelined ring of tiles are later work.
#include <mma.h>
#include <stdint.h>

#include "epilogue.cuh"

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
        float y = static_cast<float>(cs[e]) * a.xs[row] * a.ws[col];
        if (a.bias != nullptr) y += a.bias[col];
        tpp::store_out(a.out, (size_t)row * a.n + col, a.out_dtype,
                       tpp::apply_unary(a.unary, y));
      }
      __syncwarp();
    }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x (m, k) and w
// (k, n) int8, row-major, k a multiple of 16 and x 16-byte aligned; xs (m,),
// ws (n,) and bias (n,) f32, bias null without one; out (m, n) in out_dtype.
extern "C" int tpp_int8_gemm(const void* x, const void* w, const void* xs,
                             const void* ws, const void* bias, void* out,
                             int m, int n, int k, int unary, int out_dtype,
                             void* stream) {
  if (k % 16) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(xs), static_cast<const float*>(ws),
               static_cast<const float*>(bias), out, m, n, k, unary,
               out_dtype};
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
