// Batched matmul with an optional row-softmax prologue, for Hopper (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:963 _build_batch_matmul (B21) and
// :1065 _build_batch_matmul_grouped (B22):
//   O[b] = f(A[b]) @ B[b] (+ C[b]),   A (m, k), B (k, n), C and O (m, n)
// with f the row softmax over k (softmax_lhs, the softmax(scores) @ V kernel
// of the MHA suite) or the identity. A has batch stride 0 when it is one
// (m, k) matrix shared by every b (lhs_shared). B22 is B21 with G whole
// problems in one TPU program, a grid choice for tiny problems; here it is
// the `group` loop: one block takes `group` problems in turn when a problem
// fits one tile.
//
// Numerics: operands rounded to the MXU dtype (bf16 for bf16 and f32
// "default", f32 for "highest"), products and sums in f32, C added in f32,
// one rounding to the output dtype. The softmax takes each row's max and
// sum over the whole k in f32 from A's values first (a pass over the row,
// so k needs no tile of its own), then P = exp(a - max) / sum is made while
// the A tile is staged and rounded to the MXU dtype before the product.
//
// What bounds it on the H100: the MHA suite's problems are 1024 of
// 32x32x64 or 32x64x32, ~4 KB of operands each, so the work is bytes and
// launch overhead, not tensor-core time. One block of 4 warps computes a
// 64x64 output tile from 64x32 A and 32x64 B tiles staged through shared
// memory without pipelining, by WMMA (mma.sync 16x16x16 bf16, f32
// accumulators in registers) or by f32 FMA at "highest". cp.async double
// buffering, and more problems per block for the tiny shapes, are later
// work.
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, WARPS = 4, THREADS = WARPS * 32;

struct Args {
  const void* a;
  const void* b;
  const float* c;  // f32 (batch, m, n), or null (beta0)
  void* out;
  int batch, m, n, k;
  int group;             // problems a block takes in turn
  long long a_stride;    // elements between A's problems; 0: lhs_shared
  int softmax, out_dtype;
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

template <typename Tin, typename Tmma>
__global__ void __launch_bounds__(THREADS) batch_matmul_kernel(Args a) {
  constexpr bool kTensor = std::is_same<Tmma, __nv_bfloat16>::value;
  // row pads keep WMMA pointers 32-byte aligned (bf16 rows a multiple of 8
  // elements) and spread the FMA path's column reads over the banks
  constexpr int ALD = kTensor ? BK + 8 : BK + 1;
  constexpr int BLD = kTensor ? BN + 8 : BN + 4;
  constexpr int CLD = BN + 4;
  __shared__ __align__(128) Tmma As[BM * ALD];
  __shared__ __align__(128) Tmma Bs[BK * BLD];
  __shared__ __align__(128) float Cs[BM * CLD];
  __shared__ float row_max[BM], row_sum[BM];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  for (int g = 0; g < a.group; ++g) {
    const int bi = blockIdx.z * a.group + g;
    if (bi >= a.batch) break;  // the same for every thread of the block
    const Tin* A = static_cast<const Tin*>(a.a) + bi * a.a_stride;
    const Tin* B = static_cast<const Tin*>(a.b) + (size_t)bi * a.k * a.n;

    if (a.softmax) {  // each row's max and sum over the whole k, in f32
      for (int r = warp; r < BM; r += WARPS) {
        float mx = -INFINITY, sum = 0.f;
        if (m0 + r < a.m) {
          const Tin* row = A + (size_t)(m0 + r) * a.k;
          for (int c = lane; c < a.k; c += 32)
            mx = fmaxf(mx, tpp::to_f32(row[c]));
          mx = warp_max(mx);
          for (int c = lane; c < a.k; c += 32)
            sum += expf(tpp::to_f32(row[c]) - mx);
          sum = warp_sum(sum);
        }
        if (lane == 0) {
          row_max[r] = mx;
          row_sum[r] = sum;
        }
      }
    }

    // kTensor: warp w owns the 16x16 output tiles (w, j), j = 0..3, of
    // the 64x64 block tile, as register fragments
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
    float facc[8][4];  // FMA: rows ty*8 + i, columns tx + 16 j
    const int ty = tid / 16, tx = tid % 16;
    if constexpr (kTensor) {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < a.k; k0 += BK) {
      __syncthreads();  // statistics ready; the previous tiles no longer read
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i % BK;
        float x = 0.f;
        if (m0 + r < a.m && k0 + c < a.k) {
          x = tpp::to_f32(A[(size_t)(m0 + r) * a.k + k0 + c]);
          if (a.softmax) x = expf(x - row_max[r]) / row_sum[r];
        }
        As[r * ALD + c] = tpp::from_f32<Tmma>(x);
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const bool in = k0 + r < a.k && n0 + c < a.n;
        Bs[r * BLD + c] = tpp::from_f32<Tmma>(
            in ? tpp::to_f32(B[(size_t)(k0 + r) * a.n + n0 + c]) : 0.f);
      }
      __syncthreads();
      if constexpr (kTensor) {
        if (m0 + warp * 16 < a.m) {
#pragma unroll
          for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::load_matrix_sync(fa, As + warp * 16 * ALD + kk, ALD);
#pragma unroll
            for (int j = 0; j < BN / 16; ++j) {
              if (n0 + j * 16 >= a.n) break;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> fb;
              wmma::load_matrix_sync(fb, Bs + kk * BLD + j * 16, BLD);
              wmma::mma_sync(acc[j], fa, fb, acc[j]);
            }
          }
        }
      } else {
        for (int kk = 0; kk < BK; ++kk) {
          float av[8], bv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = tpp::to_f32(As[(ty * 8 + i) * ALD + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = tpp::to_f32(Bs[kk * BLD + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
        }
      }
    }

    if constexpr (kTensor) {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wmma::store_matrix_sync(Cs + warp * 16 * CLD + j * 16, acc[j], CLD,
                                wmma::mem_row_major);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Cs[(ty * 8 + i) * CLD + tx + 16 * j] = facc[i][j];
    }
    __syncthreads();
    const size_t base = (size_t)bi * a.m * a.n;
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      if (m0 + r >= a.m || n0 + c >= a.n) continue;
      const size_t o = base + (size_t)(m0 + r) * a.n + n0 + c;
      float v = Cs[r * CLD + c];
      if (a.c) v += a.c[o];
      tpp::store_out(a.out, o, a.out_dtype, v);
    }
    __syncthreads();  // Cs and the statistics are free for the next problem
  }
}

template <typename Tin, typename Tmma>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM,
                  (a.batch + a.group - 1) / a.group);
  batch_matmul_kernel<Tin, Tmma><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). a is (batch, m, k),
// or (m, k) when lhs_shared; b (batch, k, n); c null or f32 (batch, m, n);
// out (batch, m, n). ceil(batch / group) goes in gridDim.z, so it is at
// most 65535.
extern "C" int tpp_batch_matmul(const void* a, const void* b, const void* c,
                                void* out, int batch, int m, int n, int k,
                                int group, int lhs_shared, int softmax,
                                int in_dtype, int mma_dtype, int out_dtype,
                                void* stream) {
  if (group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{a,     b,     static_cast<const float*>(c), out,
                  batch, m,     n,
                  k,     group, lhs_shared ? 0LL : (long long)m * k,
                  softmax, out_dtype};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    return launch<float, float>(args, st);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    return launch<float, __nv_bfloat16>(args, st);
  if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(args, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
