// Batch-reduce GEMM with a fused epilogue and an optional LayerNorm prologue,
// for Hopper (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:580 _build_brgemm (B1) and its
// weights-resident variant :243 _build_brgemm_wres (B2; their ln_stats
// prologue and ln_stats_out stay in queue A6):
//   out = unary( (C if not beta0) + sum_b A'[b] @ B[b]  OP  D )
// with B given as [b,k,n] or, under transpose_b, as [b,n,k]. A VNNI B is
// flattened by the wrapper, as _unvnni does outside the Pallas kernel.
// A' is A, or under the layer_norm prologue (batch 1) each A row normalized
// in f32 with the TPU kernels' one-pass statistics (mean, E[x^2] - mean^2
// over the whole k; kernels.py:688-699), then gamma/beta, then one rounding
// to the MXU dtype -- the LayerNorm output never goes to device memory.
//
// What bounds it on the H100: at the slice's shapes (m=256..2048,
// n=352..50304, k=352..4096) a GEMM is compute-bound on the tensor cores
// (989 TFLOP/s bf16) only when operands are re-read from shared memory many
// times; this first version stages one 64x64 output tile per block through
// shared memory with no pipelining, so it is bound by the latency of the
// global->shared copies and by the small grid (m=256, n=1024 gives 64
// blocks on 132 SMs). Its design keeps it simple and right: bf16 products
// go through WMMA (mma.sync 16x16x16, f32 accumulators); f32 at precision
// "highest" uses f32 FMA, so no TF32 is ever involved. The prologue's row
// statistics are computed per block, once for its 64 rows (each n-block
// recomputes them, a second read of the A rows from L2, as the TPU kernel
// recomputes them per n-block). The epilogue runs once per output element
// in f32 before the single store. TMA, wgmma and a pipelined ring of stages
// are the next PRs' work.
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;

struct Epilogue {
  int has_c, binary, bcast, unary, out_dtype;
};

// LayerNorm prologue: ln = 0 (none) or 1; gamma/beta f32 [k] or null.
struct Prologue {
  int ln;
  float eps;
  const float* gamma;
  const float* beta;
};

// Tin: dtype of A/B in device memory; Tmma: dtype the products see
// (bf16 -> tensor cores, float -> f32 FMA).
template <typename Tin, typename Tmma>
__global__ void __launch_bounds__(THREADS)
brgemm_kernel(const Tin* __restrict__ A, const Tin* __restrict__ B,
              const float* __restrict__ C, const float* __restrict__ D,
              void* __restrict__ out, int batch, int m, int n, int k,
              int transpose_b, Epilogue epi, Prologue pro) {
  constexpr bool kTensor = std::is_same<Tmma, __nv_bfloat16>::value;
  __shared__ __align__(128) Tmma As[BM][BK + APAD];
  __shared__ __align__(128) Tmma Bs[BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];
  __shared__ float mu_s[BM], rstd_s[BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;  // tensor path: 16x32 per warp
  const int ty = tid / 16, tx = tid % 16;  // FMA path: 4x4 per thread

  if (pro.ln) {
    // per-row mean and 1/sqrt(var + eps) over the whole k (batch is 1):
    // one warp per row, f32 sums of x and x^2
    const int lane = tid % 32;
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int gm = m0 + r;
      float s = 0.f, s2 = 0.f;
      if (gm < m)
        for (int c = lane; c < k; c += 32) {
          const float v = tpp::to_f32(A[(size_t)gm * k + c]);
          s += v;
          s2 += v * v;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0) {
        const float mu = s / k;
        mu_s[r] = mu;
        rstd_s[r] = 1.f / sqrtf(s2 / k - mu * mu + pro.eps);
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  float facc[4][4];
  if constexpr (kTensor) {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
  }

  for (int bi = 0; bi < batch; ++bi) {
    const Tin* Ab = A + (size_t)bi * m * k;
    const Tin* Bb = B + (size_t)bi * k * n;
    for (int k0 = 0; k0 < k; k0 += BK) {
      // stage A[m0:m0+BM, k0:k0+BK] and B[k0:k0+BK, n0:n0+BN], converted to
      // Tmma, zero outside the matrix (ragged edges)
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i % BK;
        const int gm = m0 + r, gk = k0 + c;
        float v =
            (gm < m && gk < k) ? tpp::to_f32(Ab[(size_t)gm * k + gk]) : 0.f;
        if (pro.ln && gm < m && gk < k) {
          v = (v - mu_s[r]) * rstd_s[r];
          if (pro.gamma != nullptr) v = v * pro.gamma[gk] + pro.beta[gk];
        }
        As[r][c] = tpp::from_f32<Tmma>(v);
      }
      if (transpose_b) {  // B[b] is [n, k]: walk k fastest
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int c = i / BK, r = i % BK;
          const int gk = k0 + r, gn = n0 + c;
          const float v = (gk < k && gn < n)
                              ? tpp::to_f32(Bb[(size_t)gn * k + gk])
                              : 0.f;
          Bs[r][c] = tpp::from_f32<Tmma>(v);
        }
      } else {
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int r = i / BN, c = i % BN;
          const int gk = k0 + r, gn = n0 + c;
          const float v = (gk < k && gn < n)
                              ? tpp::to_f32(Bb[(size_t)gk * n + gn])
                              : 0.f;
          Bs[r][c] = tpp::from_f32<Tmma>(v);
        }
      }
      __syncthreads();
      if constexpr (kTensor) {
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
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = tpp::to_f32(As[ty + 16 * i][kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = tpp::to_f32(Bs[kk][tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  // accumulators -> shared tile, then the epilogue once per element
  if constexpr (kTensor) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wr * 16][wc * 32 + j * 16], acc[j],
                              BN + CPAD, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[ty + 16 * i][tx + 16 * j] = facc[i][j];
  }
  __syncthreads();

  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= m || gn >= n) continue;
    const size_t o = (size_t)gm * n + gn;
    float v = Cs[r][c];
    if (epi.has_c) v += C[o];
    if (epi.binary != tpp::kBinNone) {
      float dv;
      switch (epi.bcast) {
        case tpp::kBcastCol: dv = D[gn]; break;
        case tpp::kBcastRow: dv = D[gm]; break;
        case tpp::kBcastScalar: dv = D[0]; break;
        default: dv = D[o]; break;
      }
      v = tpp::apply_binary(epi.binary, v, dv);
    }
    tpp::store_out(out, o, epi.out_dtype, tpp::apply_unary(epi.unary, v));
  }
}

template <typename Tin, typename Tmma>
void launch(const void* a, const void* b, const float* c, const float* d,
            void* out, int batch, int m, int n, int k, int transpose_b,
            Epilogue epi, Prologue pro, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  brgemm_kernel<Tin, Tmma><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b), c, d, out,
      batch, m, n, k, transpose_b, epi, pro);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). C, D, gamma and
// beta are f32 (the wrapper converts them); A and B are in_dtype; out is
// out_dtype. ln = 1 runs the LayerNorm prologue (batch must be 1); gamma
// and beta are null when it has no affine.
extern "C" int tpp_brgemm(const void* a, const void* b, const void* c,
                          const void* d, void* out, int batch, int m, int n,
                          int k, int in_dtype, int mma_dtype, int out_dtype,
                          int transpose_b, int has_c, int binary, int bcast,
                          int unary, int ln, float eps, const void* gamma,
                          const void* beta, void* stream) {
  if (ln && batch != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue epi{has_c, binary, bcast, unary, out_dtype};
  const Prologue pro{ln, eps, static_cast<const float*>(gamma),
                     static_cast<const float*>(beta)};
  const float* cf = static_cast<const float*>(c);
  const float* df = static_cast<const float*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    launch<float, float>(a, b, cf, df, out, batch, m, n, k, transpose_b, epi,
                         pro, st);
  else if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    launch<float, __nv_bfloat16>(a, b, cf, df, out, batch, m, n, k,
                                 transpose_b, epi, pro, st);
  else if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, cf, df, out, batch, m, n, k,
                                         transpose_b, epi, pro, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
