// Whole-chain fused MLP for Hopper (sm_90a): act(...act(x@W1+b1)@W2...)
// in one launch, optionally `repeats` times with the output fed back.
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:1475 _build_chain (B3) and
// :2001 _build_chain_bench (B4). Rows of an MLP are independent, so one
// block owns CBM rows and carries them through every layer and every
// repeat, writing the output once at the end: no grid-wide sync, and B4 is
// a loop inside B3 rather than a second kernel.
//
// Numerics of both references:
//   * B3: f32 between layers; only each product's input is rounded to the
//     MXU dtype (bf16, or f32 at precision "highest").
//   * B4 (repeats > 1): the state fed back is held in the MXU dtype, and the
//     output is that state, converted to the output dtype.
//
// What bounds it on the H100: the activation row-block lives in dynamic
// shared memory (the layer input in the MXU dtype plus the f32 layer
// output: 99 KB at 1024 wide in bf16, 129 KB in f32 "highest"), which is
// above the 48 KB default, so the launch opts in with cudaFuncSetAttribute.
// Weights stream from device memory for every block; the three 1024x1024
// bf16 weights of the flagship (6 MB) sit in the 50 MB L2. With CBM = 16
// rows a 256-row batch is only 16 blocks on 132 SMs, so this first version
// is bound by per-SM tensor-core rate and L2 bandwidth on a few SMs, not by
// the card. Splitting the columns of a layer across a cluster of blocks
// (distributed shared memory) is the way to fill the card; that is later
// work.
#include <mma.h>

#include <type_traits>

#include "epilogue.cuh"

using namespace nvcuda;

namespace {

constexpr int CBM = 16, THREADS = 256, MAXL = 32;
constexpr int HPAD = 8, ZPAD = 4;

struct ChainParams {
  const void* w[MAXL];      // [dims[i], dims[i+1]] row-major, in Tmma
  const float* bias[MAXL];  // [dims[i+1]] f32, or null
  int dims[MAXL + 1];
  int L, dmax, unary, last_unary, repeats, round_out, out_dtype;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <typename Tmma>
__host__ __device__ inline size_t smem_bytes(int dmax) {
  return align128((size_t)CBM * (dmax + HPAD) * sizeof(Tmma)) +
         (size_t)CBM * (dmax + ZPAD) * sizeof(float);
}

template <typename Tin, typename Tmma>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const Tin* __restrict__ x, void* __restrict__ out, int m,
             ChainParams p) {
  constexpr bool kTensor = std::is_same<Tmma, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = p.dmax + HPAD, ldz = p.dmax + ZPAD;
  Tmma* H = reinterpret_cast<Tmma*>(smem);  // layer input, MXU dtype
  float* Z = reinterpret_cast<float*>(
      smem + align128((size_t)CBM * ldh * sizeof(Tmma)));  // layer output
  const int tid = threadIdx.x, warp = tid / 32;
  const int r0 = blockIdx.x * CBM;

  const int d0 = p.dims[0];
  for (int i = tid; i < CBM * d0; i += THREADS) {
    const int r = i / d0, c = i % d0;
    const float v =
        (r0 + r < m) ? tpp::to_f32(x[(size_t)(r0 + r) * d0 + c]) : 0.f;
    H[r * ldh + c] = tpp::from_f32<Tmma>(v);
  }
  __syncthreads();

  for (int rep = 0; rep < p.repeats; ++rep) {
    for (int li = 0; li < p.L; ++li) {
      const int K = p.dims[li], N = p.dims[li + 1];
      const Tmma* W = static_cast<const Tmma*>(p.w[li]);
      if constexpr (kTensor) {
        // one 16x16 output tile per warp step; A from shared memory, B
        // straight from device memory (L2-resident), f32 accumulators
        for (int nt = warp; nt < N / 16; nt += THREADS / 32) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.f);
          for (int k0 = 0; k0 < K; k0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fa, H + k0, ldh);
            wmma::load_matrix_sync(fb, W + (size_t)k0 * N + nt * 16, N);
            wmma::mma_sync(acc, fa, fb, acc);
          }
          wmma::store_matrix_sync(Z + nt * 16, acc, ldz, wmma::mem_row_major);
        }
      } else {
        // f32 FMA: each thread owns 4 rows x 4 columns of a 256-column slab
        const int ty = tid / 64, tx = tid % 64;
        for (int c0 = 0; c0 < N; c0 += 256) {
          float acc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
          for (int kk = 0; kk < K; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i] = tpp::to_f32(H[(ty * 4 + i) * ldh + kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = c0 + tx + 64 * j;
              b[j] = col < N ? tpp::to_f32(W[(size_t)kk * N + col]) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = c0 + tx + 64 * j;
              if (col < N) Z[(ty * 4 + i) * ldz + col] = acc[i][j];
            }
        }
      }
      __syncthreads();
      // bias + activation in f32; the next layer's input in the MXU dtype
      const float* bias = p.bias[li];
      const int act = li < p.L - 1 ? p.unary : p.last_unary;
      for (int i = tid; i < CBM * N; i += THREADS) {
        const int r = i / N, c = i % N;
        float v = Z[r * ldz + c];
        if (bias) v += bias[c];
        v = tpp::apply_unary(act, v);
        Z[r * ldz + c] = v;
        H[r * ldh + c] = tpp::from_f32<Tmma>(v);
      }
      __syncthreads();
    }
  }

  const int dl = p.dims[p.L];
  for (int i = tid; i < CBM * dl; i += THREADS) {
    const int r = i / dl, c = i % dl;
    if (r0 + r >= m) continue;
    const float v = p.round_out ? tpp::to_f32(H[r * ldh + c]) : Z[r * ldz + c];
    tpp::store_out(out, (size_t)(r0 + r) * dl + c, p.out_dtype, v);
  }
}

template <typename Tin, typename Tmma>
int launch(const void* x, void* out, int m, const ChainParams& p,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<Tmma>(p.dmax);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<Tin, Tmma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + CBM - 1) / CBM);
  chain_kernel<Tin, Tmma><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), out, m, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes the kernel asks for at width dmax; the pipeline's
// chain_fits_smem gate mirrors this formula.
extern "C" long long tpp_chain_smem_bytes(int dmax, int mma_dtype) {
  return mma_dtype == tpp::kBF16
             ? static_cast<long long>(smem_bytes<__nv_bfloat16>(dmax))
             : static_cast<long long>(smem_bytes<float>(dmax));
}

// Returns the cudaError_t of the launch (0 on success). w_ptrs/b_ptrs are
// host arrays of L device pointers (weights in the MXU dtype, biases f32);
// dims is a host array of L+1 ints. Every dim must be a multiple of 16.
extern "C" int tpp_chain(const void* x, void* out, const void* const* w_ptrs,
                         const void* const* b_ptrs, const int* dims, int L,
                         int m, int in_dtype, int mma_dtype, int out_dtype,
                         int has_bias, int unary, int last_unary, int repeats,
                         int round_out, void* stream) {
  if (L < 1 || L > MAXL) return static_cast<int>(cudaErrorInvalidValue);
  ChainParams p{};
  p.L = L;
  p.dmax = 0;
  for (int i = 0; i <= L; ++i) {
    if (dims[i] <= 0 || dims[i] % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    p.dims[i] = dims[i];
    p.dmax = dims[i] > p.dmax ? dims[i] : p.dmax;
  }
  for (int i = 0; i < L; ++i) {
    p.w[i] = w_ptrs[i];
    p.bias[i] = has_bias ? static_cast<const float*>(b_ptrs[i]) : nullptr;
  }
  p.unary = unary;
  p.last_unary = last_unary;
  p.repeats = repeats < 1 ? 1 : repeats;
  p.round_out = round_out;
  p.out_dtype = out_dtype;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kF32)
    return launch<float, float>(x, out, m, p, st);
  if (in_dtype == tpp::kF32 && mma_dtype == tpp::kBF16)
    return launch<float, __nv_bfloat16>(x, out, m, p, st);
  if (in_dtype == tpp::kBF16 && mma_dtype == tpp::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, out, m, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
