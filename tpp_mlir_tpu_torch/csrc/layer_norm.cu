// Row LayerNorm for Hopper (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:3257 _build_layer_norm (B12):
//   y = (x - mean) / sqrt(var + eps) [* gamma + beta]
// per row of an (m, n) matrix, with the two-pass f32 statistics and biased
// variance of the TPU kernel (mean first, then the mean of squared
// deviations), and one rounding to the output dtype.
//
// What bounds it on the H100: it reads each element once and writes it
// once, a few FLOPs per byte, so it is bound by device memory (3.35 TB/s);
// at the slice's shape (2048 x 768 bf16, 3 MB each way) it is a few
// microseconds and launch latency matters as much. Design: one warp per
// row, eight rows per 256-thread block, so n = 768 (not a power of two)
// needs no special case: each lane walks the row with stride 32. The row is
// read three times (sum, squared deviations, normalize), the second and
// third times from L1/L2, where it stays at these widths. Vector loads and
// keeping the row in registers are later work.
#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Tin>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const Tin* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, void* __restrict__ out,
                  int m, int n, float eps, int out_dtype) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= m) return;
  const Tin* xr = x + (size_t)row * n;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) s += tpp::to_f32(xr[c]);
  const float mean = warp_sum(s) / n;
  float q = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = tpp::to_f32(xr[c]) - mean;
    q += d * d;
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) / n + eps);
  for (int c = lane; c < n; c += 32) {
    float y = (tpp::to_f32(xr[c]) - mean) * rstd;
    if (gamma != nullptr) y = y * gamma[c] + beta[c];
    tpp::store_out(out, (size_t)row * n + c, out_dtype, y);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). gamma and beta are
// f32 (the wrapper converts them), both null when the key has no affine.
extern "C" int tpp_layer_norm(const void* x, const void* gamma,
                              const void* beta, void* out, int m, int n,
                              int in_dtype, int out_dtype, float eps,
                              void* stream) {
  const dim3 grid((m + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (in_dtype == tpp::kF32)
    layer_norm_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), g, b, out, m, n, eps, out_dtype);
  else if (in_dtype == tpp::kBF16)
    layer_norm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, out, m, n, eps,
        out_dtype);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
