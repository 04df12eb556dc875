// Row LayerNorm for Hopper (sm_90a).
//
// Replaces tpp_mlir_tpu/xsmm/kernels.py:3257 _build_layer_norm (B12):
//   y = (x - mean) / sqrt(var + eps) [* gamma + beta]
// per row of an (m, n) matrix, with the two-pass f32 statistics and biased
// variance of the TPU kernel (mean first, then the mean of squared
// deviations), and one rounding to the output dtype. x is f32, bf16 or
// f16; the output f32, bf16 or f16, whatever x's. gamma and beta are read
// in their stored dtype (f32, bf16 or f16) and widened in registers.
//
// What bounds it on the H100: it reads each element once and writes it
// once, a few FLOPs per byte, so it is bound by device memory (3.35 TB/s);
// at the slice's shapes (2048 x 768 bf16, 3 MB each way; 2048 x 1024 f32)
// it is a few microseconds, so the latency of its loads matters as much.
//
// Route "register" (reference.layer_norm_route: rows of whole 16-byte
// vectors, at most 8 a lane): one warp per row, eight rows per 256-thread
// block. Each lane loads its VPL vectors of the row (3 at 768 bf16, 8 at
// 1024 f32) with 16-byte loads, all issued before the first is used, and
// keeps them in registers: the mean, then the squared deviations, then the
// normalized row come from the registers, so each element is read from
// device memory once, and the row goes out in 16-byte (or, for a narrower
// output dtype, 8-byte) stores. The kernel is templated on VPL.
// Route "strided" (the first design, for rows of other widths, or forced):
// one warp per row, each lane walking the row with stride 32, so any n
// works; the row is read three times (sum, squared deviations, normalize),
// the second and third times from L1/L2.
#include <stdint.h>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_VPL = 8;   // 16-byte vectors a lane (layer_norm_route)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Tin>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const Tin* __restrict__ x, const void* __restrict__ gamma,
                  const void* __restrict__ beta, void* __restrict__ out,
                  int m, int n, float eps, int g_dtype, int out_dtype) {
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
    if (gamma != nullptr)
      y = y * tpp::load_any(gamma, c, g_dtype) +
          tpp::load_any(beta, c, g_dtype);
    tpp::store_any(out, (size_t)row * n + c, out_dtype, y);
  }
}

// E consecutive 16-bit H values from element i (one 16- or 8-byte load)
// as f32
template <int E, class H>
__device__ __forceinline__ void ld_vec16(float (&v)[E], const void* p,
                                         size_t i) {
  const H* h = static_cast<const H*>(p) + i;
  uint32_t w[E / 2];
  if constexpr (E == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(h);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(h);
    w[0] = u.x; w[1] = u.y;
  }
#pragma unroll
  for (int e = 0; e < E / 2; ++e) {
    const float2 f = tpp::pair_f32<H>(w[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// E consecutive f32, bf16 or f16 values from element i (E * size a
// multiple of 8 bytes, i a multiple of E: whole aligned vectors) as f32
template <int E>
__device__ __forceinline__ void ld_vec(float (&v)[E], const void* p,
                                       size_t i, int dtype) {
  if (dtype == tpp::kBF16) {
    ld_vec16<E, __nv_bfloat16>(v, p, i);
  } else if (dtype == tpp::kF16) {
    ld_vec16<E, __half>(v, p, i);
  } else {
    const float4* f =
        reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
#pragma unroll
    for (int w = 0; w < E / 4; ++w) {
      const float4 u = f[w];
      v[4 * w] = u.x;
      v[4 * w + 1] = u.y;
      v[4 * w + 2] = u.z;
      v[4 * w + 3] = u.w;
    }
  }
}

// E values as E 16-bit H (one 16- or 8-byte store)
template <int E, class H>
__device__ __forceinline__ void st_vec16(void* p, size_t i,
                                         const float (&v)[E]) {
  uint32_t w[E / 2];
#pragma unroll
  for (int e = 0; e < E / 2; ++e)
    w[e] = tpp::hopper::pack16<H>(v[2 * e], v[2 * e + 1]);
  H* o = static_cast<H*>(p) + i;
  if constexpr (E == 8)
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
}

// E values as E f32 (16-byte stores) or E bf16 or f16
template <int E>
__device__ __forceinline__ void st_vec(void* p, size_t i, int dtype,
                                       const float (&v)[E]) {
  if (dtype == tpp::kBF16) {
    st_vec16<E, __nv_bfloat16>(p, i, v);
  } else if (dtype == tpp::kF16) {
    st_vec16<E, __half>(p, i, v);
  } else {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// Route "register": lane `lane` holds vectors lane, lane + 32, ... (VPL of
// them, E elements each) of its warp's row.
template <typename Tin, int VPL>
__global__ void __launch_bounds__(THREADS)
layer_norm_rows(const Tin* __restrict__ x, const void* __restrict__ gamma,
                const void* __restrict__ beta, void* __restrict__ out, int m,
                int n, float eps, int g_dtype, int out_dtype) {
  constexpr int E = 16 / sizeof(Tin);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= m) return;
  const int nv = n / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * n);
  uint4 raw[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = i * 32 + lane;
    raw[i] = c < nv ? xr[c] : make_uint4(0, 0, 0, 0);
  }
  float v[VPL][E];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const Tin* t = reinterpret_cast<const Tin*>(&raw[i]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[i][e] = tpp::to_f32(t[e]);
      s += v[i][e];
    }
  }
  const float mean = warp_sum(s) / n;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (i * 32 + lane >= nv) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = v[i][e] - mean;
      q += d * d;
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) / n + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = i * 32 + lane;
    if (c >= nv) continue;
    float y[E];
#pragma unroll
    for (int e = 0; e < E; ++e) y[e] = (v[i][e] - mean) * rstd;
    if (gamma != nullptr) {
      float g[E], b[E];
      ld_vec<E>(g, gamma, (size_t)c * E, g_dtype);
      ld_vec<E>(b, beta, (size_t)c * E, g_dtype);
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = y[e] * g[e] + b[e];
    }
    st_vec<E>(out, (size_t)row * n + (size_t)c * E, out_dtype, y);
  }
}

template <typename Tin, int VPL>
int launch_rows(const void* x, const void* gamma, const void* beta,
                void* out, int m, int n, float eps, int g_dtype,
                int out_dtype, cudaStream_t st) {
  const dim3 grid((m + WARPS - 1) / WARPS);
  layer_norm_rows<Tin, VPL><<<grid, THREADS, 0, st>>>(
      static_cast<const Tin*>(x), gamma, beta, out, m, n, eps, g_dtype,
      out_dtype);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch_rows(int vpl, const void* x, const void* gamma,
                  const void* beta, void* out, int m, int n, float eps,
                  int g_dtype, int out_dtype, cudaStream_t st) {
  switch (vpl) {
#define TPP_LN_ROWS(V)                                                     \
  case V:                                                                  \
    return launch_rows<Tin, V>(x, gamma, beta, out, m, n, eps, g_dtype,    \
                               out_dtype, st);
    TPP_LN_ROWS(1)
    TPP_LN_ROWS(2)
    TPP_LN_ROWS(3)
    TPP_LN_ROWS(4)
    TPP_LN_ROWS(5)
    TPP_LN_ROWS(6)
    TPP_LN_ROWS(7)
    TPP_LN_ROWS(8)
#undef TPP_LN_ROWS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x is in_dtype
// (f32, bf16 or f16) and out out_dtype (f32, bf16 or f16, whatever x's:
// one rounding of the f32 row). gamma and beta in g_dtype (f32, bf16 or
// f16), both null when the key has no affine. route 1
// ("register") needs rows of whole 16-byte vectors, at most MAX_VPL a
// lane, and 16-byte aligned x, out, gamma and beta (8-byte for a vector of
// four 16-bit values); route 0 ("strided") takes any n.
extern "C" int tpp_layer_norm(const void* x, const void* gamma,
                              const void* beta, void* out, int m, int n,
                              int in_dtype, int out_dtype, int g_dtype,
                              int route, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tpp::epilogue_dtypes_ok(in_dtype, out_dtype,
                               gamma != nullptr ? g_dtype : tpp::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    const int es = in_dtype == tpp::kF32 ? 4 : 2;
    const int nv = n * es / 16;
    const int vpl = (nv + 31) / 32;
    if ((n * es) % 16 || vpl < 1 || vpl > MAX_VPL)
      return static_cast<int>(cudaErrorInvalidValue);
    if (in_dtype == tpp::kF32)
      return dispatch_rows<float>(vpl, x, gamma, beta, out, m, n, eps,
                                  g_dtype, out_dtype, st);
    if (in_dtype == tpp::kF16)
      return dispatch_rows<__half>(vpl, x, gamma, beta, out, m, n, eps,
                                   g_dtype, out_dtype, st);
    return dispatch_rows<__nv_bfloat16>(vpl, x, gamma, beta, out, m, n, eps,
                                        g_dtype, out_dtype, st);
  }
  const dim3 grid((m + WARPS - 1) / WARPS);
  if (in_dtype == tpp::kF32)
    layer_norm_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), gamma, beta, out, m, n, eps, g_dtype,
        out_dtype);
  else if (in_dtype == tpp::kF16)
    layer_norm_kernel<__half><<<grid, THREADS, 0, st>>>(
        static_cast<const __half*>(x), gamma, beta, out, m, n, eps, g_dtype,
        out_dtype);
  else
    layer_norm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), gamma, beta, out, m, n, eps,
        g_dtype, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing (one block of one warp): the
// card's floor for a launch replayed from a CUDA graph, beside which
// B12's few microseconds are read.
extern "C" int tpp_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
