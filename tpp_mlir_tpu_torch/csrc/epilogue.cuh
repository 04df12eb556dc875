// Shared pieces of the port's Hopper kernels: dtype conversions and the
// fused epilogue (binary with D, then unary), evaluated in f32 registers.
// The codes below match tpp_mlir_tpu_torch/xsmm/kernels.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpp {

enum Dtype : int { kF32 = 0, kBF16 = 1 };
enum Binary : int { kBinNone = 0, kAdd = 1, kSub = 2, kMul = 3, kDiv = 4,
                    kMax = 5 };
enum Bcast : int { kBcastCol = 0, kBcastRow = 1, kBcastScalar = 2,
                   kBcastNone = 3 };
enum Unary : int { kIdentity = 0, kRelu = 1, kExp = 2, kSquare = 3,
                   kSqrt = 4, kRsqrt = 5, kTanh = 6, kGelu = 7,
                   kGeluTanh = 8, kNegate = 9, kZero = 10 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Exact-erf gelu in the exp2 domain, the constants and evaluation order of
// tpp_mlir_tpu/xsmm/kernels.py:85 _gelu_exp2.
__device__ __forceinline__ float gelu_exp2(float x) {
  const float u = fminf(fabsf(x), 5.939696961966999f);
  float q = 0.0004712450553503085f;
  q = q * u + -0.007063951197523899f;
  q = q * u + 0.05175779870672941f;
  q = q * u + -0.26125505922286846f;
  q = q * u + 1.1507275369545586f;
  q = q * u + 4.939192122802906e-05f;
  const float e = exp2f(-(0.7213475204444817f * u * u + q));
  return (x < 0.f ? 0.f : x) - 0.5f * u * e;
}

__device__ __forceinline__ float apply_unary(int kind, float x) {
  switch (kind) {
    case kRelu: return x < 0.f ? 0.f : x;
    case kExp: return expf(x);
    case kSquare: return x * x;
    case kSqrt: return sqrtf(x);
    case kRsqrt: return rsqrtf(x);
    case kTanh: return tanhf(x);
    case kGelu: return gelu_exp2(x);
    case kGeluTanh:
      return 0.5f * x *
             (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    case kNegate: return -x;
    case kZero: return 0.f;
    default: return x;
  }
}

__device__ __forceinline__ float apply_binary(int kind, float a, float b) {
  switch (kind) {
    case kAdd: return a + b;
    case kSub: return a - b;
    case kMul: return a * b;
    case kDiv: return a / b;
    case kMax: return fmaxf(a, b);
    default: return a;
  }
}

// v as store_out stores it, read back as f32 (one rounding to bf16)
__device__ __forceinline__ float round_out(int dtype, float v) {
  return dtype == kBF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void store_out(void* out, size_t i, int dtype,
                                          float v) {
  if (dtype == kBF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

}  // namespace tpp
