// Shared pieces of the port's Hopper kernels: dtype conversions and the
// fused epilogue (binary with D, then unary), evaluated in f32 registers.
// The codes below match tpp_mlir_tpu_torch/xsmm/kernels.py.
#pragma once

#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace tpp {

// f16 (ROADMAP A14) runs in every kernel: the GEMM family (B1, B2, B3-B5,
// B19, B20), B12, attention (B6-B11), the batched matmul (B21/B22), the
// convs (B23-B25), the grouped GEMMs (B16/B17), B15's output, decode
// attention (B13) and the training attention (B14/B18)
enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
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
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// the 16-bit type that goes with T: T itself, or bf16 beside f32 (an f32
// kernel's 16-bit output)
template <typename T>
using Out16 = typename std::conditional<std::is_same<T, float>::value,
                                        __nv_bfloat16, T>::type;

// the Dtype code of a 16-bit type
template <typename T> __host__ __device__ constexpr int dtype_code() {
  return std::is_same<T, __half>::value ? kF16 : kBF16;
}

// a pair of 16-bit E values (the lower address in the low half) as f32
template <typename E>
__device__ __forceinline__ float2 pair_f32(uint32_t u) {
  if constexpr (std::is_same<E, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
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

// The output and epilogue operands of a kernel are f32 or its one 16-bit
// type E: bf16, or f16 in a kernel's f16 instantiations (ROADMAP A14).
// Keeping one 16-bit branch keeps each instantiation's epilogue as small
// as the bf16 one.

// v as store_out<E> stores it, read back as f32 (one rounding to E)
template <typename E = __nv_bfloat16>
__device__ __forceinline__ float round_out(int dtype, float v) {
  return dtype == dtype_code<E>() ? to_f32(from_f32<E>(v)) : v;
}

template <typename E = __nv_bfloat16>
__device__ __forceinline__ void store_out(void* out, size_t i, int dtype,
                                          float v) {
  if (dtype == dtype_code<E>())
    static_cast<E*>(out)[i] = from_f32<E>(v);
  else
    static_cast<float*>(out)[i] = v;
}

// Host: whether an epilogue of 16-bit type code e16 (kBF16 or kF16) takes
// an output and C and D of these codes. store_out<E> and round_out<E>
// write anything but E as f32, so a C entry refuses (cudaErrorInvalidValue)
// a 16-bit code other than its kernel's before it launches: an f16 output
// on a bf16 epilogue would be written as floats, twice its buffer.
inline bool epilogue_dtypes_ok(int e16, int out, int c = kF32,
                               int d = kF32) {
  for (const int x : {out, c, d})
    if (x != kF32 && x != e16) return false;
  return true;
}

}  // namespace tpp
