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

// The one dtype table of every C entry (xsmm/kernels.py _DT_CODE). f16
// runs in every kernel; an output, C, D, bias or gamma/beta may be stored
// in any of the three float types whatever the products' type; int8 is
// read only as operands (B13's int8 K/V cache).
enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };
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

// One element stored as f32, bf16 or f16 (the code), read as or written
// from f32: a kernel's output, C, D, bias and gamma/beta may be of any of
// the three types whatever its products' type E. Each kernel keeps its
// E-typed (and f32) vector paths for the common case and takes these
// scalar ones elsewhere; a store is one rounding of the f32 value. The
// two 16-bit types share one 16-bit access, the conversion chosen by a
// select: a branch of its own for each type would grow every unrolled
// epilogue by a third store path (and the build with it).
__device__ __forceinline__ float load_any(const void* p, size_t i,
                                          int dtype) {
  if (dtype == kF32) return static_cast<const float*>(p)[i];
  const unsigned short u = static_cast<const unsigned short*>(p)[i];
  return dtype == kBF16 ? __uint_as_float(static_cast<uint32_t>(u) << 16)
                        : __half2float(__ushort_as_half(u));
}

// v rounded once to a 16-bit code's type, as its bits
__device__ __forceinline__ unsigned short bits16(int dtype, float v) {
  return dtype == kBF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(v))
                        : __half_as_ushort(__float2half_rn(v));
}

// v as store_any stores it, read back as f32
__device__ __forceinline__ float round_any(int dtype, float v) {
  if (dtype == kF32) return v;
  const unsigned short u = bits16(dtype, v);
  return dtype == kBF16 ? __uint_as_float(static_cast<uint32_t>(u) << 16)
                        : __half2float(__ushort_as_half(u));
}

__device__ __forceinline__ void store_any(void* out, size_t i, int dtype,
                                          float v) {
  if (dtype == kF32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<unsigned short*>(out)[i] = bits16(dtype, v);
}

// two values as a pair of a 16-bit code's type (the lower address in the
// low half): both paired conversions and a select, where a pair of E
// alone is one conversion
__device__ __forceinline__ uint32_t pair_bits16(int dtype, float lo,
                                                float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  const __half2 h = __floats2half2_rn(lo, hi);
  return dtype == kBF16 ? *reinterpret_cast<const uint32_t*>(&b)
                        : *reinterpret_cast<const uint32_t*>(&h);
}

// The typed forms of store_any and round_any for a kernel whose every
// other type goes elsewhere: f32 or E (bf16 by default), one rounding.
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void store_out(void* out, size_t i, int dtype,
                                          float v) {
  if (dtype == dtype_code<E>())
    static_cast<E*>(out)[i] = from_f32<E>(v);
  else
    static_cast<float*>(out)[i] = v;
}

template <typename E = __nv_bfloat16>
__device__ __forceinline__ float round_out(int dtype, float v) {
  return dtype == dtype_code<E>() ? to_f32(from_f32<E>(v)) : v;
}

// Host: whether an output and C and D have float codes (a C entry refuses
// another, cudaErrorInvalidValue, before it launches).
inline bool epilogue_dtypes_ok(int out, int c = kF32, int d = kF32) {
  for (const int x : {out, c, d})
    if (x != kF32 && x != kBF16 && x != kF16) return false;
  return true;
}

}  // namespace tpp
