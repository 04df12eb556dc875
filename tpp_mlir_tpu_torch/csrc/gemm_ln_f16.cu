// The f16 instantiations of the packed GEMM mainloop (csrc/gemm_sm90.cuh)
// with B2's LayerNorm prologue, which B2 (csrc/brgemm.cu) launches for f16
// layer_norm and ln_stats keys (ROADMAP A14): wgmma .f16 products with f32
// accumulators; A's rows normalized in f32 and rounded to f16, in place by
// the consumers on the rows TMA (FLOAT16 maps) delivered, or by the
// convert loader as it loads them. A translation unit of its own: the
// build runs one nvcc a source, all at once, so these six kernels compile
// beside gemm_f16.cu's and brgemm.cu's instead of lengthening either.
#include "gemm_sm90.cuh"

namespace tpp {
namespace sm90 {

int launch_plan_ln_f16(int loader, const Plan& p, const Gemm& g,
                       const CUtensorMap& amap, const CUtensorMap& bmap,
                       cudaStream_t st) {
  if (loader == kTma)
    return launch_plan<kBMn, kTma, kLnSmem, __half>(p, g, amap, bmap, st);
  if (loader == kConvert)
    return launch_plan<kBMn, kConvert, kLnLoad, __half>(p, g, amap, bmap,
                                                        st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
}  // namespace tpp
