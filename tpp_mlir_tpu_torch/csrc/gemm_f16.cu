// The f16 instantiations of the packed GEMM mainloop (csrc/gemm_sm90.cuh)
// that B1 (csrc/brgemm.cu) and B19 (csrc/blocked_matmul.cu) launch for
// f16 keys (ROADMAP A14): wgmma .f16 products with f32 accumulators, fed
// by TMA maps of FLOAT16 elements or by the convert loader, which copies
// raw halves (no rounding) and re-lays a VNNI2 B. A translation unit of
// their own: the build runs one nvcc a source, all at once, so these
// fifteen kernels compile beside brgemm.cu's and blocked_matmul.cu's bf16
// ones instead of lengthening either.
#include "gemm_sm90.cuh"

namespace tpp {
namespace sm90 {

int launch_plan_f16(int bmode, int loader, const Plan& p, const Gemm& g,
                    const CUtensorMap& amap, const CUtensorMap& bmap,
                    cudaStream_t st) {
  if (loader == kTma) {
    if (bmode == kBMn)
      return launch_plan<kBMn, kTma, kLnNone, __half>(p, g, amap, bmap, st);
    if (bmode == kBK)
      return launch_plan<kBK, kTma, kLnNone, __half>(p, g, amap, bmap, st);
  } else if (loader == kConvert) {
    if (bmode == kBMn)
      return launch_plan<kBMn, kConvert, kLnNone, __half>(p, g, amap, bmap,
                                                          st);
    if (bmode == kBK)
      return launch_plan<kBK, kConvert, kLnNone, __half>(p, g, amap, bmap,
                                                         st);
    if (bmode == kBVnni)
      return launch_plan<kBVnni, kConvert, kLnNone, __half>(p, g, amap,
                                                            bmap, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
}  // namespace tpp
