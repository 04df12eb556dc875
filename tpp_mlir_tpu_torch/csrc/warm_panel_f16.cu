// The f16 instantiations of the warm-panel engine (csrc/warm_panel.cuh)
// that B3/B4/B5 (csrc/chain.cu) and B20 (csrc/blocked_matmul.cu) launch
// for f16 keys (ROADMAP A14): wgmma .f16 products, the panel, the staging
// and the resident weights in f16, streamed weights by FLOAT16 tensor
// maps. A translation unit of their own, so that nvcc builds these five
// kernels (one a panel height) beside chain.cu's and blocked_matmul.cu's
// bf16 ones.
#include "warm_panel.cuh"

namespace tpp {
namespace warm {

int run_f16(Params& p, const Plan& plan, cudaStream_t st) {
  return run<__half>(p, plan, st);
}

}  // namespace warm
}  // namespace tpp
