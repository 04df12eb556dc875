"""tpp-mlir-tpu on PyTorch and CUDA: the port of `tpp_mlir_tpu` to one
NVIDIA H100.

The layout mirrors the JAX package, module for module:
  tools/      tpp-run (runs IR from tpp-gen on the card)
  passes/     the pass pipeline of the slice (default-tpp-passes)
  runtime/    executor (IR -> eager PyTorch), CUDA-event timing, tensor init
  xsmm/       kernel keys, cache, wrappers, plain versions, the nvcc build
  csrc/       the hand-written Hopper kernels (CUDA C++, sm_90a)
  utils/      the device target

The IR, the model builders and tpp-gen are shared with `tpp_mlir_tpu`
(`tpp_mlir_tpu.ir`, `.models`, `.tools.mlir_gen`), which import no JAX.
Importing this package loads neither JAX nor Triton nor the CUDA library.
"""

__version__ = "0.1.0"
