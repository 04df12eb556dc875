"""tpp-mlir-tpu on PyTorch and CUDA: the port of `tpp_mlir_tpu` to one
NVIDIA H100.

The layout mirrors the JAX package, module for module:
  ir/         the tensor IR (a copy, without the jnp evaluator)
  models/     tpp-gen's MLP, the torch GPT and encoder block (copies)
  frontend/   the torch.fx importer (a copy)
  tools/      tpp-gen, tpp-run, the bench driver, tpp-serve, the tracer
  passes/     the pass pipeline of the slice (default-tpp-passes)
  runtime/    executor (IR -> eager PyTorch), CUDA-event timing, tensor init
  serving/    the GPT serving engine (prefill, KV-cache decode, generate)
  ops/        differentiable GEMM ops over the kernels (autograd Functions)
  parallel/   meshes over torch.distributed ranks, the collectives, the
              dp/tp/pp/sp/ep modes, the training steps, ZeRO-1
  xsmm/       kernel keys, cache, wrappers, plain versions, the nvcc build
  csrc/       the hand-written Hopper kernels (CUDA C++, sm_90a)
  utils/      the device target, FLOP counting

The port imports nothing of `tpp_mlir_tpu`: what it shares with the JAX
package (IR, model builders, importer, tpp-gen) it keeps as copies, which
`tests/test_torch_ir.py` holds to the originals. Importing this package
loads neither JAX nor Triton nor the CUDA library.
"""

__version__ = "0.1.0"
