#!/usr/bin/env python
"""The functional op API: the port's kernels as plain PyTorch calls (the
kernel on CUDA tensors, its plain version on CPU tensors).

    python examples/torch/02_functional_ops.py [--device cuda|cpu]
"""

import argparse

import torch

from tpp_mlir_tpu_torch import ops
from tpp_mlir_tpu_torch.ops import trainable

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda")
args = p.parse_args()

g = torch.Generator(device=args.device).manual_seed(0)
x = torch.randn(256, 1024, generator=g, device=args.device).bfloat16()
w = torch.randn(1024, 1024, generator=g, device=args.device).bfloat16()
b = torch.zeros(1024, device=args.device, dtype=torch.bfloat16)

# one fused kernel: relu(x @ w + b)
y = ops.fused_mlp_layer(x, w, b, activation="relu")
print("fused layer:", tuple(y.shape), y.dtype)

# batch-reduce GEMM (the TPP primitive)
a3 = torch.randn(4, 256, 512, generator=g, device=args.device)
b3 = torch.randn(4, 512, 1024, generator=g, device=args.device)
print("brgemm:", tuple(ops.brgemm(a3, b3).shape))


# differentiable fused layer (an autograd Function over the kernels)
def loss(w):
    return (trainable.mlp_layer(x.float(), w, b.float()) ** 2).sum()


wf = w.float().requires_grad_()
(grad,) = torch.autograd.grad(loss(wf), wf)
print("grad:", tuple(grad.shape))
