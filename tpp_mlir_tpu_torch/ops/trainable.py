"""Differentiable fused ops: the port of `tpp_mlir_tpu/ops/trainable.py`.

Each op is a `torch.autograd.Function` whose forward is one BrgemmKey
kernel (csrc/brgemm.cu, B1) and whose backward computes dx with the same
kernel through `transpose_b`, as the JAX custom VJPs do
(trainable.py:29-36, :52-57). dW = x^T g in f32 and db = sum(g), which the
JAX package leaves to XLA, stay PyTorch ops.

`f32_matmul` is the training counterpart of the serving engine's `_f32mm`
(`jnp.dot(..., preferred_element_type=f32)`): the kernels-off MLP layers and
every GPT training contraction go through it.
"""

from __future__ import annotations

import torch

from ..serving.engine import _f32mm
from . import fused_mlp_layer, gemm


def _dw(x, g, w):
    """x^T g with f32 operands and sums, in w's dtype."""
    return torch.matmul(x.float().t(), g.float()).to(w.dtype)


class _MlpLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, precision):
        out = fused_mlp_layer(x, w, b, activation="relu", precision=precision)
        ctx.save_for_backward(x, w, out)
        ctx.precision = precision
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g = g * (out > 0).to(g.dtype)                    # relu'
        dx = gemm(g, w, transpose_b=True, precision=ctx.precision)
        return dx.to(x.dtype), _dw(x, g, w), g.sum(0).to(w.dtype), None


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, precision):
        ctx.save_for_backward(x, w)
        ctx.precision = precision
        return gemm(x, w, precision=precision)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = gemm(g, w, transpose_b=True, precision=ctx.precision)
        return dx.to(x.dtype), _dw(x, g, w), None


def mlp_layer(x, w, b, precision: str = "default"):
    """relu(x @ w + b) as one fused kernel, differentiable."""
    return _MlpLayer.apply(x, w, b, precision)


def matmul(x, w, precision: str = "default"):
    """x @ w (beta 0) as one kernel, differentiable."""
    return _Matmul.apply(x, w, precision)


class _F32Matmul(torch.autograd.Function):
    """x (..., K) @ w (K, N) with an f32 result. bf16 operands stay bf16
    (on CUDA `torch.mm(..., out_dtype=torch.float32)`, for which autograd
    raises "derivative for aten::mm is not implemented" in PyTorch 2.11);
    the backward runs the same GEMMs on the
    cotangent rounded to the operands' dtype, with f32 results, and returns
    dx and dw in their operands' dtypes. f32 operands: true f32 throughout."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _f32mm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        dx = _f32mm(g2, w.t()).to(x.dtype).reshape(x.shape)
        dw = _f32mm(x2.t(), g2).to(w.dtype)
        return dx, dw


def f32_matmul(x, w):
    """x @ w with f32 accumulation and an f32 result, differentiable."""
    return _F32Matmul.apply(x, w)
