"""Functional ops over the kernel cache: the port of the GEMM part of
`tpp_mlir_tpu/ops/__init__.py` (`gemm`, `fused_mlp_layer`), for callers that
want the kernels without the IR pipeline. Both dispatch a BrgemmKey
(csrc/brgemm.cu on CUDA tensors, the plain version on CPU tensors).
`precision` is the key's: "default" rounds f32 operands to bf16 (the
compiled TPU meaning), "highest" keeps true f32."""

from __future__ import annotations

import torch

from ..xsmm.cache import global_cache
from ..xsmm.flags import BrgemmKey

_DT = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _dt(x: torch.Tensor) -> str:
    if x.dtype not in _DT:
        raise NotImplementedError(f"{x.dtype} operands: the port's GEMM takes "
                                  f"f32 and bf16 (ROADMAP A14 for f16)")
    return _DT[x.dtype]


def gemm(a, b, *, transpose_b=False, precision="default"):
    """A @ B (or A @ B^T with transpose_b) with f32 accumulation, in A's
    dtype."""
    m, k = a.shape
    n = b.shape[0] if transpose_b else b.shape[1]
    key = BrgemmKey(batch=1, m=m, n=n, k=k, dtype=_dt(a), beta0=True,
                    transpose_b=transpose_b, precision=precision)
    return global_cache().dispatch(key)(a.contiguous()[None],
                                        b.contiguous()[None])


def fused_mlp_layer(x, w, bias, *, activation="relu", precision="default"):
    """activation(x @ w + bias) as one kernel launch, in x's dtype."""
    m, k = x.shape
    key = BrgemmKey(batch=1, m=m, n=w.shape[1], k=k, dtype=_dt(x),
                    beta0=True, binary_kind="add", binary_bcast="bcast_col",
                    unary_kind=activation, precision=precision)
    return global_cache().dispatch(key)(x.contiguous()[None],
                                        w.contiguous()[None], None, bias)


__all__ = ["fused_mlp_layer", "gemm"]
