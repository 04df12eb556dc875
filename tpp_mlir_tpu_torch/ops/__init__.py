"""Functional ops over the kernel cache: the port of
`tpp_mlir_tpu/ops/__init__.py` (`gemm`, `brgemm`, `fused_mlp_layer`,
`blocked_matmul`, `conv2d_brgemm`, `relu`, `vnni_pack`), for callers that
want the kernels without the IR pipeline, with the JAX signatures
(`precision` in place of `interpret`: the device of the tensors decides).
gemm, brgemm and fused_mlp_layer dispatch a BrgemmKey (csrc/brgemm.cu, B1),
blocked_matmul a BlockedMatmulKey (csrc/blocked_matmul.cu, B19),
conv2d_brgemm a ConvBrgemmKey (csrc/conv.cu's channel-blocked entry, B23):
the kernel on CUDA tensors, the plain version on CPU tensors. `precision`
is the key's: "default" rounds f32 operands to bf16 (the compiled TPU
meaning), "highest" keeps true f32. `out_dtype` ("f32" or "bf16", default
the operands') is the result's; a C accumulator is added in f32."""

from __future__ import annotations

import torch

from ..runtime.tensor_init import vnni_pack_tensor
from ..xsmm.cache import global_cache
from ..xsmm.flags import BlockedMatmulKey, BrgemmKey, ConvBrgemmKey

_DT = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _dt(x: torch.Tensor) -> str:
    if x.dtype not in _DT:
        raise NotImplementedError(f"{x.dtype} operands: the port's GEMM takes "
                                  f"f32 and bf16 (ROADMAP A14 for f16)")
    return _DT[x.dtype]


def gemm(a, b, c=None, *, out_dtype=None, transpose_b=False,
         precision="default"):
    """C(+)= A @ B (or A @ B^T with transpose_b) with f32 accumulation."""
    m, k = a.shape
    n = b.shape[0] if transpose_b else b.shape[1]
    key = BrgemmKey(batch=1, m=m, n=n, k=k, dtype=_dt(a),
                    out_dtype=out_dtype, beta0=c is None,
                    transpose_b=transpose_b, precision=precision)
    return global_cache().dispatch(key)(a.contiguous()[None],
                                        b.contiguous()[None], c)


def brgemm(a, b, c=None, *, out_dtype=None, precision="default"):
    """Batch-reduce GEMM: C(+)= sum_i A[i] @ B[i]."""
    bt, m, k = a.shape
    key = BrgemmKey(batch=bt, m=m, n=b.shape[-1], k=k, dtype=_dt(a),
                    out_dtype=out_dtype, beta0=c is None,
                    precision=precision)
    return global_cache().dispatch(key)(a.contiguous(), b.contiguous(), c)


def fused_mlp_layer(x, w, bias=None, *, activation="relu", out_dtype=None,
                    precision="default"):
    """activation(x @ w + bias) as one kernel launch (the bias optional)."""
    m, k = x.shape
    key = BrgemmKey(batch=1, m=m, n=w.shape[1], k=k, dtype=_dt(x),
                    out_dtype=out_dtype, beta0=True,
                    binary_kind="add" if bias is not None else None,
                    binary_bcast="bcast_col", unary_kind=activation,
                    precision=precision)
    return global_cache().dispatch(key)(x.contiguous()[None],
                                        w.contiguous()[None], None, bias)


def blocked_matmul(a, b, c=None, *, vnni=0, bias=None, activation=None,
                   out_dtype=None, precision="default"):
    """Packed-layout matmul C[Mb,Nb,mb,nb] (+)= A[Mb,Kb,mb,kb] B[Nb,Kb,kb,nb]
    (B VNNI [Nb,Kb,kb/v,nb,v] with vnni=v), then activation(. + bias[Nb,nb]),
    in out_dtype (A's by default)."""
    Mb, Kb, mb, kb = a.shape
    Nb, nb = b.shape[0], b.shape[-2] if vnni else b.shape[-1]
    key = BlockedMatmulKey(Mb=Mb, Nb=Nb, Kb=Kb, mb=mb, nb=nb, kb=kb,
                           dtype=_dt(a), out_dtype=out_dtype, beta0=c is None,
                           vnni=vnni,
                           binary_kind="add" if bias is not None else None,
                           unary_kind=activation, precision=precision)
    return global_cache().dispatch(key)(a.contiguous(), b.contiguous(), c,
                                        bias)


def conv2d_brgemm(i, w, c=None, *, bias=None, activation=None,
                  strides=(1, 1), out_dtype=None, precision="default"):
    """Channel-blocked conv as BRGEMM: I[N,Cb,H,W,c] * W[Kb,Cb,R,S,c,k]
    (+ C) -> O[N,Kb,P,Q,k], then activation(. + bias[Kb,k]). Stride 1 only
    (a stride raises in the reference's words)."""
    N, Cb, H, Wd, cc = i.shape
    Kb, _, R, S, _, k = w.shape
    key = ConvBrgemmKey(N=N, H=H, W=Wd, Cb=Cb, c=cc, Kb=Kb, k=k, R=R, S=S,
                        stride_h=strides[0], stride_w=strides[1],
                        dtype=_dt(i), out_dtype=out_dtype, beta0=c is None,
                        binary_kind="add" if bias is not None else None,
                        unary_kind=activation, precision=precision)
    return global_cache().dispatch(key)(i.contiguous(), w.contiguous(), c,
                                        bias)


def relu(x):
    """max(x, 0): a PyTorch op (jnp.maximum in the JAX package)."""
    return torch.clamp_min(x, 0)


def vnni_pack(w, vf: int = 2):
    """[.., K, N] -> [.., K/vf, N, vf] (the reference's xsmm unary VNNI2): a
    PyTorch op."""
    return vnni_pack_tensor(w, vf)


__all__ = ["blocked_matmul", "brgemm", "conv2d_brgemm", "fused_mlp_layer",
           "gemm", "relu", "vnni_pack"]
