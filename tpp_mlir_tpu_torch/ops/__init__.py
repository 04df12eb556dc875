"""Functional ops over the kernel cache: the port of the GEMM and packed
parts of `tpp_mlir_tpu/ops/__init__.py` (`gemm`, `fused_mlp_layer`,
`blocked_matmul`, `conv2d_brgemm`, `vnni_pack`), for callers that want the
kernels without the IR pipeline. gemm and fused_mlp_layer dispatch a
BrgemmKey (csrc/brgemm.cu), blocked_matmul a BlockedMatmulKey
(csrc/blocked_matmul.cu, B19), conv2d_brgemm a ConvBrgemmKey (csrc/conv.cu's
channel-blocked entry, B23): the kernel on CUDA tensors, the plain version
on CPU tensors. `precision` is the key's: "default" rounds f32 operands to
bf16 (the compiled TPU meaning), "highest" keeps true f32."""

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


def vnni_pack(w, vf: int = 2):
    """[.., K, N] -> [.., K/vf, N, vf] (the reference's xsmm unary VNNI2): a
    PyTorch op."""
    return vnni_pack_tensor(w, vf)


__all__ = ["blocked_matmul", "conv2d_brgemm", "fused_mlp_layer", "gemm",
           "vnni_pack"]
