"""Megatron-sharded multi-head attention over a (dp, tp) mesh: the port of
`tpp_mlir_tpu/parallel/transformer.py`.

Heads split over tp: the Q/K/V projections are column-parallel (each rank
holds heads/tp whole heads' columns), the attention core runs on the rank's
heads alone (B7, csrc/attention.cu, at heads/tp with the kernels on; the
composed attention off), and the output projection is row-parallel with one
all-reduce of its f32 partial product. The batch splits over dp. The
forward works on this rank's shards (`shard_tree` with `mha_param_specs`,
the batch with P("dp")).
"""

from __future__ import annotations

import numpy as np
import torch

from ..serving.engine import _f32mm, composed_causal_attention
from ..utils.target import resolve_device
from ..xsmm import FlashMhaKey, global_cache
from .collectives import row_parallel_psum
from .mesh import P, as_mesh
from .train import _DTYPES, numpy_leaf

_KEY_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def mha_params(embed: int, heads: int, dtype="float32", seed: int = 0,
               device="cuda") -> dict:
    """(wq, wk, wv, wo) ~ N(0, 1/embed) and zero biases, as the JAX
    mha_params makes them; the numbers come from numpy's default_rng(seed),
    not jax.random (carry JAX weights with `mha_params_from_numpy`)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    dt = _DTYPES[dtype]
    out = {}
    for name in ("wq", "wk", "wv", "wo"):
        w = rng.standard_normal((embed, embed), dtype=np.float32) \
            * np.float32(np.sqrt(1.0 / embed))
        out[name] = torch.from_numpy(w).to(device=device, dtype=dt)
    for name in ("bq", "bk", "bv", "bo"):
        out[name] = torch.zeros(embed, dtype=dt, device=device)
    return out


def mha_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The JAX mha_params' dict passed as numpy arrays, bit for bit."""
    device = resolve_device(device)
    return {k: numpy_leaf(v, device) for k, v in tree.items()}


def mha_param_specs(dp_axis: str = "dp", tp_axis: str = "tp") -> dict:
    """QKV column-parallel (heads on tp), the out projection row-parallel."""
    col = P(None, tp_axis)
    return {"wq": col, "wk": col, "wv": col, "wo": P(tp_axis, None),
            "bq": P(tp_axis), "bk": P(tp_axis), "bv": P(tp_axis), "bo": P()}


def make_mha_forward(mesh, embed: int, heads: int, scale: float | None = None,
                     causal: bool = False, dp_axis: str = "dp",
                     tp_axis: str = "tp", use_kernels: bool | None = None):
    """Return `forward(params, x) -> out` on this rank's shards: x (batch/dp,
    seq, embed), params by `mha_param_specs`; out (batch/dp, seq, embed),
    replicated over tp. use_kernels (the JAX `use_pallas`) defaults to x
    being on CUDA: B7 at the rank's heads/tp heads."""
    mesh = as_mesh(mesh)
    ntp = mesh.size(tp_axis)
    if heads % ntp:
        raise ValueError(f"heads {heads} do not split over tp {ntp}")
    h_local, D = heads // ntp, embed // heads
    att_scale = scale if scale is not None else D ** -0.5
    tp = mesh.group(tp_axis)

    def forward(params, x):
        B, S, _ = x.shape
        flat = x.reshape(B * S, embed)

        def proj(w, b):
            return (_f32mm(flat, w) + b.float()).to(x.dtype).reshape(B, S, -1)

        q, k, v = (proj(params[w], params[b])
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        kernels = x.is_cuda if use_kernels is None else use_kernels
        if kernels:
            key = FlashMhaKey(batch=B, seq=S, seq_kv=S, head_dim=D,
                              heads=h_local, dtype=_KEY_DTYPES[x.dtype],
                              scale=att_scale, causal=causal)
            att = global_cache().dispatch(key)(q, k, v)
        else:
            att = composed_causal_attention(
                *(t.reshape(B, S, h_local, D) for t in (q, k, v)),
                att_scale, causal=causal).reshape(B, S, -1).to(x.dtype)
        # row-parallel out projection: local contraction + ONE sum over tp
        z = row_parallel_psum(_f32mm(att.reshape(B * S, -1), params["wo"]),
                              tp)
        return (z + params["bo"].float()).to(x.dtype).reshape(B, S, embed)

    return forward
