"""Deterministic tensor initializers (the TensorInit equivalent) and the
packed constants' recipe.

A copy of `tpp_mlir_tpu/runtime/tensor_init.py`: the same numpy recipes and
seeds, so both packages see the same values, and `apply_pack_recipe`
(:52-90), the pack a constant-fold-pack'ed constant records, as pure data
movement in torch (bit-identical to the reference's numpy moves). The reference makes bf16 with
`ml_dtypes` (and silently falls back to float32 without it); the port makes
every dtype by converting the float32 recipe with torch, whose float32 ->
bfloat16/float16 conversion rounds to nearest even like `ml_dtypes`, so the
two agree bit for bit. The result is a CPU tensor; callers move it.
"""

from __future__ import annotations

import numpy as np
import torch

INIT_KINDS = ("zero", "const", "simple", "cont", "rand", "normal", "identity")

TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16, "i32": torch.int32, "i8": torch.int8}


def tensor_init(kind: str, shape, dtype: str = "f32", seed: int = 0,
                value: float = 1.0) -> torch.Tensor:
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    if kind == "zero":
        out = np.zeros(n, np.float32)
    elif kind == "const":
        out = np.full(n, value, np.float32)
    elif kind == "simple":
        # cyclic 0.3/0.6/0.9 pattern
        out = ((np.arange(n) % 3 + 1) * 0.3).astype(np.float32)
    elif kind == "cont":
        out = (np.arange(n, dtype=np.float32) / max(n, 1))
    elif kind == "rand":
        out = np.random.default_rng(seed).random(n, np.float32)
    elif kind == "normal":
        out = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    elif kind == "identity":
        assert len(shape) == 2 and shape[0] == shape[1]
        out = np.eye(shape[0], dtype=np.float32)
    else:
        raise ValueError(f"unknown init kind {kind!r} "
                         f"(expected one of {INIT_KINDS})")
    return torch.from_numpy(out.reshape(shape)).to(
        TORCH_DTYPES.get(dtype, torch.float32))


def to_torch(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy array from the JAX side as a torch tensor on `device`.
    `ml_dtypes.bfloat16` arrays are carried bit for bit: viewed as 16-bit
    integers, then reinterpreted as torch.bfloat16."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def pack_tensor(x: torch.Tensor, inner_dims, inner_tiles,
                outer_perm=None) -> torch.Tensor:
    """tl.pack: each dim d in inner_dims splits into (d / t, t); the outer
    dims go first (in outer_perm's order), then the tiles in inner_dims'
    order (tpp_mlir_tpu/runtime/executor.py:243 _pack_val)."""
    dims, tiles = tuple(inner_dims), tuple(inner_tiles)
    split, tile_axes, outer_positions = [], {}, []
    for i, d in enumerate(x.shape):
        outer_positions.append(len(split))
        if i in dims:
            t = tiles[dims.index(i)]
            tile_axes[i] = len(split) + 1
            split.extend([d // t, t])
        else:
            split.append(d)
    order = list(range(x.ndim))
    if outer_perm:
        order = [order[p] for p in outer_perm]
    perm = [outer_positions[i] for i in order] + [tile_axes[i] for i in dims]
    return x.reshape(split).permute(*perm).contiguous()


def unpack_tensor(x: torch.Tensor, inner_dims, out_shape,
                  outer_perm=None) -> torch.Tensor:
    """tl.unpack, the inverse of pack_tensor (executor.py:269 _unpack_val)."""
    dims = tuple(inner_dims)
    n_out = len(out_shape)
    order_outer = list(range(n_out))
    if outer_perm:
        order_outer = [0] * len(outer_perm)
        for i, p in enumerate(outer_perm):
            order_outer[p] = i
    tr = []
    for i in range(n_out):
        tr.append(order_outer[i])
        if i in dims:
            tr.append(n_out + dims.index(i))
    return x.permute(*tr).reshape(tuple(out_shape)).contiguous()


def vnni_pack_tensor(x: torch.Tensor, vf: int = 2) -> torch.Tensor:
    """[..., K, N] -> [..., K/vf, N, vf] (tl.vnni_pack, xsmm unary vnni2)."""
    *lead, K, N = x.shape
    return x.reshape(*lead, K // vf, vf, N).movedim(-2, -1).contiguous()


def apply_pack_recipe(x: torch.Tensor, attrs: dict) -> torch.Tensor:
    """A constant's folded pack recipe (constant-fold-pack's `pack_*`
    attributes): the tl.pack, then the tl.vnni_pack, as recorded."""
    if "pack_inner_dims" in attrs:
        x = pack_tensor(x, attrs["pack_inner_dims"],
                        attrs["pack_inner_tiles"],
                        attrs.get("pack_outer_perm"))
    if "pack_vnni" in attrs:
        x = vnni_pack_tensor(x, attrs["pack_vnni"])
    return x
