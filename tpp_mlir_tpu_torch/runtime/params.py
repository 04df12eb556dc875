"""Weights carried across: a module's literals as tensors on the device.

An imported model (`frontend/`, e.g. `models/gpt.py`) keeps its
weights in `module.literals` (numpy, f32), and passes such as qkv-merge add
folded ones (the concatenated QKV weights). A `tl.constant` with
`init = "literal"` names one. The JAX package makes it
`jnp.asarray(arr).astype(dtype)` (`tpp_mlir_tpu/runtime/executor.py:55-61`):
numpy float64 becomes float32 first (JAX's default), then one
round-to-nearest-even conversion to the IR dtype. torch's float32 ->
bfloat16 and float32 -> float16 conversions round the same way, so both
packages hold the same bits.
A packed constant (constant-fold-pack's `pack_*` attributes) applies its
recipe to the literal first, as the reference does (:58): the weights are
packed once, here, outside any timed loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir import Module
from ..ir.types import TensorType
from ..utils.target import resolve_device
from .tensor_init import TORCH_DTYPES, apply_pack_recipe


def literal_tensor(module: Module, name: str, type: TensorType,
                   device: str | torch.device = "cuda",
                   recipe: dict | None = None) -> torch.Tensor:
    """`module.literals[name]` as a tensor of `type` on `device`, packed by
    `recipe` (a tl.constant's attributes) where it names a pack."""
    device = resolve_device(device)
    arr = np.asarray(module.literals[name])
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if type.dtype not in TORCH_DTYPES:     # f32, bf16, f16, i32, i8
        raise ValueError(f"literal dtype {type.dtype} is not one the port "
                         f"holds: {sorted(TORCH_DTYPES)}")
    t = apply_pack_recipe(torch.from_numpy(np.ascontiguousarray(arr)),
                          recipe or {})
    if tuple(t.shape) != type.shape:
        raise ValueError(f"literal {name} has shape {tuple(t.shape)}, the "
                         f"IR says {type.shape}")
    return t.to(TORCH_DTYPES[type.dtype]).to(device)


def module_params(module: Module, device: str | torch.device = "cuda"
                  ) -> dict[str, torch.Tensor]:
    """Every literal a `tl.constant` of the module names, as a tensor at
    that constant's IR type (packed, for a packed constant) on `device`."""
    device = resolve_device(device)
    out: dict[str, torch.Tensor] = {}
    for func in module.funcs.values():
        for op in func.ops:
            if op.opname == "tl.constant" and op.attrs.get("init") == \
                    "literal" and op.attrs["literal"] not in out:
                out[op.attrs["literal"]] = literal_tensor(
                    module, op.attrs["literal"], op.results[0].type, device,
                    op.attrs)
    return out
