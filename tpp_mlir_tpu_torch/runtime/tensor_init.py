"""Deterministic tensor initializers (the TensorInit equivalent).

A copy of `tpp_mlir_tpu/runtime/tensor_init.py`: the same numpy recipes and
seeds, so both packages see the same values. The reference makes bf16 with
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
