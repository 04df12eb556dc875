"""Tensor types for the IR.

Equivalent role to MLIR's RankedTensorType as used by the reference's
linalg-level IR (reference: include/TPP/Dialect, SURVEY.md section 2.1).
Only static shapes are supported: XLA/Mosaic compile static shapes, and the
reference's pipeline also rejects dynamic shapes for xsmm mapping
(reference lib/TPP/Conversion/ConvertLinalgToXsmm.cpp checkStructure).
"""

from __future__ import annotations

from dataclasses import dataclass

# Supported element types. 'bf16' is the native MXU reduced-precision type on
# TPU (the VNNI-2/4 CPU layouts of the reference map to it, SURVEY.md 2.3
# PackVNNI); f32 accumulate always.
_DTYPES = ("f32", "bf16", "f16", "i32", "i8", "i64", "i1")

_NUMPY_NAMES = {
    "f32": "float32",
    "bf16": "bfloat16",
    "f16": "float16",
    "i32": "int32",
    "i8": "int8",
    "i64": "int64",
    "i1": "bool",
}


@dataclass(frozen=True)
class TensorType:
    """A ranked, statically-shaped tensor type."""

    shape: tuple[int, ...]
    dtype: str = "f32"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if not all(isinstance(d, int) and d >= 0 for d in self.shape):
            raise ValueError(f"shape must be static non-negative ints: {self.shape}")
        object.__setattr__(self, "shape", tuple(self.shape))

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def numpy_dtype(self) -> str:
        return _NUMPY_NAMES[self.dtype]

    def with_shape(self, shape) -> "TensorType":
        return TensorType(tuple(shape), self.dtype)

    def __str__(self) -> str:
        dims = "x".join(str(d) for d in self.shape)
        return f"tensor<{dims}x{self.dtype}>" if dims else f"tensor<{self.dtype}>"


def parse_type(text: str) -> TensorType:
    """Parse 'tensor<256x1024xf32>' into a TensorType."""
    text = text.strip()
    if not (text.startswith("tensor<") and text.endswith(">")):
        raise ValueError(f"bad tensor type: {text!r}")
    body = text[len("tensor<"):-1]
    parts = body.split("x")
    # dtype is the last part; dims are the leading integer parts.
    dtype = parts[-1]
    dims = tuple(int(p) for p in parts[:-1])
    return TensorType(dims, dtype)
