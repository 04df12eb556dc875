"""Tensor IR: types, SSA core, ops, printer/parser, matcher DSL.

The port's own copy of `tpp_mlir_tpu/ir/` (the port imports nothing of the
JAX package), without the jnp dtype map and the jnp `tl.generic` evaluator.
`tests/test_torch_ir.py` holds the copy to the original."""

from .core import Builder, Function, Module, Operation, Value
from .ops import (ALL_OPS, BCAST_FLAGS, BINARY_KINDS, GEMM_FLAGS, I64,
                  UNARY_KINDS, TppBuilder, broadcast_shapes, verify_op)
from .parser import ParseError, parse_function, parse_module
from .printer import print_function, print_module, print_op
from .types import TensorType, parse_type

__all__ = [
    "Builder", "Function", "Module", "Operation", "Value",
    "ALL_OPS", "BCAST_FLAGS", "BINARY_KINDS", "GEMM_FLAGS", "I64",
    "UNARY_KINDS", "TppBuilder", "broadcast_shapes", "verify_op",
    "ParseError", "parse_function", "parse_module",
    "print_function", "print_module", "print_op",
    "TensorType", "parse_type",
]
