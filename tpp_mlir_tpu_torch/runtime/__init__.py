"""Executor, timing and tensor init of the port."""

from .executor import compile
from .perf import BenchResult, bench
from .tensor_init import tensor_init, to_torch

__all__ = ["BenchResult", "bench", "compile", "tensor_init", "to_torch"]
