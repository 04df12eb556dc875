"""Pass manager and pass registry of the port.

A copy of `tpp_mlir_tpu/passes/pass_manager.py` with a registry of its own:
importing anything under `tpp_mlir_tpu.passes` loads JAX (its chain and
tile passes import TPU gates from `xsmm/kernels.py`), so the port carries
the passes its slice needs and registers them here.
"""

from __future__ import annotations

from typing import Callable, Iterable

from ..ir import Function, Module

_REGISTRY: dict[str, type["Pass"]] = {}
_PIPELINES: dict[str, Callable[[], list[str]]] = {}


class Pass:
    """A module transform. Subclasses set `name` and implement
    run_on_function()."""

    name = "<abstract>"

    def run(self, module: Module) -> bool:
        """Return True if the IR changed."""
        changed = False
        for f in module.funcs.values():
            changed |= bool(self.run_on_function(f, module))
        return changed

    def run_on_function(self, func: Function, module: Module) -> bool:
        raise NotImplementedError


def register(cls):
    """Class decorator: register a Pass subclass under its .name."""
    _REGISTRY[cls.name] = cls
    return cls


def register_pipeline(name: str):
    """Decorator for a function returning a list of pass/pipeline names."""
    def deco(fn):
        _PIPELINES[name] = fn
        return fn
    return deco


def expand_pipeline(name: str) -> list[Pass]:
    if name in _PIPELINES:
        return [p for item in _PIPELINES[name]()
                for p in expand_pipeline(item)]
    if name not in _REGISTRY:
        raise KeyError(f"unknown pass or pipeline '{name}' (available: "
                       f"{', '.join(sorted({*_REGISTRY, *_PIPELINES}))})")
    return [_REGISTRY[name]()]


class PassManager:
    """Runs passes in order and verifies the module after each."""

    def __init__(self, names: Iterable[str]):
        self.passes = [p for n in names for p in expand_pipeline(n)]

    def run(self, module: Module) -> Module:
        for p in self.passes:
            p.run(module)
            try:
                module.verify()
            except ValueError as e:
                raise ValueError(f"verification failed after pass "
                                 f"'{p.name}': {e}") from e
        return module


def run_pipeline(module: Module, *names: str) -> Module:
    return PassManager(names).run(module)
