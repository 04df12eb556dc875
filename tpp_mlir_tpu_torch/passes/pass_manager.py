"""Pass manager and pass registry of the port.

A copy of `tpp_mlir_tpu/passes/pass_manager.py` with a registry of its own:
importing anything under `tpp_mlir_tpu.passes` loads JAX (its chain and
tile passes import TPU gates from `xsmm/kernels.py`), so the port carries
the passes it runs and registers them here. Passes are registered by
flag-style name and take options (`make_pass("split-reduction-dim",
tile=256)`); pipelines are named sequences that may take options too
(`expand_pipeline("tpp-mapping", pack=True)`); the manager verifies the
module after each pass and can print it (`tpp-opt --print-after`).
"""

from __future__ import annotations

import sys
from typing import Callable, Iterable

from ..ir import Function, Module

_REGISTRY: dict[str, type["Pass"]] = {}
_PIPELINES: dict[str, Callable[..., list]] = {}


class Pass:
    """A module transform. Subclasses set `name` and implement
    run_on_function(); `options` are the keyword options it was made
    with."""

    name = "<abstract>"

    def __init__(self, **options):
        self.options = options

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
    """Decorator for a function options -> list of pass/pipeline names or
    Pass instances."""
    def deco(fn):
        _PIPELINES[name] = fn
        return fn
    return deco


def make_pass(name: str, **options) -> Pass:
    if name not in _REGISTRY:
        raise KeyError(f"unknown pass or pipeline '{name}' (available: "
                       f"{', '.join(sorted({*_REGISTRY, *_PIPELINES}))})")
    return _REGISTRY[name](**options)


def available_passes() -> list[str]:
    return sorted(_REGISTRY)


def available_pipelines() -> list[str]:
    return sorted(_PIPELINES)


def expand_pipeline(name: str, **options) -> list[Pass]:
    """The passes of a pipeline (its options passed to its function), or
    the one pass `name` made with `options`."""
    if name in _PIPELINES:
        out: list[Pass] = []
        for item in _PIPELINES[name](**options):
            out.extend([item] if isinstance(item, Pass)
                       else expand_pipeline(item))
        return out
    return [make_pass(name, **options)]


class PassManager:
    """Runs passes in order; verifies the module after each (verify_each)
    and prints it after each to `print_stream` (print_after)."""

    def __init__(self, passes: Iterable[Pass | str] = (),
                 print_after: bool = False, verify_each: bool = True,
                 print_stream=None):
        self.passes: list[Pass] = []
        for p in passes:
            self.add(p)
        self.print_after = print_after
        self.verify_each = verify_each
        self.print_stream = print_stream or sys.stderr

    def add(self, p: Pass | str, **options) -> "PassManager":
        if isinstance(p, str):
            self.passes.extend(expand_pipeline(p, **options))
        else:
            self.passes.append(p)
        return self

    def run(self, module: Module) -> Module:
        for p in self.passes:
            p.run(module)
            if self.verify_each:
                try:
                    module.verify()
                except ValueError as e:
                    raise ValueError(f"verification failed after pass "
                                     f"'{p.name}': {e}") from e
            if self.print_after:
                print(f"// ----- IR after {p.name} -----",
                      file=self.print_stream)
                print(module, file=self.print_stream)
        return module


def run_pipeline(module: Module, *names: str, **kw) -> Module:
    return PassManager(names, **kw).run(module)
