"""SSA IR core: Value, Operation, Function, Module, Builder.

This plays the role MLIR plays for the reference (funcs of linalg/xsmm ops in
SSA destination-passing style). It is deliberately small: a function is a flat
list of operations; each op has operands (Values), a result list, and an
attribute dict. Rewrites mutate the list through RewriteContext helpers, so
passes look like the reference's pattern rewrites
(reference: lib/TPP/Transforms/*, SURVEY.md section 2.3).
"""

from __future__ import annotations

import itertools
from typing import Any, Optional

from .types import TensorType


class Value:
    """An SSA value: function argument or op result."""

    __slots__ = ("type", "name", "owner", "index", "uses")

    def __init__(self, type: TensorType, name: str = "", owner: Optional["Operation"] = None,
                 index: int = 0):
        self.type = type
        self.name = name
        self.owner = owner          # defining Operation, or None for block args
        self.index = index          # result index within owner
        self.uses: list[tuple[Operation, int]] = []

    @property
    def is_block_arg(self) -> bool:
        return self.owner is None

    def __repr__(self):
        return f"%{self.name}: {self.type}"


class Operation:
    """A single operation: results = opname(operands) {attrs}."""

    __slots__ = ("opname", "operands", "results", "attrs", "parent")

    def __init__(self, opname: str, operands: list[Value],
                 result_types: list[TensorType], attrs: dict[str, Any] | None = None):
        self.opname = opname
        self.operands: list[Value] = list(operands)
        self.attrs: dict[str, Any] = dict(attrs or {})
        self.results = [Value(t, owner=self, index=i) for i, t in enumerate(result_types)]
        self.parent: Optional[Function] = None
        for i, v in enumerate(self.operands):
            v.uses.append((self, i))

    # -- operand management ------------------------------------------------
    def set_operand(self, index: int, new: Value) -> None:
        old = self.operands[index]
        old.uses.remove((self, index))
        self.operands[index] = new
        new.uses.append((self, index))

    def drop_uses(self) -> None:
        for i, v in enumerate(self.operands):
            try:
                v.uses.remove((self, i))
            except ValueError:
                pass

    @property
    def result(self) -> Value:
        assert len(self.results) == 1, f"{self.opname} has {len(self.results)} results"
        return self.results[0]

    def __repr__(self):
        return f"<{self.opname} @{id(self):x}>"


class Function:
    """A function: named block args, op list, and returned values."""

    def __init__(self, name: str, arg_types: list[TensorType],
                 arg_names: list[str] | None = None):
        self.name = name
        names = arg_names or [f"arg{i}" for i in range(len(arg_types))]
        self.args = [Value(t, name=n) for t, n in zip(arg_types, names)]
        self.ops: list[Operation] = []
        self.returns: list[Value] = []
        self.attrs: dict[str, Any] = {}
        self.module: "Module | None" = None

    def append(self, op: Operation) -> Operation:
        op.parent = self
        self.ops.append(op)
        return op

    def insert_before(self, anchor: Operation, op: Operation) -> Operation:
        op.parent = self
        self.ops.insert(self.ops.index(anchor), op)
        return op

    def erase(self, op: Operation) -> None:
        for r in op.results:
            if r.uses:
                raise ValueError(f"erasing {op.opname} with live uses")
            # returns are an ESCAPE that .uses does not record: erasing a
            # returned op would leave the function returning an undefined
            # value, caught only at the next verify, far from the cause
            if any(v is r for v in self.returns):
                raise ValueError(
                    f"erasing {op.opname} whose result is returned")
        op.drop_uses()
        self.ops.remove(op)
        op.parent = None

    def replace_all_uses(self, old: Value, new: Value) -> None:
        for op, idx in list(old.uses):
            op.set_operand(idx, new)
        self.returns = [new if v is old else v for v in self.returns]

    def verify(self) -> None:
        from . import ops as _ops  # late import; op verifiers live there

        defined: set[int] = {id(a) for a in self.args}
        for op in self.ops:
            for v in op.operands:
                if id(v) not in defined:
                    raise ValueError(
                        f"{self.name}: op '{op.opname}' uses value %{v.name} "
                        f"before definition")
            _ops.verify_op(op)
            for r in op.results:
                defined.add(id(r))
        for v in self.returns:
            if id(v) not in defined:
                raise ValueError(f"{self.name}: returns undefined value")

    def __str__(self):
        from .printer import print_function

        return print_function(self)


class Module:
    """Top-level container of functions plus module attributes.

    Module attrs carry what the reference carries via DLTI / metadata comments
    (e.g. 'flops' from the generator -> BENCH_TOTAL_FLOPS,
    reference tools/mlir-gen/MLIRGen.cpp:300-334).
    """

    def __init__(self):
        self.funcs: dict[str, Function] = {}
        self.attrs: dict[str, Any] = {}
        # named literal tensors for tl.constant {init="literal"}: in-memory
        # payloads (e.g. imported torch weights). The textual form references
        # them by name only; they do not survive print/parse round-trips.
        self.literals: dict[str, Any] = {}

    def add(self, func: Function) -> Function:
        self.funcs[func.name] = func
        func.module = self
        return func

    def __getitem__(self, name: str) -> Function:
        return self.funcs[name]

    def verify(self) -> None:
        for f in self.funcs.values():
            f.verify()

    def __str__(self):
        from .printer import print_module

        return print_module(self)


class Builder:
    """Appends ops to a function and names results."""

    def __init__(self, func: Function):
        self.func = func
        hi = -1
        for op in func.ops:
            for r in op.results:
                if r.name.isdigit():
                    hi = max(hi, int(r.name))
        self._counter = itertools.count(hi + 1)

    def _name(self) -> str:
        return str(next(self._counter))

    def create(self, opname: str, operands: list[Value],
               result_types: list[TensorType], attrs: dict[str, Any] | None = None,
               ) -> Operation:
        op = Operation(opname, operands, result_types, attrs)
        for r in op.results:
            r.name = self._name()
        self.func.append(op)
        return op

    def ret(self, *values: Value) -> None:
        self.func.returns = list(values)


def topo_index(func: Function) -> dict[int, int]:
    """Map id(op) -> position, for dominance-ordered queries."""
    return {id(op): i for i, op in enumerate(func.ops)}


def walk_backward_slice(value: Value, limit: int | None = None) -> list[Operation]:
    """Producer chain of a value (the reference's backward-slice utility,
    lib/TPP/Transforms/Utils/TransformUtils.h)."""
    out: list[Operation] = []
    seen: set[int] = set()
    stack = [value]
    while stack:
        v = stack.pop()
        op = v.owner
        if op is None or id(op) in seen:
            continue
        seen.add(id(op))
        out.append(op)
        if limit is not None and len(out) >= limit:
            break
        stack.extend(op.operands)
    return out
