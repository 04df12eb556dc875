"""Cleanup: canonicalize + CSE + DCE.

A copy of `tpp_mlir_tpu/passes/cleanup.py` (see pass_manager.py for why the
port copies its passes).
"""

from __future__ import annotations

from ..ir import Function, Module
from .pass_manager import Pass, register

# Ops with side effects that DCE must keep even when unused.
SIDE_EFFECT_OPS = ("check.expect_true", "check.expect_almost_eq",
                   "check.expect_sane", "perf.sink", "perf.timer_start",
                   "perf.timer_stop")


def _attr_key(attrs: dict):
    return tuple(sorted((k, v if not isinstance(v, list) else tuple(v))
                        for k, v in attrs.items()))


@register
class CleanupPass(Pass):
    """canonicalize + cse + dce to fixpoint."""

    name = "cleanup"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        while self._round(func):
            changed = True
        return changed

    def _round(self, func: Function) -> bool:
        return bool(self._canonicalize(func) | self._cse(func)
                    | self._dce(func))

    # -- canonicalization patterns ----------------------------------------
    def _canonicalize(self, func: Function) -> bool:
        changed = False
        for op in list(func.ops):
            if op.parent is None:
                continue
            # identity(x) -> x
            if op.opname == "tl.identity" and op.result.type == op.operands[0].type:
                func.replace_all_uses(op.result, op.operands[0])
                func.erase(op)
                changed = True
                continue
            # cast to same dtype -> x
            if op.opname == "tl.cast" and op.result.type == op.operands[0].type:
                func.replace_all_uses(op.result, op.operands[0])
                func.erase(op)
                changed = True
                continue
            # transpose(transpose(x)) with inverse perms -> x
            if op.opname == "tl.transpose":
                inner = op.operands[0].owner
                if inner is not None and inner.opname == "tl.transpose":
                    p1 = inner.attrs["perm"]
                    p2 = op.attrs["perm"]
                    if tuple(p1[p] for p in p2) == tuple(range(len(p1))):
                        func.replace_all_uses(op.result, inner.operands[0])
                        func.erase(op)
                        changed = True
                        continue
            # reshape(reshape(x)) -> reshape(x)
            if op.opname == "tl.reshape":
                inner = op.operands[0].owner
                if inner is not None and inner.opname == "tl.reshape":
                    op.set_operand(0, inner.operands[0])
                    changed = True
                    continue
                if op.result.type == op.operands[0].type:
                    func.replace_all_uses(op.result, op.operands[0])
                    func.erase(op)
                    changed = True
                    continue
            # fill/zero on a fill/zero dest: keep outermost only
            if op.opname in ("tl.fill", "tl.zero"):
                inner = op.operands[0].owner
                if inner is not None and inner.opname in ("tl.fill", "tl.zero") \
                        and len(inner.result.uses) == 1:
                    op.set_operand(0, inner.operands[0])
                    changed = True
                    continue
        return changed

    # -- common subexpression elimination ---------------------------------
    def _cse(self, func: Function) -> bool:
        changed = False
        seen: dict = {}
        for op in list(func.ops):
            if op.parent is None or op.opname in SIDE_EFFECT_OPS:
                continue
            # constants with init="rand"/"normal" are deterministic per seed,
            # so they are CSE-able too.
            key = (op.opname, tuple(id(v) for v in op.operands),
                   _attr_key(op.attrs),
                   tuple(r.type for r in op.results))
            prev = seen.get(key)
            if prev is None:
                seen[key] = op
                continue
            for old, new in zip(op.results, prev.results):
                func.replace_all_uses(old, new)
            func.erase(op)
            changed = True
        return changed

    # -- dead code elimination --------------------------------------------
    def _dce(self, func: Function) -> bool:
        changed = False
        live = True
        while live:
            live = False
            for op in reversed(list(func.ops)):
                if op.opname in SIDE_EFFECT_OPS:
                    continue
                if all(not r.uses for r in op.results) and \
                        not any(r in func.returns for r in op.results):
                    func.erase(op)
                    changed = live = True
        return changed
