"""sink-reshape and the compile-time constant helpers the fusion passes use.

Copies from `tpp_mlir_tpu/passes/fold.py` (sink-reshape :100,
`_materialize_const` :366, `new_literal_const` :403) and
`tpp_mlir_tpu/passes/conv.py:28 _hoist_before`. `_materialize_const` makes
a non-literal constant with the port's numpy recipes (runtime/tensor_init),
since the reference's tensor_init module loads JAX; a packed constant stays
outside the slice (queue A13) and is not materialized.
"""

from __future__ import annotations

import numpy as np

from tpp_mlir_tpu.ir import Function, Module, TensorType, TppBuilder
from tpp_mlir_tpu.ir.core import walk_backward_slice
from tpp_mlir_tpu.ir.matcher import ELTWISE_BINARY, ELTWISE_UNARY

from ..runtime.tensor_init import tensor_init
from .pass_manager import Pass, register


def _sinkable_operand_shape(pre, post, bshape):
    """Shape for the small operand of eltwise(reshape(x: pre->post), b) when
    the eltwise can move into the pre-reshape domain, else None. Safe cases:
      - scalar b;
      - trailing-dim bias (K,) when both shapes end in K (the reshape
        preserves the minor axis);
      - NCHW channel bias (K,1,1) against post (N,K,P,Q) / pre (N,K,P*Q)
        -> (K,1)."""
    n = 1
    for d in bshape:
        n *= d
    if n == 1:
        return (1,) * max(1, len(pre))
    if bshape and bshape[-1] == n and len(pre) >= 1 and len(post) >= 1 \
            and pre[-1] == post[-1] == bshape[-1]:
        return (bshape[-1],)
    if len(post) == 4 and len(pre) == 3 and tuple(bshape) == (post[1], 1, 1) \
            and pre[:2] == post[:2] and pre[2] == post[2] * post[3]:
        return (post[1], 1)
    return None


@register
class SinkReshapePass(Pass):
    """eltwise(reshape(x), b) -> reshape(eltwise(x, b')): moves eltwise
    epilogues into the pre-reshape (GEMM) domain so xsmm-combine can fuse
    them into the contraction kernel (the imported models' bias-add ->
    reshape -> gelu chains). Runs to fixpoint so whole chains sink."""

    name = "sink-reshape"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        while self._round(func):
            changed = True
        return changed

    def _round(self, func: Function) -> bool:
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None:
                continue
            is_un = op.opname in ELTWISE_UNARY
            is_bin = op.opname in ELTWISE_BINARY
            if not (is_un or is_bin):
                continue
            # both operands reshaped from the same pre-shape (residual add
            # of two rewritten contractions): sink the binary below both
            if is_bin:
                o0, o1 = (v.owner for v in op.operands)
                if (o0 is not None and o1 is not None
                        and o0.opname == o1.opname == "tl.reshape"
                        and len(op.operands[0].uses) == 1
                        and len(op.operands[1].uses) == 1
                        and o0.operands[0].type.shape
                        == o1.operands[0].type.shape):
                    idx = func.ops.index(op)
                    start = len(func.ops)
                    y = b.binary(op.opname, o0.operands[0], o1.operands[0])
                    res = b.reshape(y, op.result.type.shape)
                    new_ops = func.ops[start:]
                    del func.ops[start:]
                    func.ops[idx:idx] = new_ops
                    func.replace_all_uses(op.result, res)
                    func.erase(op)
                    for ro in (o0, o1):
                        if not ro.result.uses:
                            func.erase(ro)
                    return True
            # find the full-shaped reshape operand (single-use, so the swap
            # is a move; sinking past a broadcast operand would ping-pong)
            ridx = None
            for i, v in enumerate(op.operands):
                o = v.owner
                if o is not None and o.opname == "tl.reshape" \
                        and len(v.uses) == 1 \
                        and tuple(v.type.shape) \
                        == tuple(op.result.type.shape):
                    ridx = i
                    break
            if ridx is None:
                continue
            rop = op.operands[ridx].owner
            pre = rop.operands[0].type.shape
            post = rop.result.type.shape
            if is_bin:
                other = op.operands[1 - ridx]
                bshape = _sinkable_operand_shape(pre, post, other.type.shape)
                if bshape is None:
                    continue
            idx = func.ops.index(op)
            start = len(func.ops)
            if is_un:
                y = b.unary(op.opname, rop.operands[0])
            else:
                b2 = other if tuple(other.type.shape) == tuple(bshape) \
                    else b.reshape(other, bshape)
                args = [rop.operands[0], b2] if ridx == 0 \
                    else [b2, rop.operands[0]]
                y = b.binary(op.opname, *args)
            res = b.reshape(y, post)
            new_ops = func.ops[start:]
            del func.ops[start:]
            func.ops[idx:idx] = new_ops
            func.replace_all_uses(op.result, res)
            func.erase(op)
            if not rop.result.uses:
                func.erase(rop)
            return True
        return False


def _hoist_before(func: Function, anchor, value) -> bool:
    """Move the producer slice of `value` before `anchor` if legal."""
    idx = {id(o): i for i, o in enumerate(func.ops)}
    apos = idx[id(anchor)]
    chain = [o for o in walk_backward_slice(value) if idx[id(o)] > apos]
    if not chain:
        return True
    # legality: the chain must not (transitively) depend on the anchor
    chain_ids = {id(o) for o in chain}
    for o in chain:
        for v in o.operands:
            if v.owner is not None and idx[id(v.owner)] > apos \
                    and id(v.owner) not in chain_ids:
                return False
            if v.owner is anchor:
                return False
    chain.sort(key=lambda o: idx[id(o)])
    for o in chain:
        func.ops.remove(o)
    pos = func.ops.index(anchor)
    func.ops[pos:pos] = chain
    return True


def _materialize_const(val, module):
    """numpy f32 array for a value computable from constants through
    reshape/transpose/broadcast, else None (the compile-time evaluation role
    of the reference's constant folding)."""
    op = val.owner
    if op is None:
        return None
    if op.opname == "tl.constant":
        if any(k.startswith("pack_") for k in op.attrs):
            return None             # packed recipes: queue A13
        if op.attrs.get("init") == "literal":
            arr = np.asarray(module.literals[op.attrs["literal"]])
        else:
            arr = tensor_init(op.attrs.get("init", "zero"),
                              op.attrs.get("orig_shape", val.type.shape),
                              val.type.dtype, op.attrs.get("seed", 0),
                              op.attrs.get("value", 1.0)).float().numpy()
        return np.asarray(arr, np.float32)
    if op.opname == "tl.reshape":
        a = _materialize_const(op.operands[0], module)
        return None if a is None else a.reshape(val.type.shape)
    if op.opname == "tl.transpose":
        a = _materialize_const(op.operands[0], module)
        return None if a is None else np.transpose(a, op.attrs["perm"])
    if op.opname == "tl.broadcast":
        a = _materialize_const(op.operands[0], module)
        if a is None:
            return None
        shp = (1,) * (len(val.type.shape) - a.ndim) + tuple(a.shape)
        return np.broadcast_to(a.reshape(shp), val.type.shape)
    return None


def new_literal_const(b, module, arr, shape, dtype):
    """Register `arr` as a module literal and emit a tl.constant for it: the
    compile-time-folded parameter (the folded array is the literal)."""
    key = f"fold{len(module.literals)}_c"
    while key in module.literals:
        key += "_"
    module.literals[key] = np.asarray(arr, np.float32).reshape(shape)
    return b.create("tl.constant", [],
                    [TensorType(tuple(shape), dtype)],
                    {"init": "literal", "literal": key}).result
