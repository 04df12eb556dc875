"""Folding and normal-form passes at the tensor level, and the compile-time
constant helpers the fusion passes use.

Copies from `tpp_mlir_tpu/passes/fold.py`:
  fold-add-into-dest  (:20) add(contraction(A, B, zero), other) ->
                      contraction(A, B, other), the addend as accumulator;
  sink-reshape        (:100) eltwise epilogues sink below reshapes;
  sink-transpose      (:185) transposes cancel, and sink below eltwise ops
                      and pads, so conv-to-nhwc's layout conversions survive
                      only at the graph's boundary;
  fold-const-scale    (:419) constant per-channel scales (an imported
                      BatchNorm) fold into the conv weight;
  decompose-softmax   (:573) tl.softmax -> reduce max, sub, exp, reduce
                      sum, div;
with `_materialize_const` (:366), `new_literal_const` (:403) and
`tpp_mlir_tpu/passes/conv.py:28 _hoist_before`. `_materialize_const` makes
a non-literal constant with the port's numpy recipes (runtime/tensor_init),
since the reference's tensor_init module loads JAX, and applies a packed
constant's recipe (apply_pack_recipe) as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir import Function, Module, TensorType, TppBuilder
from ..ir.core import walk_backward_slice
from ..ir.matcher import ELTWISE_BINARY, ELTWISE_UNARY, is_zero_op
from ..runtime.tensor_init import apply_pack_recipe, tensor_init
from .pass_manager import Pass, register


# contractions whose third operand is the accumulator C
_DEST_CONTRACTIONS = frozenset({
    "tl.matmul", "tl.batch_matmul", "tl.brgemm", "tl.vnni_brgemm",
    "tl.blocked_matmul", "tl.conv2d_nchw_fchw", "tl.conv2d_nhwc_hwcf",
    "tl.blocked_conv2d"})


@register
class FoldAddIntoDestPass(Pass):
    name = "fold-add-into-dest"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.add":
                continue
            a, b = op.operands
            if a.type != b.type:
                continue  # broadcasting add is a bias, not a dest-fold
            for contraction_val, other in ((a, b), (b, a)):
                c_op = contraction_val.owner
                if c_op is None or c_op.opname not in _DEST_CONTRACTIONS \
                        or len(contraction_val.uses) != 1:
                    continue
                dest = c_op.operands[2]
                if not is_zero_op(dest.owner) or len(dest.uses) != 1:
                    continue
                # `other` must dominate the contraction it becomes the
                # accumulator of; hoist its producer slice above the
                # contraction when legal (same as conv-init-simplify), else
                # skip — rewiring without this creates use-before-def.
                if other.owner is not None and \
                        not _hoist_before(func, c_op, other):
                    continue
                # Rewire: contraction accumulates into `other` directly.
                c_op.set_operand(2, other)
                func.replace_all_uses(op.result, contraction_val)
                func.erase(op)
                changed = True
                break
        return changed


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


def _inv_perm(perm):
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


@register
class SinkTransposePass(Pass):
    """Transpose propagation/cancellation (the layout-propagation role of
    the reference's PropagatePackUnPack, ToBlockLayoutAndBack.cpp:682-856,
    for the pure transposes conv-to-nhwc introduces):

      * transpose(transpose(x, p1), p2) -> x (or one composed transpose);
      * eltwise(transpose(x, p), b)  -> transpose(eltwise(x, b'), p) where
        b' = transpose(right_align(b), inv(p)) — transposes distribute over
        elementwise ops, so epilogues sink into the NHWC domain and the
        conversion transposes of adjacent convs cancel at the seam.

    Runs to fixpoint; after it, layout conversions survive only at graph
    boundaries."""

    name = "sink-transpose"

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
            # cancellation: transpose of transpose
            if op.opname == "tl.transpose":
                src = op.operands[0].owner
                if src is not None and src.opname == "tl.transpose":
                    p1 = tuple(src.attrs["perm"])
                    p2 = tuple(op.attrs["perm"])
                    composed = tuple(p1[i] for i in p2)
                    if composed == tuple(range(len(composed))):
                        func.replace_all_uses(op.result, src.operands[0])
                        func.erase(op)
                        if not src.result.uses:
                            func.erase(src)
                        return True
                    idx = func.ops.index(op)
                    start = len(func.ops)
                    y = b.transpose(src.operands[0], composed)
                    new_ops = func.ops[start:]
                    del func.ops[start:]
                    func.ops[idx:idx] = new_ops
                    func.replace_all_uses(op.result, y)
                    func.erase(op)
                    if not src.result.uses:
                        func.erase(src)
                    return True
                continue
            # pad commutes with transpose: pad(transpose(x, p), lo, hi) ->
            # transpose(pad(x, lo∘p, hi∘p), p) — lets the conversion
            # transposes of adjacent padded convs cancel at the seam
            if op.opname == "tl.pad":
                src = op.operands[0].owner
                if src is not None and src.opname == "tl.transpose" \
                        and len(op.operands[0].uses) == 1:
                    perm = tuple(src.attrs["perm"])
                    lo = tuple(op.attrs["lo"])
                    hi = tuple(op.attrs["hi"])
                    lo_x = [0] * len(perm)
                    hi_x = [0] * len(perm)
                    for d, p in enumerate(perm):
                        lo_x[p] = lo[d]
                        hi_x[p] = hi[d]
                    idx = func.ops.index(op)
                    start = len(func.ops)
                    y = b.pad(src.operands[0], tuple(lo_x), tuple(hi_x))
                    res = b.transpose(y, perm)
                    new_ops = func.ops[start:]
                    del func.ops[start:]
                    func.ops[idx:idx] = new_ops
                    func.replace_all_uses(op.result, res)
                    func.erase(op)
                    if not src.result.uses:
                        func.erase(src)
                    return True
                continue
            is_un = op.opname in ELTWISE_UNARY
            is_bin = op.opname in ELTWISE_BINARY
            if not (is_un or is_bin):
                continue
            # both operands transposed with the same perm (residual add)
            if is_bin:
                o0, o1 = (v.owner for v in op.operands)
                if (o0 is not None and o1 is not None
                        and o0.opname == o1.opname == "tl.transpose"
                        and len(op.operands[0].uses) == 1
                        and len(op.operands[1].uses) == 1
                        and tuple(o0.attrs["perm"])
                        == tuple(o1.attrs["perm"])):
                    idx = func.ops.index(op)
                    start = len(func.ops)
                    y = b.binary(op.opname, o0.operands[0], o1.operands[0])
                    res = b.transpose(y, tuple(o0.attrs["perm"]))
                    new_ops = func.ops[start:]
                    del func.ops[start:]
                    func.ops[idx:idx] = new_ops
                    func.replace_all_uses(op.result, res)
                    func.erase(op)
                    for ro in (o0, o1):
                        if not ro.result.uses:
                            func.erase(ro)
                    return True
            # sink only past a FULL-shaped transposed operand: sinking past
            # the small (broadcast) one would introduce a transpose on the
            # other side and ping-pong forever
            ridx = None
            for i, v in enumerate(op.operands):
                o = v.owner
                if o is not None and o.opname == "tl.transpose" \
                        and len(v.uses) == 1 \
                        and tuple(v.type.shape) \
                        == tuple(op.result.type.shape):
                    ridx = i
                    break
            if ridx is None:
                continue
            top = op.operands[ridx].owner
            perm = tuple(top.attrs["perm"])
            inv = _inv_perm(perm)
            idx = func.ops.index(op)
            start = len(func.ops)
            if is_un:
                y = b.unary(op.opname, top.operands[0])
            else:
                other = op.operands[1 - ridx]
                nd = len(perm)
                bshape = tuple(other.type.shape)
                if len(bshape) > nd:
                    del func.ops[start:]
                    continue
                if bshape == tuple(op.result.type.shape):
                    # Full-shape `other` (residual add): sinking moves the
                    # transpose ONTO `other`, and the mirrored rewrite would
                    # fire on it next round — an infinite ping-pong. Only
                    # sink when it strictly pushes the transpose from a
                    # computed value to a graph leaf (block arg / constant),
                    # which is a one-way move.
                    oo = other.owner
                    other_is_leaf = oo is None or oo.opname == "tl.constant"
                    src_is_computed = top.operands[0].owner is not None \
                        and top.operands[0].owner.opname != "tl.constant"
                    if not (other_is_leaf and src_is_computed):
                        del func.ops[start:]
                        continue
                al = (1,) * (nd - len(bshape)) + bshape   # right-align
                b2 = other
                if al != bshape:
                    b2 = b.reshape(other, al)
                # shape equality is NOT permutation-invariance (square
                # operands!): transpose whenever the perm is non-trivial
                if inv != tuple(range(nd)) and any(d != 1 for d in al):
                    b2 = b.transpose(b2, inv)
                args = [top.operands[0], b2] if ridx == 0 \
                    else [b2, top.operands[0]]
                y = b.binary(op.opname, *args)
            res = b.transpose(y, perm)
            new_ops = func.ops[start:]
            del func.ops[start:]
            func.ops[idx:idx] = new_ops
            func.replace_all_uses(op.result, res)
            func.erase(op)
            if not top.result.uses:
                func.erase(top)
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
        if op.attrs.get("init") == "literal":
            t = torch.from_numpy(np.ascontiguousarray(
                module.literals[op.attrs["literal"]]))
        else:
            t = tensor_init(op.attrs.get("init", "zero"),
                            op.attrs.get("orig_shape", val.type.shape),
                            val.type.dtype, op.attrs.get("seed", 0),
                            op.attrs.get("value", 1.0))
        return apply_pack_recipe(t, op.attrs).float().numpy()
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


def _channel_vec(arr, out_shape, ch_axis):
    """Per-channel vector (length K, or 1 for a scalar) if `arr` broadcast
    against `out_shape` varies only along `ch_axis`, else None."""
    a = np.asarray(arr)
    if a.ndim > len(out_shape):
        return None
    shp = (1,) * (len(out_shape) - a.ndim) + tuple(a.shape)
    for ax, d in enumerate(shp):
        if d != 1 and ax != ch_axis:
            return None
    if shp[ch_axis] not in (1, out_shape[ch_axis]):
        return None
    return a.reshape(-1)


_CONV_CH_AXIS = {"tl.conv2d_nhwc_hwcf": 3, "tl.conv2d_nchw_fchw": 1}


@register
class FoldConstScalePass(Pass):
    """Compile-time folding of constant eltwise chains around convolutions
    (what makes imported eval-mode BatchNorm free — the reference relies on
    the same idea via linalg constant folding + FoldIntoEltwise):

      R1  mul(conv(x, W_const, zero), s_const)  -> conv(x, W*s, zero)
          (per-output-channel s folds into the constant weight)
      R2  mul(add(u, c_const), s_const)         -> add(mul(u, s), c*s)
          (distribute, pushing the mul toward the conv for R1)
      R3  add(add(u, c1_const), c2_const)       -> add(u, c1+c2)

    Runs to fixpoint before conv-init-simplify, which then absorbs the one
    surviving const add into the conv accumulator init — so a conv+bias+BN
    +residual+relu block lowers to ONE fused kernel with the binary slot
    free for the residual."""

    name = "fold-const-scale"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        while self._round(func, module):
            changed = True
        return changed

    def _round(self, func: Function, module: Module) -> bool:
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None:
                continue
            if op.opname == "tl.mul":
                for full, s in ((op.operands[0], op.operands[1]),
                                (op.operands[1], op.operands[0])):
                    if tuple(full.type.shape) != tuple(op.result.type.shape):
                        continue
                    prod = full.owner
                    if prod is None or len(full.uses) != 1:
                        continue
                    s_arr = _materialize_const(s, module)
                    if s_arr is None:
                        continue
                    # R1: fold per-channel scale into the conv weight
                    if prod.opname in _CONV_CH_AXIS:
                        ch = _CONV_CH_AXIS[prod.opname]
                        vec = _channel_vec(s_arr, prod.result.type.shape, ch)
                        if vec is None:
                            continue
                        w = prod.operands[1]
                        w_arr = _materialize_const(w, module)
                        if w_arr is None or not is_zero_op(
                                prod.operands[2].owner):
                            continue
                        if prod.opname == "tl.conv2d_nhwc_hwcf":
                            w_new = w_arr * vec.reshape(1, 1, 1, -1)
                        else:   # FCHW: K leads
                            w_new = w_arr * vec.reshape(-1, 1, 1, 1)
                        idx = func.ops.index(prod)
                        start = len(func.ops)
                        w_c = new_literal_const(b, module, w_new,
                                              w.type.shape, w.type.dtype)
                        new_ops = func.ops[start:]
                        del func.ops[start:]
                        func.ops[idx:idx] = new_ops
                        prod.set_operand(1, w_c)
                        func.replace_all_uses(op.result, full)
                        func.erase(op)
                        return True
                    # R2: distribute the const mul over a const add
                    if prod.opname == "tl.add":
                        for u, c in ((prod.operands[0], prod.operands[1]),
                                     (prod.operands[1], prod.operands[0])):
                            c_arr = _materialize_const(c, module)
                            if c_arr is None:
                                continue
                            if _materialize_const(u, module) is not None:
                                continue  # both const: nothing to push to
                            cs = np.asarray(c_arr, np.float32) \
                                * np.asarray(s_arr, np.float32)
                            idx = func.ops.index(op)
                            start = len(func.ops)
                            mu = b.mul(u, s)
                            c_c = new_literal_const(b, module, cs, cs.shape,
                                                  op.result.type.dtype)
                            res = b.add(mu, c_c)
                            new_ops = func.ops[start:]
                            del func.ops[start:]
                            func.ops[idx:idx] = new_ops
                            func.replace_all_uses(op.result, res)
                            func.erase(op)
                            if not prod.result.uses:
                                func.erase(prod)
                            return True
                        continue
            if op.opname == "tl.add":
                # R3: combine consecutive const adds
                for full, c2 in ((op.operands[0], op.operands[1]),
                                 (op.operands[1], op.operands[0])):
                    prod = full.owner
                    if prod is None or prod.opname != "tl.add" \
                            or len(full.uses) != 1:
                        continue
                    c2_arr = _materialize_const(c2, module)
                    if c2_arr is None:
                        continue
                    for u, c1 in ((prod.operands[0], prod.operands[1]),
                                  (prod.operands[1], prod.operands[0])):
                        c1_arr = _materialize_const(c1, module)
                        if c1_arr is None:
                            continue
                        if _materialize_const(u, module) is not None:
                            continue
                        c3 = np.asarray(c1_arr, np.float32) \
                            + np.asarray(c2_arr, np.float32)
                        idx = func.ops.index(op)
                        start = len(func.ops)
                        c_c = new_literal_const(b, module, c3, c3.shape,
                                              op.result.type.dtype)
                        res = b.add(u, c_c)
                        new_ops = func.ops[start:]
                        del func.ops[start:]
                        func.ops[idx:idx] = new_ops
                        func.replace_all_uses(op.result, res)
                        func.erase(op)
                        if not prod.result.uses:
                            func.erase(prod)
                        return True
        return False


@register
class DecomposeSoftmaxPass(Pass):
    """tl.softmax -> reduce max, sub, exp, reduce sum, div (reference
    `fold.py:573`), emitted before the softmax. default-tpp-passes runs it
    after attention-fusion, so a softmax that pass absorbs never reaches
    it; the eltwise steps lower to xsmm.unary/xsmm.binary and the
    reductions stay tl.reduce."""

    name = "decompose-softmax"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.softmax":
                continue
            x = op.operands[0]
            axis = op.attrs.get("axis", -1)
            if axis < 0:
                axis += x.type.rank
            ops_before = len(func.ops)
            mx = b.reduce(x, "max", (axis,), keepdims=True)
            sh = b.sub(x, mx)
            ex = b.exp(sh)
            sm = b.reduce(ex, "sum", (axis,), keepdims=True)
            res = b.div(ex, sm)
            # move the freshly appended ops to just before the softmax
            new_ops = func.ops[ops_before:]
            del func.ops[ops_before:]
            idx = func.ops.index(op)
            func.ops[idx:idx] = new_ops
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed
