"""tl.generic <-> named-op normalization (a copy of
`tpp_mlir_tpu/passes/generic_lower.py`).

  degeneralize          tl.generic -> named tl ops via map/body
                        classification (reference LinalgDeGeneralize.cpp).
                        Named ops are this pipeline's normal form: the
                        fusion and lowering passes work on named ops, so a
                        generic-form program (tpp-gen --output=generic)
                        lowers to the same kernels as its named form.
  generalize-named-ops  the inverse, for round-trip tests and for programs
                        that want the generic form (reference
                        linalg::generalizeNamedOp).

Broadcast semantics ride the indexing maps, not shapes: degeneralizing a
row-broadcast (map (d0,)) inserts the (m,1) reshape that makes the named
form unambiguous, the square-matrix case shape-based inference cannot
resolve (the reference infers from maps for the same reason,
ConvertLinalgToXsmm.cpp:320-427).
"""

from __future__ import annotations

from ..ir import Function, Module, TppBuilder
from ..ir.affine import classify_generic, infer_bcast_from_map
from .pass_manager import Pass, register

_NAMED_TO_BODY_UNARY = {
    "tl.relu": ("maximumf", ("arg", 0), 0.0),
    "tl.exp": ("exp", ("arg", 0)),
    "tl.negate": ("negate", ("arg", 0)),
    "tl.sqrt": ("sqrt", ("arg", 0)),
    "tl.rsqrt": ("rsqrt", ("arg", 0)),
    "tl.square": ("square", ("arg", 0)),
    "tl.tanh": ("tanh", ("arg", 0)),
    "tl.gelu": ("gelu", ("arg", 0)),
    "tl.identity": ("arg", 0),
}
_NAMED_BINARY = {"tl.add": "add", "tl.sub": "sub", "tl.mul": "mul",
                 "tl.div": "div", "tl.max": "max"}
_KIND_TO_NAMED_BINARY = {v: k for k, v in _NAMED_BINARY.items()}


def _insert_before(func, anchor, emit):
    start = len(func.ops)
    res = emit()
    new_ops = func.ops[start:]
    del func.ops[start:]
    i = func.ops.index(anchor)
    func.ops[i:i] = new_ops
    return res


@register
class DegeneralizePass(Pass):
    name = "degeneralize"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.generic":
                continue
            cls = classify_generic(op)
            if cls is None:
                continue
            maps = [tuple(m) for m in op.attrs["indexing_maps"]]
            out_map = maps[-1]
            init = op.operands[-1]

            if cls[0] == "contraction":
                _, kind, swap = cls
                A, B = op.operands[:2]
                if swap:
                    A, B = B, A

                def emit():
                    if kind == "matmul":
                        return b.matmul(A, B, init)
                    if kind == "matmul_tb":
                        return b.matmul(A, B, init, transpose_b=True)
                    if kind == "brgemm":
                        return b.brgemm(A, B, init)
                    return b.batch_matmul(A, B, init)
            elif cls[0] == "unary":
                kind = cls[1]
                x = op.operands[0]
                xmap = maps[0]

                def emit():
                    v = x
                    if xmap != out_map:
                        v = _align_operand(b, v, xmap, out_map,
                                           op.result.type.shape)
                    if kind == "identity":
                        return (b.broadcast(v, op.result.type.shape)
                                if v.type.shape != op.result.type.shape
                                else b.identity(v))
                    return b.unary(f"tl.{kind}", v)
            else:  # binary
                kind = cls[1]
                x, y = op.operands[:2]
                xmap, ymap = maps[0], maps[1]

                def emit():
                    xv = _align_operand(b, x, xmap, out_map,
                                        op.result.type.shape)
                    yv = _align_operand(b, y, ymap, out_map,
                                        op.result.type.shape)
                    return b.binary(_KIND_TO_NAMED_BINARY[kind], xv, yv)

            res = _insert_before(func, op, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed


def _align_operand(b, v, vmap, out_map, out_shape):
    """Make a projected-permutation operand NumPy-broadcastable against the
    output: transpose into output dim order, then reshape so broadcast dims
    are explicit size-1 axes (e.g. a row-broadcast (m,) becomes (m, 1))."""
    vmap = tuple(vmap)
    out_map = tuple(out_map)
    if vmap == out_map:
        return v
    flag = infer_bcast_from_map(out_map, vmap)
    if flag == "bcast_col" and vmap == out_map[-len(vmap):]:
        return v  # trailing projection: NumPy-broadcasts as-is
    # transpose into output order
    order = sorted(range(len(vmap)), key=lambda i: out_map.index(vmap[i]))
    if order != list(range(len(vmap))):
        v = b.transpose(v, order)
        vmap = tuple(vmap[i] for i in order)
    # explicit 1s for missing trailing/interior dims
    new_shape = tuple(v.type.shape[vmap.index(d)] if d in vmap else 1
                      for d in out_map)
    return b.reshape(v, new_shape)


@register
class GeneralizeNamedOpsPass(Pass):
    """Named contractions/eltwise -> tl.generic (reference
    generalize-named-ops, TppMapping.cpp:55-86)."""

    name = "generalize-named-ops"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None:
                continue
            name = op.opname
            mac = ("add", ("mul", ("arg", 0), ("arg", 1)), ("arg", 2))
            if name == "tl.matmul":
                A, B, C = op.operands
                if op.attrs.get("transpose_b"):
                    maps = [(0, 2), (1, 2), (0, 1)]
                else:
                    maps = [(0, 2), (2, 1), (0, 1)]
                iters = ("parallel", "parallel", "reduction")
                body = mac
                ins, init = [A, B], C
            elif name == "tl.brgemm":
                A, B, C = op.operands
                maps = [(2, 0, 3), (2, 3, 1), (0, 1)]
                iters = ("parallel", "parallel", "reduction", "reduction")
                body = mac
                ins, init = [A, B], C
            elif name == "tl.batch_matmul" and not op.attrs.get("lhs_shared"):
                A, B, C = op.operands
                maps = [(0, 1, 3), (0, 3, 2), (0, 1, 2)]
                iters = ("parallel", "parallel", "parallel", "reduction")
                body = mac
                ins, init = [A, B], C
            elif name in _NAMED_TO_BODY_UNARY and len(op.operands) == 1:
                x = op.operands[0]
                nd = x.type.rank
                maps = [tuple(range(nd)), tuple(range(nd))]
                iters = ("parallel",) * nd
                body = _NAMED_TO_BODY_UNARY[name]
                ins, init = [x], x
            elif name in _NAMED_BINARY:
                x, y = op.operands
                out_shape = op.result.type.shape
                nd = len(out_shape)
                xm = _map_for_broadcast(x.type.shape, out_shape)
                ym = _map_for_broadcast(y.type.shape, out_shape)
                if xm is None or ym is None:
                    continue
                maps = [xm, ym, tuple(range(nd))]
                iters = ("parallel",) * nd
                body = (_NAMED_BINARY[name], ("arg", 0), ("arg", 1))
                if tuple(x.type.shape) == tuple(out_shape):
                    full = x
                elif tuple(y.type.shape) == tuple(out_shape):
                    full = y
                else:
                    continue  # both operands broadcast: no full-shape init
                ins, init = [x, y], full
            else:
                continue

            def emit():
                return b.generic(ins, init, maps, iters, body)
            res = _insert_before(func, op, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed


def _map_for_broadcast(shape, out_shape):
    """Indexing map of a NumPy-broadcast operand: trailing alignment, size-1
    axes dropped. None when the shape cannot be expressed as a projection."""
    nd = len(out_shape)
    off = nd - len(shape)
    if off < 0:
        return None
    mp = []
    for i, s in enumerate(shape):
        if s == out_shape[off + i]:
            mp.append(off + i)
        elif s != 1:
            return None
    return tuple(mp)
