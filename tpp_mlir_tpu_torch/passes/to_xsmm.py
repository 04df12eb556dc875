"""tl -> xsmm lowering, fused-kernel formation, and flag folding.

Copies of the slice's branches of `tpp_mlir_tpu/passes/to_xsmm.py`:

  convert-tl-to-xsmm  contractions (tl.matmul, tl.brgemm, tl.vnni_brgemm)
                      and eltwise unary/binary ops become dispatch+invoke
                      pairs;
  xsmm-combine        {gemm|brgemm} -> binary -> unary chains become one
                      xsmm.fused_brgemm;
  fold-xsmm-flags     zero-filled accumulators fold into the dispatch as the
                      BETA_0 flag;
  verify-xsmm         dispatch/invoke consistency.

The attention, LayerNorm, batch-matmul, packed, conv, transpose, VNNI-pack,
zero-fill, generic, residual-accumulator and QKV branches wait for their
ROADMAP items;
what they would have lowered is refused by the pipeline's verify-slice.
"""

from __future__ import annotations

from tpp_mlir_tpu.ir import Function, I64, Module, Operation, TppBuilder
from tpp_mlir_tpu.ir.matcher import is_pure_zero, is_zero_op

from .pass_manager import Pass, register

_UNARY_MAP = {
    "tl.relu": "relu", "tl.identity": "identity", "tl.exp": "exp",
    "tl.square": "square", "tl.sqrt": "sqrt", "tl.rsqrt": "rsqrt",
    "tl.tanh": "tanh", "tl.gelu": "gelu", "tl.gelu_tanh": "gelu_tanh",
    "tl.negate": "negate",
}
_BINARY_MAP = {"tl.add": "add", "tl.sub": "sub", "tl.mul": "mul",
               "tl.div": "div", "tl.max": "max"}


def infer_bcast(out_shape, operand_shape) -> str:
    """NumPy-broadcast shape -> xsmm broadcast flag (a rank-1 (N,) operand
    aligns with the last output dim: bcast_col; a row broadcast is (M, 1))."""
    if tuple(operand_shape) == tuple(out_shape):
        return "none"
    n = 1
    for d in operand_shape:
        n *= d
    if n == 1:
        return "bcast_scalar"
    aligned = (1,) * (len(out_shape) - len(operand_shape)) \
        + tuple(operand_shape)
    if operand_shape[-1] == out_shape[-1] \
            and (len(aligned) < 2 or aligned[-2] == 1):
        return "bcast_col"
    if len(operand_shape) >= 2 and operand_shape[-2] == out_shape[-2] \
            and operand_shape[-1] == 1 \
            and all(d == 1 for d in aligned[:-2]):
        return "bcast_row"
    return "none"


def _carry(src: Operation, dst: Operation):
    if "fusion_group" in src.attrs:
        dst.attrs["fusion_group"] = src.attrs["fusion_group"]


def _tile_attrs(op: Operation) -> dict:
    return {f"tile_{x}": op.attrs[f"tile_{x}"]
            for x in ("m", "n", "k") if f"tile_{x}" in op.attrs}


@register
class ConvertTlToXsmmPass(Pass):
    name = "convert-tl-to-xsmm"

    def run_on_function(self, func: Function, module: Module) -> bool:
        precision = module.attrs.get("precision", "default")
        changed = False
        b = TppBuilder(func)

        def replace(op, emit):
            """Emit the new ops before `op` and retire it."""
            start = len(func.ops)
            res = emit()
            new_ops = func.ops[start:]
            del func.ops[start:]
            i = func.ops.index(op)
            func.ops[i:i] = new_ops
            func.replace_all_uses(op.result, res)
            func.erase(op)

        def pair(dname, iname, attrs, operands, rtype, op):
            def emit():
                d = b.create(dname, [], [I64], attrs)
                inv = b.create(iname, [d.result, *operands], [rtype])
                _carry(op, inv)
                return inv.result
            return emit

        for op in list(func.ops):
            if op.parent is None:
                continue
            name = op.opname

            if name == "tl.matmul":
                A, B, C = op.operands
                m, k = A.type.shape
                n = C.type.shape[1]
                flags = ("transpose_b",) if op.attrs.get("transpose_b") else ()
                attrs = {"m": m, "n": n, "k": k, "dtype": A.type.dtype,
                         "flags": flags, "precision": precision,
                         **_tile_attrs(op)}
                replace(op, pair("xsmm.gemm_dispatch", "xsmm.gemm", attrs,
                                 [A, B, C], C.type, op))
                changed = True

            elif name in ("tl.brgemm", "tl.vnni_brgemm"):
                A, B, C = op.operands
                Bt, m, k = A.type.shape
                n = C.type.shape[1]
                attrs = {"m": m, "n": n, "k": k, "batch": Bt,
                         "dtype": A.type.dtype, "flags": (),
                         "precision": precision, **_tile_attrs(op)}
                if name == "tl.vnni_brgemm":
                    attrs["vnni"] = op.attrs.get("vnni", 2)
                replace(op, pair("xsmm.brgemm_dispatch", "xsmm.brgemm",
                                 attrs, [A, B, C], C.type, op))
                changed = True

            elif name in _UNARY_MAP:
                X = op.operands[0]
                shape = X.type.shape
                attrs = {"kind": _UNARY_MAP[name],
                         "m": int(X.type.num_elements
                                  // (shape[-1] if shape else 1)),
                         "n": shape[-1] if shape else 1,
                         "shape": tuple(shape), "dtype": X.type.dtype,
                         "flags": ()}
                replace(op, pair("xsmm.unary_dispatch", "xsmm.unary", attrs,
                                 [X], op.result.type, op))
                changed = True

            elif name in _BINARY_MAP:
                X, Y = op.operands
                out_shape = op.result.type.shape
                fx = infer_bcast(out_shape, X.type.shape)
                fy = infer_bcast(out_shape, Y.type.shape)
                attrs = {"kind": _BINARY_MAP[name],
                         "m": int(op.result.type.num_elements
                                  // out_shape[-1]) if out_shape else 1,
                         "n": out_shape[-1] if out_shape else 1,
                         "shape_a": tuple(X.type.shape),
                         "shape_b": tuple(Y.type.shape),
                         "dtype": op.result.type.dtype,
                         "flags": tuple(f for f in (fx, fy) if f != "none")}
                replace(op, pair("xsmm.binary_dispatch", "xsmm.binary",
                                 attrs, [X, Y], op.result.type, op))
                changed = True

        return changed


def _single_user(op: Operation, func: Function | None = None):
    """Sole consuming op of op's single result, or None; a returned value
    counts as an escape (returns are not in .uses)."""
    if len(op.results) != 1 or len(op.result.uses) != 1:
        return None
    if func is not None and any(v is op.result for v in func.returns):
        return None
    return op.result.uses[0][0]


@register
class CombineXsmmPass(Pass):
    """{gemm|brgemm} -> binary -> unary chains => one fused_brgemm."""

    name = "xsmm-combine"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname not in ("xsmm.gemm",
                                                      "xsmm.brgemm"):
                continue
            disp = op.operands[0].owner
            binary_op = None
            unary_op = None
            cur = op
            user = _single_user(cur, func)
            bias = None
            if user is not None and user.opname == "xsmm.binary":
                kind = user.operands[0].owner.attrs["kind"]
                # the kernel computes acc OP d: for non-commutative kinds
                # the contraction result must be the first value operand
                order_ok = (kind in ("add", "mul", "max")
                            or user.operands[1] is cur.result)
                # a broadcast-up binary would change the output's shape
                shape_ok = (user.result.type.shape == cur.result.type.shape)
                if order_ok and shape_ok:
                    others = [v for v in user.operands[1:]
                              if v is not cur.result]
                    if len(others) == 1:
                        binary_op = user
                        bias = others[0]
                        cur = user
                        user = _single_user(cur, func)
            if user is not None and user.opname == "xsmm.unary":
                if user.operands[0].owner.attrs["kind"] in (
                        "relu", "gelu", "tanh", "exp", "square", "identity"):
                    unary_op = user
                    cur = user
            if binary_op is None and unary_op is None:
                continue

            attrs = dict(disp.attrs)
            attrs.pop("fusion_group", None)
            if op.opname == "xsmm.gemm":
                if "transpose_b" in disp.attrs.get("flags", ()):
                    continue  # no fused transpose_b, as in the reference
                attrs.setdefault("batch", 1)
                attrs["flags"] = tuple(disp.attrs.get("flags", ()))
            if binary_op is not None:
                attrs["binary_kind"] = binary_op.operands[0].owner.attrs["kind"]
                attrs["binary_bcast"] = infer_bcast(
                    binary_op.result.type.shape, bias.type.shape)
            else:
                attrs["binary_kind"] = "none"
                attrs["binary_bcast"] = "none"
            attrs["unary_kind"] = (unary_op.operands[0].owner.attrs["kind"]
                                   if unary_op is not None else "none")

            A, B, C = op.operands[1], op.operands[2], op.operands[3]
            last = cur

            def emit():
                nonlocal A, B, bias
                if op.opname == "xsmm.gemm":
                    A = b.reshape(A, (1,) + A.type.shape)
                    B = b.reshape(B, (1,) + B.type.shape)
                if bias is None:
                    bias = C  # placeholder operand; the kernel ignores it
                d = b.create("xsmm.fused_brgemm_dispatch", [], [I64], attrs)
                inv = b.create("xsmm.fused_brgemm",
                               [d.result, A, B, C, bias],
                               [last.result.type])
                return inv.result

            start = len(func.ops)
            res = emit()
            new_ops = func.ops[start:]
            del func.ops[start:]
            # the bias may be defined between the contraction and the binary
            i = func.ops.index(last)
            func.ops[i:i] = new_ops

            func.replace_all_uses(last.result, res)
            for dead in (unary_op, binary_op, op):
                if dead is not None and dead.parent is not None \
                        and not dead.result.uses \
                        and not any(v is dead.result
                                    for v in func.returns):
                    dd = dead.operands[0].owner
                    func.erase(dead)
                    if dd is not None and dd.parent is not None \
                            and not dd.result.uses:
                        func.erase(dd)
            changed = True
        return changed


@register
class FoldXsmmFlagsPass(Pass):
    """Zero-filled accumulator -> BETA_0 dispatch flag."""

    name = "fold-xsmm-flags"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname not in (
                    "xsmm.gemm", "xsmm.brgemm", "xsmm.fused_brgemm"):
                continue
            disp = op.operands[0].owner
            if "beta_0" in disp.attrs.get("flags", ()):
                continue
            c_idx = 3
            C = op.operands[c_idx]
            producer = C.owner
            new_c = None
            if is_pure_zero(producer):
                new_c = C
            elif is_zero_op(producer):
                if producer.opname in ("tl.zero", "tl.fill") \
                        and len(C.uses) == 1:
                    new_c = producer.operands[0]
                elif len(C.uses) == 1:
                    # reshape/broadcast over a zero-fill: flag BETA_0 and
                    # leave the (now unread) init for DCE
                    new_c = C
            if new_c is None:
                continue
            attrs = dict(disp.attrs)
            attrs["flags"] = tuple(attrs.get("flags", ())) + ("beta_0",)
            nd = Operation(disp.opname, [], [I64], attrs)
            nd.results[0].name = b._name()
            func.insert_before(op, nd)
            op.set_operand(0, nd.results[0])
            if new_c is not C:
                op.set_operand(c_idx, new_c)
            if producer is not None and producer.parent is not None \
                    and not any(r.uses for r in producer.results) \
                    and producer.opname != "tl.constant":
                func.erase(producer)
            changed = True
        return changed


@register
class VerifyXsmmPass(Pass):
    """Dispatch/invoke consistency: module.verify() plus a check that
    dispatches are only consumed by invokes."""

    name = "verify-xsmm"

    def run_on_function(self, func: Function, module: Module) -> bool:
        func.verify()
        for op in func.ops:
            if op.opname.endswith("_dispatch"):
                for user, idx in op.result.uses:
                    if not user.opname.startswith("xsmm.") or idx != 0:
                        raise ValueError(
                            f"dispatch {op.opname} consumed by non-invoke "
                            f"{user.opname}")
        return False
