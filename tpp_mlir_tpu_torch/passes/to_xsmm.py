"""tl -> xsmm lowering, fused-kernel formation, and flag folding.

Copies of the slice's branches of `tpp_mlir_tpu/passes/to_xsmm.py`:

  convert-tl-to-xsmm  contractions (tl.matmul, tl.batch_matmul, tl.brgemm,
                      tl.vnni_brgemm), tl.attention, tl.layer_norm,
                      tl.transpose and eltwise unary/binary ops become
                      dispatch+invoke pairs;
  xsmm-combine        {gemm|brgemm} -> binary -> unary chains (bias add,
                      relu, gelu, ...) become one xsmm.fused_brgemm;
  fold-residual-acc   a full-shape residual add of a BETA_0 contraction
                      becomes its accumulator (:762);
  qkv-merge           three Q/K/V projections of one activation become one
                      GEMM of triple width feeding a qkv_packed attention
                      (:887);
  fold-xsmm-flags     zero-filled accumulators fold into the dispatch as the
                      BETA_0 flag;
  fuse-ln-gemm        a LayerNorm whose only consumer is one flat GEMM
                      becomes that GEMM's prologue (:1030);
  verify-xsmm         dispatch/invoke consistency.

The packed, conv, VNNI-pack, zero-fill and generic branches wait for their
ROADMAP items; what they would have lowered is refused by the pipeline's
verify-slice.
"""

from __future__ import annotations

import numpy as np

from ..ir import (Function, I64, Module, Operation, TensorType,
                  TppBuilder)
from ..ir.matcher import is_pure_zero, is_zero_op
from .fold import _hoist_before, _materialize_const, new_literal_const
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

            elif name == "tl.attention":
                Q, K, V = op.operands
                Bt, S, D = Q.type.shape
                attrs = {"batch": Bt, "seq": S, "seq_kv": K.type.shape[1],
                         "head_dim": D, "scale": op.attrs.get("scale", 1.0),
                         "causal": bool(op.attrs.get("causal", False)),
                         "dtype": Q.type.dtype, "flags": (),
                         "precision": precision}
                for opt in ("strategy", "bq", "bk"):
                    if opt in op.attrs:
                        attrs[opt] = op.attrs[opt]
                H = int(op.attrs.get("heads", 0) or 0)
                if H:
                    # token layout: batch is the true batch, head_dim the
                    # per-head width (operand width = heads * head_dim)
                    attrs["heads"] = H
                    attrs["head_dim"] = D // H
                replace(op, pair("xsmm.attention_dispatch", "xsmm.attention",
                                 attrs, [Q, K, V], op.result.type, op))
                changed = True

            elif name == "tl.batch_matmul":
                A, B, C = op.operands
                if op.attrs.get("lhs_shared"):
                    m, k = A.type.shape
                    Bt = B.type.shape[0]
                else:
                    Bt, m, k = A.type.shape
                attrs = {"batch": Bt, "m": m, "n": C.type.shape[2], "k": k,
                         "dtype": A.type.dtype, "flags": (),
                         "precision": precision}
                for opt in ("softmax_lhs", "lhs_shared"):
                    if op.attrs.get(opt):
                        attrs[opt] = True
                replace(op, pair("xsmm.batch_gemm_dispatch",
                                 "xsmm.batch_gemm", attrs, [A, B, C], C.type,
                                 op))
                changed = True

            elif name == "tl.transpose":
                X = op.operands[0]
                attrs = {"kind": "transpose", "m": X.type.shape[0],
                         "n": X.type.shape[-1], "shape": tuple(X.type.shape),
                         "perm": tuple(op.attrs["perm"]),
                         "dtype": X.type.dtype, "flags": ()}
                replace(op, pair("xsmm.unary_dispatch", "xsmm.unary", attrs,
                                 [X], op.result.type, op))
                changed = True

            elif name == "tl.layer_norm":
                X = op.operands[0]
                M, E = X.type.shape
                attrs = {"m": M, "n": E,
                         "eps": float(op.attrs.get("eps", 1e-5)),
                         "affine": len(op.operands) == 3,
                         "dtype": X.type.dtype, "flags": (),
                         "precision": precision}
                replace(op, pair("xsmm.layer_norm_dispatch",
                                 "xsmm.layer_norm", attrs, list(op.operands),
                                 op.result.type, op))
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
                    "xsmm.gemm", "xsmm.brgemm", "xsmm.fused_brgemm",
                    "xsmm.batch_gemm"):
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
class FoldResidualAccPass(Pass):
    """A full-shape `xsmm.binary add` consuming a BETA_0 contraction becomes
    the contraction's accumulator init (beta = 1):

        f = fused_brgemm(A, B, C=zero[beta_0], bias[bcast_col])
        r = binary_add(x, reshape?(f))          # full-shape residual
        [u = unary(r)]                          # optional activation
    ->
        f' = fused_brgemm(A, B, C=x, bias[bcast_col], unary=u?)

    The residual rides the accumulator read the kernel does anyway, and the
    separate m*n elementwise pass disappears. Association changes from
    (A@B + bias) + x to (x + A@B) + bias, within f32-accumulate tolerance."""

    name = "fold-residual-acc"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "xsmm.binary":
                continue
            bdisp = op.operands[0].owner
            if bdisp is None or bdisp.attrs.get("kind") != "add":
                continue
            if op.operands[1].type.shape != op.operands[2].type.shape:
                continue  # only full-shape adds
            for gi, oi in ((1, 2), (2, 1)):
                v = op.operands[gi]
                other = op.operands[oi]
                if v is other:
                    continue
                reshape = None
                prod = v.owner
                if prod is not None and prod.opname == "tl.reshape":
                    if len(prod.result.uses) != 1:
                        continue
                    reshape = prod
                    prod = prod.operands[0].owner
                if prod is None or prod.opname not in ("xsmm.fused_brgemm",
                                                       "xsmm.brgemm"):
                    continue
                if len(prod.result.uses) != 1:
                    continue  # the contraction output escapes elsewhere
                if any(x is prod.result for x in func.returns) or (
                        reshape is not None and any(
                            x is reshape.result for x in func.returns)):
                    continue  # returned: rewiring would change its value
                pd = prod.operands[0].owner
                flags = tuple(pd.attrs.get("flags", ()))
                # the pass runs before fold-xsmm-flags, so "acc is dead"
                # shows up as the BETA_0 flag or a zero-op accumulator
                if "beta_0" not in flags \
                        and not is_zero_op(prod.operands[3].owner):
                    continue
                if pd.attrs.get("unary_kind") not in (None, "none"):
                    continue  # unary applies before the add: not foldable
                if prod.result.type.dtype != op.result.type.dtype:
                    continue
                if not _hoist_before(func, prod, other):
                    continue

                attrs = dict(pd.attrs)
                attrs["flags"] = tuple(f for f in flags if f != "beta_0")
                # absorb a single trailing unary as the fused epilogue, only
                # on fused_brgemm (a plain brgemm's key has no unary)
                unary_op = _single_user(op, func)
                if (unary_op is not None
                        and unary_op.opname == "xsmm.unary"
                        and prod.opname == "xsmm.fused_brgemm"
                        and unary_op.result.type == prod.result.type):
                    attrs["unary_kind"] = \
                        unary_op.operands[0].owner.attrs["kind"]
                else:
                    unary_op = None

                start = len(func.ops)
                acc = other
                if acc.type.shape != prod.result.type.shape:
                    acc = b.reshape(acc, prod.result.type.shape)
                nd = b.create(pd.opname, [], [I64], attrs).result
                new_ops = func.ops[start:]
                del func.ops[start:]
                i = func.ops.index(prod)
                func.ops[i:i] = new_ops

                prod.set_operand(0, nd)
                prod.set_operand(3, acc)

                repl = reshape.result if reshape is not None else prod.result
                if unary_op is not None:
                    func.replace_all_uses(unary_op.result, repl)
                    ud = unary_op.operands[0].owner
                    func.erase(unary_op)
                    if ud is not None and not ud.result.uses:
                        func.erase(ud)
                func.replace_all_uses(op.result, repl)
                func.erase(op)
                if not bdisp.result.uses:
                    func.erase(bdisp)
                if not pd.result.uses:
                    func.erase(pd)
                changed = True
                break
        return changed


@register
class QkvMergePass(Pass):
    """Three fused_brgemm projections reading the same activation with
    constant weights (the Q/K/V of every imported MultiheadAttention) merge
    into one GEMM of triple width feeding a qkv_packed attention:

        q = fused_brgemm(A, Wq, bias_q);  k = ...;  v = ...
        o = attention(q, k, v)                       # token layout
    ->
        qkv = fused_brgemm(A, [Wq|Wk|Wv], [bq|bk|bv])   # (m, 3n)
        o   = attention(qkv)                            # qkv_packed

    The activation is read once instead of three times, one launch replaces
    three, and attention.cu reads K/V at column offsets of the packed array.
    The weight/bias concatenation happens at compile time, as new module
    literals."""

    name = "qkv-merge"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "xsmm.attention":
                continue
            if len(op.operands) != 4:
                continue
            ad = op.operands[0].owner
            if not int(ad.attrs.get("heads", 0) or 0):
                continue
            if ad.attrs["seq"] != ad.attrs["seq_kv"]:
                continue
            reshapes, prods = [], []
            for v in op.operands[1:]:
                r = v.owner
                if r is None or r.opname != "tl.reshape" \
                        or len(r.result.uses) != 1:
                    break
                p = r.operands[0].owner
                if p is None or p.opname != "xsmm.fused_brgemm" \
                        or len(p.result.uses) != 1:
                    break
                reshapes.append(r)
                prods.append(p)
            if len(prods) != 3 or len(set(map(id, prods))) != 3:
                continue
            pds = [p.operands[0].owner for p in prods]

            def _same_activation(x, y):
                # CSE runs later: the A operands may be distinct-but-equal
                # reshape ops of one source value
                if x is y:
                    return True
                xo, yo = x.owner, y.owner
                return (xo is not None and yo is not None
                        and xo.opname == yo.opname == "tl.reshape"
                        and xo.operands[0] is yo.operands[0]
                        and x.type == y.type)

            a0 = prods[0].operands[1]
            if any(not _same_activation(p.operands[1], a0)
                   for p in prods[1:]):
                continue
            base = dict(pds[0].attrs)
            if any(dict(d.attrs) != base for d in pds[1:]):
                continue
            if base.get("layout", "flat") != "flat" or base.get("batch") != 1:
                continue
            if base.get("binary_kind") != "add" \
                    or base.get("binary_bcast") != "bcast_col":
                continue
            if base.get("unary_kind") not in (None, "none"):
                continue
            # acc must be dead (zero or BETA_0) in all three
            if "beta_0" not in base.get("flags", ()) and not all(
                    is_zero_op(p.operands[3].owner) for p in prods):
                continue
            ws = [_materialize_const(p.operands[2], module) for p in prods]
            bs = [_materialize_const(p.operands[4], module) for p in prods]
            if any(w is None for w in ws) or any(x is None for x in bs):
                continue
            m, n, kk = base["m"], base["n"], base["k"]
            dt = prods[0].result.type.dtype
            w_cat = np.concatenate([w.reshape(kk, n) for w in ws], axis=1)
            b_cat = np.concatenate([x.reshape(n) for x in bs])

            attrs = dict(base)
            attrs["n"] = 3 * n
            attrs["flags"] = tuple(f for f in base.get("flags", ())
                                   if f != "beta_0") + ("beta_0",)
            for t in ("tile_m", "tile_n", "tile_k"):
                attrs.pop(t, None)  # triple width: re-pick kernel blocks
            a_attrs = dict(ad.attrs)
            a_attrs["qkv_packed"] = True
            B_, S_ = op.operands[1].type.shape[:2]

            start = len(func.ops)
            wc = new_literal_const(b, module, w_cat, (1, kk, 3 * n), dt)
            bc = new_literal_const(b, module, b_cat, (3 * n,), dt)
            zc = b.create("tl.constant", [], [TensorType((m, 3 * n), dt)],
                          {"init": "zero"}).result
            nd = b.create("xsmm.fused_brgemm_dispatch", [], [I64],
                          attrs).result
            gemm = b.create("xsmm.fused_brgemm", [nd, a0, wc, zc, bc],
                            [TensorType((m, 3 * n), dt)]).result
            packed = b.reshape(gemm, (B_, S_, 3 * n))
            nad = b.create("xsmm.attention_dispatch", [], [I64],
                           a_attrs).result
            res = b.create("xsmm.attention", [nad, packed],
                           [op.result.type]).result
            new_ops = func.ops[start:]
            del func.ops[start:]
            i = func.ops.index(op)
            func.ops[i:i] = new_ops

            func.replace_all_uses(op.result, res)
            func.erase(op)
            for r, p, d in zip(reshapes, prods, pds):
                if not r.result.uses:
                    func.erase(r)
                if not p.result.uses and not any(
                        v is p.result for v in func.returns):
                    func.erase(p)
                if d.parent is not None and not d.result.uses:
                    func.erase(d)
            if ad.parent is not None and not ad.result.uses:
                func.erase(ad)
            changed = True
        return changed


@register
class FuseLnGemmPass(Pass):
    """A LayerNorm whose only consumer is one flat GEMM becomes that GEMM's
    prologue: csrc/brgemm.cu normalizes each A row in f32 as it stages it
    and contracts at once, so the LayerNorm output never goes to device
    memory. Legal when the kernel sees whole rows: batch 1, flat, no VNNI,
    no transpose_b."""

    name = "fuse-ln-gemm"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "xsmm.layer_norm":
                continue
            ld = op.operands[0].owner
            user = _single_user(op, func)
            if user is None:
                continue
            reshape = None
            if user.opname == "tl.reshape":
                reshape = user
                user = _single_user(user, func)
                if user is None:
                    continue
            if user.opname != "xsmm.fused_brgemm":
                continue
            gd = user.operands[0].owner
            a_val = reshape.result if reshape is not None else op.result
            if user.operands[1] is not a_val:
                continue  # LN feeds B/C/D, not the contraction input
            if gd.attrs.get("layout", "flat") != "flat" \
                    or gd.attrs.get("batch") != 1 \
                    or gd.attrs.get("vnni") \
                    or gd.attrs.get("prologue") \
                    or "transpose_b" in gd.attrs.get("flags", ()):
                continue
            if gd.attrs["k"] != ld.attrs["n"] \
                    or gd.attrs["m"] != ld.attrs["m"]:
                continue
            if gd.attrs["k"] > 8192:
                continue  # the reference's whole-row block limit
            affine = bool(ld.attrs.get("affine", True))
            x_in = op.operands[1]
            gamma_beta = list(op.operands[2:4]) if affine else []

            attrs = dict(gd.attrs)
            attrs["prologue"] = "layer_norm"
            attrs["prologue_affine"] = affine
            attrs["prologue_eps"] = float(ld.attrs.get("eps", 1e-5))
            attrs.pop("tile_k", None)   # the kernel runs a single k block

            start = len(func.ops)
            nd = b.create(gd.opname, [], [I64], attrs).result
            a_new = x_in
            if a_new.type.shape != a_val.type.shape:
                a_new = b.reshape(a_new, a_val.type.shape)
            res = b.create(user.opname,
                           [nd, a_new, *user.operands[2:], *gamma_beta],
                           [user.result.type]).result
            new_ops = func.ops[start:]
            del func.ops[start:]
            i = func.ops.index(user)
            func.ops[i:i] = new_ops

            func.replace_all_uses(user.result, res)
            func.erase(user)
            if gd.parent is not None and not gd.result.uses:
                func.erase(gd)
            if reshape is not None and not reshape.result.uses:
                func.erase(reshape)
            if not op.result.uses and not any(
                    v is op.result for v in func.returns):
                func.erase(op)
                if ld.parent is not None and not ld.result.uses:
                    func.erase(ld)
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
