"""attention-fusion: recognize the MHA core and form tl.attention.

Pattern (the reference's MHA benchmark suite shape,
benchmarks/mlir/fp32-{query-times-key,out-softmax-times-value}.mlir and
test/Passes/pass-tile-and-fuse-mha.mlir):

    kt  = tl.transpose(K, (0, 2, 1))
    s   = tl.batch_matmul(Q, kt, zero)     [optionally s = mul(s, scale)]
    p   = tl.softmax(s, axis=-1)
    out = tl.batch_matmul(p, V, zero)

becomes one tl.attention, lowered to the flat-layout attention kernel
(csrc/attention.cu, blocked online softmax). A softmax(s) @ V whose s comes
from elsewhere becomes a batch matmul with `softmax_lhs`. A copy of
`tpp_mlir_tpu/passes/attention.py` (tests/test_torch_ir.py holds the two to
the same output); it runs at the head of default-tpp-passes, before any pass
could split a softmax.
"""

from __future__ import annotations

from ..ir import Function, Module, TppBuilder
from ..ir.matcher import is_zero_op
from .pass_manager import Pass, register


def _scalar_const_operand(op):
    """(other_value, scalar) when `op` is tl.mul by a 1-element 'const'
    constant (either operand order), else None."""
    if op is None or op.opname != "tl.mul":
        return None
    for i, j in ((0, 1), (1, 0)):
        const = op.operands[j].owner
        if const is not None and const.opname == "tl.constant" \
                and const.attrs.get("init") == "const" \
                and const.result.type.num_elements == 1:
            return op.operands[i], float(const.attrs.get("value", 1.0))
    return None


@register
class AttentionFusionPass(Pass):
    name = "attention-fusion"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.batch_matmul":
                continue
            # op is the final P @ V
            P, V, C2 = op.operands
            # non-zero output accumulator: out = attn + C2 afterwards
            post_add = None if is_zero_op(C2.owner) else C2
            sm = P.owner
            scale = 1.0
            post_scale = None
            hit = _scalar_const_operand(sm)
            if hit is not None and len(sm.result.uses) == 1:
                # scale-AFTER-softmax: (softmax(s)*c) @ V == (attn) * c
                inner, post_scale = hit
                sm = inner.owner
            if sm is None or sm.opname != "tl.softmax":
                continue
            axis = sm.attrs.get("axis", -1)
            if axis not in (-1, 2):
                continue
            s_val = sm.operands[0]
            s_op = s_val.owner
            hit = _scalar_const_operand(s_op)
            if hit is not None:
                inner, scale = hit
                s_op = inner.owner
            if s_op is None or s_op.opname != "tl.batch_matmul":
                # softmax(s) @ V with s from elsewhere: fuse the softmax into
                # the batched matmul (the out-softmax-times-value kernel)
                if len(sm.result.uses) == 1 and post_scale is None \
                        and post_add is None and scale == 1.0 \
                        and not any(v is sm.result for v in func.returns):
                    op.set_operand(0, s_val)
                    op.attrs["softmax_lhs"] = True
                    if not sm.result.uses:
                        func.erase(sm)
                    changed = True
                continue
            Q, KT, C1 = s_op.operands
            if not is_zero_op(C1.owner):
                continue
            hit = _scalar_const_operand(Q.owner)
            if hit is not None:
                # scale applied to Q before the QK matmul: same scalar
                Q, qc = hit
                scale *= qc
            tr = KT.owner
            if tr is None or tr.opname != "tl.transpose" \
                    or tuple(tr.attrs.get("perm", ())) != (0, 2, 1):
                continue
            K = tr.operands[0]
            if len(sm.result.uses) != 1 or len(s_op.result.uses) != 1:
                continue

            attrs = {"scale": scale}

            def emit(bb):
                res = bb.create("tl.attention", [Q, K, V],
                                [op.result.type], attrs).result
                if post_scale is not None:
                    c = bb.constant(res.type.with_shape((1,)), init="const",
                                    value=post_scale)
                    res = bb.mul(res, c)
                if post_add is not None:
                    res = bb.add(res, post_add)
                return res

            start = len(func.ops)
            res = emit(b)
            new_ops = func.ops[start:]
            del func.ops[start:]
            pos = func.ops.index(op)
            func.ops[pos:pos] = new_ops
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed
