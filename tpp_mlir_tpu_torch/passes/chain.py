"""chain-fusion: fuse consecutive fused-BRGEMM layers into one kernel.

A copy of `tpp_mlir_tpu/passes/chain.py` with one change: the reference
gates on `chain_fits_vmem` (a TPU VMEM budget); here the gate is
`chain_fits_smem`, derived from csrc/chain.cu's own shared-memory need. A
chain the kernel cannot hold stays as per-layer xsmm.fused_brgemm, the same
fallback the reference takes when its gate fails.

Matches maximal chains of xsmm.fused_brgemm (or plain beta_0 xsmm.gemm)
invokes where:
  * flat layout, batch == 1, beta_0, binary add with bcast_col (or no
    binary), same unary kind between layers;
  * each layer's A is the (reshaped) result of the previous layer;
  * chain.cu can hold the chain (chain_fits_smem).
"""

from __future__ import annotations

from tpp_mlir_tpu.ir import Function, I64, Module, Operation, TppBuilder

from ..xsmm.flags import ChainKey
from ..xsmm.kernels import chain_fits_smem
from .pass_manager import Pass, register


def _layer_info(op: Operation):
    """If `op` is a chainable fused_brgemm / plain gemm layer, return its
    pieces (a bare xsmm.gemm chains as a layer with no epilogue)."""
    if op.opname not in ("xsmm.fused_brgemm", "xsmm.gemm"):
        return None
    d = op.operands[0].owner
    a = d.attrs
    if op.opname == "xsmm.gemm":
        if a.get("flags") and set(a["flags"]) - {"beta_0"}:
            return None
        if "beta_0" not in a.get("flags", ()):
            return None
        A2, B2 = op.operands[1], op.operands[2]
        if A2.type.rank != 2 or B2.type.rank != 2:
            return None
        return {"op": op, "dispatch": d, "x": A2, "w": B2, "bias": None,
                "m": a["m"], "k": a["k"], "n": a["n"],
                "unary": "none", "dtype": a["dtype"]}
    if a.get("layout", "flat") != "flat" or a.get("batch") != 1:
        return None
    if "beta_0" not in a.get("flags", ()):
        return None
    if a.get("binary_kind") not in ("add", "none"):
        return None
    if a.get("binary_kind") == "add" and a.get("binary_bcast") != "bcast_col":
        return None
    if a.get("vnni"):
        return None
    A, B = op.operands[1], op.operands[2]

    def unreshape(v):
        o = v.owner
        if o is not None and o.opname == "tl.reshape" \
                and o.operands[0].type.rank == 2:
            return o.operands[0]
        return None

    x2d = unreshape(A)
    w2d = unreshape(B)
    if x2d is None or w2d is None:
        return None
    bias = op.operands[4] if a.get("binary_kind") == "add" else None
    return {"op": op, "dispatch": d, "x": x2d, "w": w2d, "bias": bias,
            "m": a["m"], "k": a["k"], "n": a["n"],
            "unary": a.get("unary_kind", "none"), "dtype": a["dtype"]}


@register
class ChainFusionPass(Pass):
    name = "chain-fusion"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        consumed: set[int] = set()
        for op in list(func.ops):
            if op.parent is None or id(op) in consumed:
                continue
            first = _layer_info(op)
            if first is None:
                continue
            # grow the chain forward
            chain = [first]
            cur = first
            while True:
                uses = cur["op"].result.uses
                if len(uses) != 1:
                    break
                user, uidx = uses[0]
                if user.opname == "tl.reshape":
                    if len(user.result.uses) != 1:
                        break
                    nxt_op, idx = user.result.uses[0]
                else:
                    nxt_op, idx = user, uidx
                if idx != 1:
                    break
                nxt = _layer_info(nxt_op)
                if nxt is None or nxt["x"] is not cur["op"].result:
                    break
                if nxt["m"] != first["m"] or nxt["dtype"] != first["dtype"]:
                    break
                # inner activations must be uniform; only the final
                # layer's may differ
                if cur["unary"] != first["unary"]:
                    break
                chain.append(nxt)
                cur = nxt
            if len(chain) < 2:
                continue
            has_bias = all(c["bias"] is not None for c in chain)
            if not has_bias and any(c["bias"] is not None for c in chain):
                continue
            dims = (chain[0]["k"],) + tuple(c["n"] for c in chain)
            precision = first["dispatch"].attrs.get("precision", "default")
            key = ChainKey(m=first["m"], dims=dims, dtype=first["dtype"],
                           has_bias=has_bias,
                           unary_kind=None if first["unary"] == "none"
                           else first["unary"],
                           last_unary=None if chain[-1]["unary"] == "none"
                           else chain[-1]["unary"],
                           precision=precision)
            if not chain_fits_smem(key):
                continue

            last = chain[-1]["op"]
            attrs = {"m": first["m"], "dims": dims, "dtype": first["dtype"],
                     "has_bias": has_bias,
                     "unary_kind": first["unary"],
                     "last_unary": chain[-1]["unary"],
                     "precision": precision}
            operands = [first["x"]]
            for c in chain:
                operands.append(c["w"])
                if has_bias:
                    operands.append(c["bias"])

            start = len(func.ops)
            d = b.create("xsmm.fused_chain_dispatch", [], [I64], attrs)
            inv = b.create("xsmm.fused_chain", [d.result] + operands,
                           [last.result.type])
            new_ops = func.ops[start:]
            del func.ops[start:]
            pos = func.ops.index(last)
            func.ops[pos:pos] = new_ops

            func.replace_all_uses(last.result, inv.result)
            for c in reversed(chain):
                consumed.add(id(c["op"]))
            changed = True
        return changed
