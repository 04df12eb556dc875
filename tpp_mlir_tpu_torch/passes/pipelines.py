"""Named pipelines of the port.

`default-tpp-passes` runs only the passes the slice has ported, in the
reference's order (`tpp_mlir_tpu/passes/pipelines.py:67-100`): on tpp-gen's
MLP, fc and matmul modules and on the imported GPT and transformer-block
models the reference's other passes leave the IR as it is. It ends with
`verify-slice`, which refuses any op the port cannot run, so no IR outside
the slice is run half-lowered.
"""

from __future__ import annotations

from tpp_mlir_tpu.ir import Function, Module

from .pass_manager import Pass, register, register_pipeline

# ops the port's executor runs after lowering
SLICE_OPS = frozenset({
    "tl.constant", "tl.reshape",
    "xsmm.gemm_dispatch", "xsmm.gemm",
    "xsmm.brgemm_dispatch", "xsmm.brgemm",
    "xsmm.fused_brgemm_dispatch", "xsmm.fused_brgemm",
    "xsmm.fused_chain_dispatch", "xsmm.fused_chain",
    "perf.bench",
    "check.expect_true", "check.expect_almost_eq", "check.expect_sane",
    # the transformer slice
    "tl.gather",
    "xsmm.attention_dispatch", "xsmm.attention",
    "xsmm.layer_norm_dispatch", "xsmm.layer_norm",
    "xsmm.binary_dispatch", "xsmm.binary",
})


def slice_violation(op) -> str | None:
    """Why `op` is outside the slice, or None."""
    if op.opname not in SLICE_OPS:
        return f"op {op.opname}"
    a = op.attrs
    if op.opname == "tl.constant" and any(k.startswith("pack_") for k in a):
        return "packed tl.constant (queue A13)"
    if op.opname in ("xsmm.gemm_dispatch", "xsmm.brgemm_dispatch",
                     "xsmm.fused_brgemm_dispatch"):
        if a.get("layout", "flat") != "flat":
            return f"{a['layout']} layout (queue A13)"
        if a.get("prologue") not in (None, "layer_norm"):
            return f"{a['prologue']} prologue (queue A6 / B2)"
    if op.opname == "xsmm.attention_dispatch":
        if not a.get("heads"):
            return "flat-layout attention, heads = 0 (queue A6 / B6, B8-B11)"
        if a.get("strategy", "auto") not in ("auto", "tokens"):
            return f"attention strategy {a['strategy']!r} (queue A6)"
    return None


@register
class VerifySlicePass(Pass):
    """Raise NotImplementedError if any op is outside the port's slice."""

    name = "verify-slice"

    def run_on_function(self, func: Function, module: Module) -> bool:
        for op in func.ops:
            why = slice_violation(op)
            if why is not None:
                raise NotImplementedError(
                    f"@{func.name}: {why} is outside the port's slice "
                    f"(ROADMAP queue A); the port does not run IR "
                    f"half-lowered")
        return False


@register_pipeline("default-tpp-passes")
def default_tpp_passes():
    return [
        "cleanup",
        "sink-reshape",
        "cleanup",
        "tile-and-fuse",
        "convert-tl-to-xsmm",
        "xsmm-combine",
        "fold-residual-acc",
        "qkv-merge",
        "fold-xsmm-flags",
        "chain-fusion",
        "cleanup",
        # after cleanup: dead A-operand reshapes from qkv-merge are gone,
        # so a LayerNorm's remaining single consumer is visible
        "fuse-ln-gemm",
        "cleanup",
        "verify-xsmm",
        "verify-slice",
    ]
