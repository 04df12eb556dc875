"""Named pipelines of the port.

`default-tpp-passes` runs only the passes the slice has ported, in the
reference's order (`tpp_mlir_tpu/passes/pipelines.py:44-100`, flat mode):
on tpp-gen's MLP, fc and matmul modules, on the MHA suite's modules, on the
conv suite's nets and on the imported GPT, transformer-block, ResNet-block
and ViT models the reference's other passes leave the IR as it is. It ends
with `verify-slice`, which refuses any op the port cannot run, so no IR
outside the slice is run half-lowered.
"""

from __future__ import annotations

from ..ir import Function, Module
from ..runtime.executor import attention_key, conv_key
from ..xsmm.reference import attention_route, conv_route
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
    # the MHA suite
    "xsmm.batch_gemm_dispatch", "xsmm.batch_gemm",
    "xsmm.unary_dispatch", "xsmm.unary",
    # the conv family: conv-init-simplify's broadcast accumulator, a pad
    # that conv-to-brgemm could not fuse
    "tl.broadcast", "tl.pad",
})


def slice_violation(op) -> str | None:
    """Why `op` is outside the slice, or None."""
    if op.opname == "tl.softmax":
        return ("a tl.softmax that attention-fusion did not absorb "
                "(decompose-softmax, queue A3)")
    if op.opname not in SLICE_OPS:
        return f"op {op.opname}"
    a = op.attrs
    if op.opname == "tl.constant" and any(k.startswith("pack_") for k in a):
        return "packed tl.constant (queue A13)"
    if op.opname in ("xsmm.gemm_dispatch", "xsmm.brgemm_dispatch",
                     "xsmm.fused_brgemm_dispatch"):
        layout = a.get("layout", "flat")
        if layout == "conv_nhwc":
            # a strategy and stride the reference refuses raise here
            try:
                conv_route(conv_key(a))
            except NotImplementedError as e:
                return f"conv {e}"
            return None
        if layout != "flat":
            return f"{layout} layout (queue A13, packed mode)"
        if a.get("prologue") not in (None, "layer_norm"):
            return f"{a['prologue']} prologue (queue A6 / B2)"
    if op.opname == "xsmm.unary_dispatch" and a["kind"] != "transpose":
        return f"xsmm.unary {a['kind']!r} (queue A3)"
    if op.opname == "xsmm.attention_dispatch":
        # a strategy whose kernel the reference would swap for another;
        # a shape a strategy does not apply to raises ValueError here
        try:
            attention_route(attention_key(a))
        except NotImplementedError as e:
            return f"attention {e}"
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
        "fold-add-into-dest",
        "attention-fusion",
        "cleanup",
        # flat mode: convs to NHWC, layout conversions sunk to the boundary
        "conv-to-nhwc",
        "sink-transpose",
        "fold-const-scale",
        "conv1x1-to-matmul",
        "sink-reshape",
        "conv-init-simplify",
        "cleanup",
        "tile-and-fuse",
        "conv-to-brgemm",
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
