"""Named pipelines of the port.

`default-tpp-passes` runs only the passes the slice has ported, in the
reference's order (`tpp_mlir_tpu/passes/pipelines.py:44-100`, flat mode):
on tpp-gen's MLP, fc and matmul modules, on the MHA suite's modules, on the
conv suite's nets and on the imported GPT, transformer-block, ResNet-block
and ViT models the reference's other passes leave the IR as it is.
`default-tpp-passes-packed` is the reference's packed parity mode (:109,
`pack=True`): no conv-to-nhwc/sink-transpose, and pack-conv2d with the five
pack stages after conv-init-simplify, so contractions run on physically
blocked layouts (csrc/blocked_matmul.cu, csrc/conv.cu's channel-blocked
entry). Both end with `verify-slice`, which refuses any op the port cannot
run, so no IR outside the slice is run half-lowered.
"""

from __future__ import annotations

from ..ir import Function, Module
from ..runtime.executor import attention_key, conv_blocked_key, conv_key
from ..xsmm.reference import attention_route, check_slice, conv_route
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
    # packed parity mode: data movement, and a strided blocked conv, which
    # the executor runs with F.conv2d (TF32 off) as the reference runs it
    # with XLA
    "tl.pack", "tl.unpack", "tl.vnni_pack", "tl.blocked_conv2d",
})

# xsmm.unary kinds the executor runs as PyTorch ops (the reference's are
# jnp, xsmm/kernels.py:3315-3335); queue A3 owns the others
UNARY_KINDS = ("transpose", "relu", "vnni2")


def slice_violation(op) -> str | None:
    """Why `op` is outside the slice, or None."""
    if op.opname == "tl.softmax":
        return ("a tl.softmax that attention-fusion did not absorb "
                "(decompose-softmax, queue A3)")
    if op.opname not in SLICE_OPS:
        return f"op {op.opname}"
    a = op.attrs
    if op.opname in ("xsmm.gemm_dispatch", "xsmm.brgemm_dispatch",
                     "xsmm.fused_brgemm_dispatch"):
        layout = a.get("layout", "flat")
        try:
            # a strategy and stride the reference refuses raise here
            if layout == "conv_nhwc":
                conv_route(conv_key(a))
            elif layout == "conv":
                check_slice(conv_blocked_key(a))
        except NotImplementedError as e:
            return f"conv {e}"
        if layout not in ("flat", "blocked", "conv", "conv_nhwc"):
            return f"{layout} layout"
        if a.get("prologue") not in (None, "layer_norm"):
            # no pass of either package emits the ln_stats pair: its mu/var
            # operands have no place in a dispatch op, and the pair is
            # reached through the kernel-key API (xsmm.build_kernel)
            return (f"a {a['prologue']} prologue in the IR (the ln_stats "
                    f"pair runs through xsmm.build_kernel, not a pass)")
    if op.opname == "xsmm.unary_dispatch" and a["kind"] not in UNARY_KINDS:
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


# the reference's tpp-mapping stages of packed parity mode
PACK_STAGES = ("pack-conv2d", "pack-matmul", "pack-vnni", "propagate-pack",
               "constant-fold-pack", "simplify-pack")


def _pipeline(pack: bool) -> list[str]:
    """The reference's default-tpp-passes (flat, or packed with pack=True)
    over the port's passes."""
    return [
        "fold-add-into-dest",
        "attention-fusion",
        "cleanup",
        # flat mode: convs to NHWC, layout conversions sunk to the boundary;
        # packed mode keeps the reference's NCHW channel-blocked layout
        *(() if pack else ("conv-to-nhwc", "sink-transpose")),
        "fold-const-scale",
        "conv1x1-to-matmul",
        "sink-reshape",
        "conv-init-simplify",
        *(PACK_STAGES if pack else ()),
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
        "cleanup",
        "verify-slice",
    ]


@register_pipeline("default-tpp-passes")
def default_tpp_passes():
    return _pipeline(pack=False)


@register_pipeline("default-tpp-passes-packed")
def default_tpp_passes_packed():
    """Packed parity mode: physical blocked layouts + VNNI, as the
    reference's (`tpp_mlir_tpu/passes/pipelines.py:109`)."""
    return _pipeline(pack=True)
