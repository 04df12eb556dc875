"""Named pipelines of the port: the reference's bundles
(`tpp_mlir_tpu/passes/pipelines.py:31-117`) over the port's passes.

  tpp-mapping               (pack=True) conv layout, folds, packing and
                            tile-and-fuse at the tensor level: flat mode
                            (pack=False) takes convs to NHWC and sinks the
                            layout conversions to the graph's boundary;
                            packed parity mode (pack=True) keeps NCHW and
                            packs contractions into blocked layouts with
                            VNNI (csrc/blocked_matmul.cu, csrc/conv.cu's
                            channel-blocked entry)
  linalg-lowering           tl -> xsmm, fused-kernel formation, BETA_0,
                            chain-fusion, the LayerNorm prologue
  default-tpp-passes        (pack=False) degeneralize, fold-add-into-dest,
                            attention-fusion, decompose-softmax, cleanup,
                            tpp-mapping, linalg-lowering, cleanup, then the
                            port's verify-slice
  default-tpp-passes-flat   the same (the default, flat contractions)
  default-tpp-passes-packed packed parity mode
  default-pipeline          default-tpp-passes

The reference's patchify-conv-to-matmul option is not ported (ROADMAP,
"Not to port"). `verify-slice` admits only the ops the executor runs after
lowering (SLICE_OPS), so no IR runs half-lowered: a contraction, conv,
attention or LayerNorm still in tl form (one that convert-tl-to-xsmm's
`skip` or conv-to-brgemm left) would run its plain version on the card in
place of its kernel, and is refused. It also refuses the keys of xsmm ops
that check_slice refuses (an unknown dtype, precision or epilogue kind),
a tl.generic in contraction
form or with reduction dims outside it (the reference's evaluator raises
on the latter too), and conv or attention keys whose kernel the reference
would swap for another.
"""

from __future__ import annotations

from ..ir import Function, Module
from ..ir.affine import classify_generic
from ..runtime.executor import (_dispatch_key, attention_key,
                                conv_blocked_key, conv_key)
from ..xsmm.reference import attention_route, check_slice, conv_route
from .pass_manager import Pass, expand_pipeline, register, register_pipeline


# ops the port's executor runs after lowering; a tl contraction, conv,
# attention or LayerNorm is not among them: its kernel runs only once it is
# lowered to its xsmm dispatch
SLICE_OPS = frozenset({
    "tl.constant", "tl.reshape",
    "xsmm.gemm_dispatch", "xsmm.gemm",
    "xsmm.brgemm_dispatch", "xsmm.brgemm",
    "xsmm.fused_brgemm_dispatch", "xsmm.fused_brgemm",
    "xsmm.fused_chain_dispatch", "xsmm.fused_chain",
    "perf.bench", "perf.timer_start", "perf.timer_stop", "perf.sink",
    "check.expect_true", "check.expect_almost_eq", "check.expect_sane",
    # the transformer slice
    "tl.gather",
    "xsmm.attention_dispatch", "xsmm.attention",
    "xsmm.layer_norm_dispatch", "xsmm.layer_norm",
    # xsmm.unary and xsmm.binary, every kind: PyTorch ops, as the
    # reference's are jnp (xsmm/kernels.py:3315-3345 there)
    "xsmm.binary_dispatch", "xsmm.binary",
    "xsmm.unary_dispatch", "xsmm.unary",
    # the MHA suite
    "xsmm.batch_gemm_dispatch", "xsmm.batch_gemm",
    # the conv family: conv-init-simplify's broadcast accumulator, a pad
    # that conv-to-brgemm could not fuse
    "tl.broadcast", "tl.pad",
    # packed parity mode: data movement, and a strided blocked conv, which
    # the executor runs with F.conv2d (TF32 off) as the reference runs it
    # with XLA
    "tl.pack", "tl.unpack", "tl.vnni_pack", "tl.blocked_conv2d",
    # the compiler's general path: what convert-tl-to-xsmm leaves in tl
    # form, which the reference evaluates with jnp too (no kernel on either
    # side): decompose-softmax's reductions, pools, fills, casts, a
    # softmax no pass decomposed, eltwise ops and an elementwise tl.generic
    "tl.reduce", "tl.max_pool2d", "tl.avg_pool2d", "tl.fill", "tl.zero",
    "tl.cast", "tl.softmax", "tl.transpose", "tl.generic",
    "tl.add", "tl.sub", "tl.mul", "tl.div", "tl.max",
    "tl.relu", "tl.identity", "tl.exp", "tl.negate", "tl.square",
    "tl.sqrt", "tl.rsqrt", "tl.tanh", "tl.gelu", "tl.gelu_tanh",
})


def slice_violation(op) -> str | None:
    """Why the port cannot run `op`, or None."""
    if op.opname not in SLICE_OPS:
        return f"op {op.opname} (not lowered to its kernel)"
    a = op.attrs
    if op.opname == "tl.generic":
        cls = classify_generic(op)
        if cls is not None and cls[0] == "contraction":
            return (f"a contraction tl.generic ({cls[1]}, not lowered to "
                    f"its kernel)")
        if cls is None and "reduction" in a["iterator_types"]:
            return ("a tl.generic with reduction dims outside the "
                    "contraction normal form add(mul(a, b), acc)")
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
    if op.opname == "xsmm.attention_dispatch":
        # a strategy whose kernel the reference would swap for another;
        # a shape a strategy does not apply to raises ValueError here
        try:
            attention_route(attention_key(a))
        except NotImplementedError as e:
            return f"attention {e}"
    if op.opname.startswith("xsmm.") and not op.opname.endswith("_dispatch"):
        # the key the executor dispatches: check_slice refuses what no
        # kernel of the port takes
        try:
            check_slice(_dispatch_key(op.operands[0].owner, op))
        except NotImplementedError as e:
            return f"{op.opname} {e}"
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
                    f"@{func.name}: {why} is outside the port's slice; "
                    f"the port does not run IR half-lowered")
        return False


# the reference's tpp-mapping stages of packed parity mode
PACK_STAGES = ("pack-matmul", "pack-vnni", "propagate-pack",
               "constant-fold-pack", "simplify-pack")


@register_pipeline("tpp-mapping")
def tpp_mapping(pack: bool = True):
    return [
        # flat mode: convs to NHWC, layout conversions sunk to the boundary;
        # packed mode keeps the reference's NCHW channel-blocked layout
        *(() if pack else ("conv-to-nhwc", "sink-transpose")),
        "fold-const-scale",
        "conv1x1-to-matmul",
        "sink-reshape",
        "conv-init-simplify",
        "pack-conv2d",
        *(PACK_STAGES if pack else ()),
        "cleanup",
        "tile-and-fuse",
    ]


@register_pipeline("linalg-lowering")
def linalg_lowering():
    return [
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
    ]


@register_pipeline("default-tpp-passes")
def default_tpp_passes(pack: bool = False):
    return [
        "degeneralize",
        "fold-add-into-dest",
        "attention-fusion",
        # after attention-fusion: a softmax it absorbed never reaches here
        "decompose-softmax",
        "cleanup",
        *expand_pipeline("tpp-mapping", pack=pack),
        *expand_pipeline("linalg-lowering"),
        "cleanup",
        "verify-slice",
    ]


@register_pipeline("default-tpp-passes-flat")
def default_tpp_passes_flat():
    """Flat contractions and whole-chain fusion (the default)."""
    return default_tpp_passes(pack=False)


@register_pipeline("default-tpp-passes-packed")
def default_tpp_passes_packed():
    """Packed parity mode: physical blocked layouts + VNNI, as the
    reference's (`tpp_mlir_tpu/passes/pipelines.py:109`)."""
    return default_tpp_passes(pack=True)


@register_pipeline("default-pipeline")
def default_pipeline():
    return ["default-tpp-passes"]
