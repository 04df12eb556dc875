"""Conv passes.

Copies of `tpp_mlir_tpu/passes/conv.py:28-457` (without the opt-in
patchify-conv-to-matmul, which no pipeline of the port runs):

  conv-init-simplify       a conv into a zero-fill followed by a bias add
                           becomes a conv whose accumulator is the
                           broadcast bias (reference ConvInitSimplify.cpp);
  conv-to-nhwc             NCHW convs become NHWC ones between boundary
                           transposes, which sink-transpose cancels;
  conv1x1-to-matmul        1x1 stride-1 convs become GEMMs;
  pack-conv2d              (packed parity mode) NCHW convs become
                           channel-blocked tl.blocked_conv2d;
  conv-to-brgemm           each NHWC conv becomes one xsmm.brgemm with
                           layout "conv_nhwc", a zero-pad producer fused in
                           as its padding; each stride-1 blocked conv one
                           with layout "conv".

conv1x1-to-matmul keeps the reference's width gate (a TPU sublane rule) so
the lowered IR stays the JAX package's; ROADMAP queue C records it.
"""

from __future__ import annotations

from ..ir import Function, I64, Module, TppBuilder, broadcast_shapes
from ..ir.matcher import is_zero_op
from ..utils.target import pack_min_tile
from .fold import _hoist_before
from .pack import _divisor, _insert_before
from .pass_manager import Pass, register


@register
class ConvInitSimplifyPass(Pass):
    name = "conv-init-simplify"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.add":
                continue
            conv_val, other = op.operands
            conv = conv_val.owner
            if conv is None or not conv.opname.startswith("tl.conv2d"):
                conv_val, other = other, conv_val
                conv = conv_val.owner
            if conv is None or not conv.opname.startswith("tl.conv2d"):
                continue
            if len(conv_val.uses) != 1:
                continue
            dest = conv.operands[2]
            # The zero dest may be CSE-shared across convs: replacing THIS
            # conv's acc operand never mutates the zero itself, so sharing
            # is harmless — requiring a unique use here would re-create the
            # reference's DuplicateFill problem (Passes.td:334-342) instead
            # of absorbing it.
            if not is_zero_op(dest.owner):
                continue
            out_t = conv.result.type
            bias_shape = other.type.shape
            try:
                ok = broadcast_shapes(bias_shape, out_t.shape) == out_t.shape
            except ValueError:
                ok = False
            if not ok:
                # NCHW channel bias (K,) -> (K,1,1) so it broadcasts over H,W
                if conv.opname == "tl.conv2d_nchw_fchw" and \
                        len(bias_shape) == 1 and bias_shape[0] == out_t.shape[1]:
                    reshape_to = (bias_shape[0], 1, 1)
                else:
                    continue
            else:
                reshape_to = None

            if not _hoist_before(func, conv, other):
                continue

            def emit(bb):
                v = other
                if reshape_to is not None:
                    v = bb.reshape(v, reshape_to)
                return bb.broadcast(v, out_t.shape)

            init = _insert_before(func, conv, b, emit)
            conv.set_operand(2, init)
            func.replace_all_uses(op.result, conv.result)
            func.erase(op)
            changed = True
        return changed


@register
class ConvToNhwcPass(Pass):
    """NCHW convs -> NHWC form (transposes at the op boundary, cancelled /
    sunk by sink-transpose). NHWC is the TPU-native conv layout: channels
    land on the lane axis, so the NHWC conv-BRGEMM kernel needs ZERO
    relayout while NCHW pays one per call. Plays the role the reference's
    PackConv2DNchwFchw blocked relayout plays for AVX (ToBlockLayoutAndBack
    .cpp:569-640): normalize to the layout the microkernel wants, then let
    propagation push the conversions to the graph boundary. Measured on
    v5e: 2-6x over the NCHW-blocked path (PERF.md r2)."""

    name = "conv-to-nhwc"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.conv2d_nchw_fchw":
                continue
            I, W, O = op.operands
            strides = tuple(op.attrs.get("strides", (1, 1)))

            def emit(bb):
                ii = bb.transpose(I, (0, 2, 3, 1))   # NCHW -> NHWC
                wi = bb.transpose(W, (2, 3, 1, 0))   # FCHW -> HWCF
                oi = bb.transpose(O, (0, 2, 3, 1))
                res = bb.conv2d_nhwc_hwcf(ii, wi, oi, strides)
                return bb.transpose(res, (0, 3, 1, 2))

            res = _insert_before(func, op, b, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed


@register
class Conv1x1ToMatmulPass(Pass):
    """1x1 stride-1 convs ARE GEMMs — rewrite them to matmul form so they
    ride the full matmul path (tile-and-fuse, fused epilogues, chains).
    Reference: RewriteConvToMatmulImpl.cpp (312 LoC) + the 1x1 case of
    RewriteConvsToMatmulOrBrgemm.cpp:578.

      NHWC: O[N*H*W, K] = I[N*H*W, C] @ W[C, K]      (pure reshapes)
      NCHW: O[n][K, H*W] = W[K, C] @ I[n][C, H*W]    (lhs-shared batch GEMM,
            zero relayout — the weight is a constant-index BlockSpec)
    """

    name = "conv1x1-to-matmul"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None:
                continue
            if tuple(op.attrs.get("strides", (1, 1))) != (1, 1):
                continue
            if op.opname == "tl.conv2d_nhwc_hwcf":
                I, W, O = op.operands
                N, H, Wd, C = I.type.shape
                R, S, _, K = W.type.shape
                if (R, S) != (1, 1):
                    continue
                # the flat (N*H*W, C) reshape is layout-preserving only when
                # the width is a sublane multiple; otherwise it is a real
                # HBM relayout and the NHWC-native conv kernel (fullrow, one
                # tap) runs the same GEMM with free in-kernel reshapes —
                # measured 2x faster on 14x14 (PERF.md)
                sub = 16 if I.type.dtype in ("bf16", "f16") else 8
                if Wd % sub != 0:
                    continue

                def emit(bb):
                    xi = bb.reshape(I, (N * H * Wd, C))
                    wi = bb.reshape(W, (C, K))
                    oi = bb.reshape(O, (N * H * Wd, K))
                    mm = bb.matmul(xi, wi, oi)
                    return bb.reshape(mm, O.type.shape)
            elif op.opname == "tl.conv2d_nchw_fchw":
                I, W, O = op.operands
                N, C, H, Wd = I.type.shape
                K, _, R, S = W.type.shape
                if (R, S) != (1, 1):
                    continue

                def emit(bb):
                    wi = bb.reshape(W, (K, C))
                    xi = bb.reshape(I, (N, C, H * Wd))
                    oi = bb.reshape(O, (N, K, H * Wd))
                    mm = bb.batch_matmul(wi, xi, oi, lhs_shared=True)
                    return bb.reshape(mm, O.type.shape)
            else:
                continue
            res = _insert_before(func, op, b, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed


@register
class PackConv2DPass(Pass):
    """NCHW channel-block packing (packed parity mode): the reference's
    PackConv2DNchwFchw, O[N,Kb,P,Q,k] += I[N,Cb,H,W,c] * W[Kb,Cb,R,S,c,k].
    NHWC convs are not packed (conv-to-brgemm lowers them as they are). The
    channel block is the reference's rule: a lane-sized (128) divisor, else
    64's, else the whole channel count."""

    name = "pack-conv2d"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.conv2d_nchw_fchw":
                continue
            I, W, O = op.operands
            N, C, H, Wd = I.type.shape
            K, _, R, S = W.type.shape
            lane = pack_min_tile(I.type.dtype)[1]
            cblk = _divisor(C, lane) or _divisor(C, 64) or C
            kblk = _divisor(K, lane) or _divisor(K, 64) or K
            strides = tuple(op.attrs.get("strides", (1, 1)))

            def emit(bb):
                pi = bb.pack(I, (1,), (cblk,))             # [N,Cb,H,W,c]
                pw = bb.pack(W, (0, 1), (kblk, cblk),
                             outer_perm=(0, 1, 2, 3))      # [Kb,Cb,R,S,k,c]
                pw = bb.transpose(pw, (0, 1, 2, 3, 5, 4))  # [Kb,Cb,R,S,c,k]
                po = bb.pack(O, (1,), (kblk,))             # [N,Kb,P,Q,k]
                blocked = bb.blocked_conv2d(pi, pw, po, strides)
                return bb.unpack(blocked, (1,), (kblk,), O.type.shape)

            res = _insert_before(func, op, b, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed


@register
class ConvToBrgemmPass(Pass):
    """Stride-1 channel-blocked convs -> layout="conv" (B23,
    csrc/conv.cu's channel-blocked entry), and NHWC convs -> layout
    "conv_nhwc" (NHWC-native, zero relayout) at any stride. A strided
    tl.blocked_conv2d stays as it is, as in the reference: the executor runs
    it with F.conv2d."""

    name = "conv-to-brgemm"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None:
                continue
            strides = tuple(op.attrs.get("strides", (1, 1)))
            I, W, O = op.operands if len(op.operands) == 3 else (None,) * 3
            make_input = lambda bb, _i=I: _i      # noqa: E731
            if op.opname == "tl.blocked_conv2d" and strides == (1, 1):
                N, Cb, H, Wd, c = I.type.shape
                Kb, _, R, S, _, k = W.type.shape
                attrs = {"layout": "conv", "N": N, "H": H, "W": Wd, "Cb": Cb,
                         "Kb": Kb, "R": R, "S": S, "c": c, "kblk": k,
                         "m": 0, "n": k, "k": c, "batch": Cb * R * S,
                         "strides": (1, 1), "dtype": I.type.dtype,
                         "flags": ()}
            elif op.opname == "tl.conv2d_nhwc_hwcf":
                # fuse a zero-pad producer into the conv (the xla strategy
                # pads natively; Pallas strategies pad outside the kernel)
                # -- saves the pad's HBM round trip. Two shapes: a direct
                # NHWC pad, or pad-below-transpose at the NCHW boundary.
                hit = _match_pad(I)
                pad4, in_shape, make_input = (hit if hit is not None
                                              else (None, I.type.shape,
                                                    make_input))
                N, H, Wd, C = in_shape
                R, S, _, K = W.type.shape
                attrs = {"layout": "conv_nhwc", "N": N, "H": H, "W": Wd,
                         "C": C, "K": K, "R": R, "S": S,
                         "m": 0, "n": K, "k": C, "batch": C * R * S,
                         "strides": strides, "dtype": I.type.dtype,
                         "flags": ()}
                if pad4 is not None:
                    attrs["padding"] = pad4
            else:
                continue

            def emit(bb, mk=make_input):
                d = bb.create("xsmm.brgemm_dispatch", [], [I64], attrs)
                inv = bb.create("xsmm.brgemm", [d.result, mk(bb), W, O],
                                [O.type])
                if "fusion_group" in op.attrs:
                    inv.attrs["fusion_group"] = op.attrs["fusion_group"]
                return inv.result

            res = _insert_before(func, op, b, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed


def _match_pad(I):
    """Match a fusable zero-pad feeding an NHWC conv input.

    Returns (pad4, unpadded_nhwc_shape, make_input(bb)) or None.
    pad4 = (h_lo, h_hi, w_lo, w_hi). Two shapes:
      * direct: conv(pad_nhwc(x))            -- spatial dims 1,2 padded;
      * boundary: conv(transpose(pad_nchw(x))) -- the pad rides below the
        NCHW->NHWC conversion transpose; the fused input is a NEW transpose
        of the unpadded x.
    """
    src = I.owner
    if src is None or len(I.uses) != 1:
        return None
    if src.opname == "tl.pad":
        lo, hi = tuple(src.attrs["lo"]), tuple(src.attrs["hi"])
        if len(lo) != 4 or lo[0] or hi[0] or lo[3] or hi[3]:
            return None
        x = src.operands[0]
        return ((lo[1], hi[1], lo[2], hi[2]), tuple(x.type.shape),
                lambda bb: x)
    if src.opname == "tl.transpose":
        pad = src.operands[0].owner
        if pad is None or pad.opname != "tl.pad" \
                or len(src.operands[0].uses) != 1:
            return None
        perm = tuple(src.attrs["perm"])
        lo, hi = tuple(pad.attrs["lo"]), tuple(pad.attrs["hi"])
        if len(lo) != 4:
            return None
        # transpose output dim d comes from pad dim perm[d]; only the
        # spatial output dims (1, 2) may be padded
        if lo[perm[0]] or hi[perm[0]] or lo[perm[3]] or hi[perm[3]]:
            return None
        x = pad.operands[0]
        shape = tuple(x.type.shape[perm[d]] for d in range(4))
        return ((lo[perm[1]], hi[perm[1]], lo[perm[2]], hi[perm[2]]),
                shape, lambda bb: bb.transpose(x, perm))
    return None
