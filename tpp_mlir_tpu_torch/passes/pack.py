"""Blocked-layout passes of packed parity mode (default-tpp-passes-packed).

Copies of `tpp_mlir_tpu/passes/pack.py:26-356`, the reference's
ToBlockLayoutAndBack family:

  pack-matmul        matmul -> blocked_matmul on packed operands
                     C[Mb,Nb,mb,nb] += A[Mb,Kb,mb,kb] * B[Nb,Kb,kb,nb]
  pack-vnni          bf16 brgemm/blocked_matmul B operand -> VNNI layout
  propagate-pack     push unpack past eltwise consumers so chains stay blocked
  constant-fold-pack pack(constant) -> pre-packed constant (weights packed
                     once, when the function is compiled, not in the timed
                     loop)
  simplify-pack      pack(unpack)/unpack(pack) cancellation

The tiles are the reference's rule, the (sublane, lane) table included
(`utils/target.py pack_min_tile`), so the packed IR is the JAX package's:
they are a layout, not the Hopper kernels' blocking (csrc/blocked_matmul.cu
tiles each packed block with its own 64 x 64 output tiles). These
passes take no options: tiles come from the module's `tiles` attribute
(tpp-gen --tiles) or the default rule. lower-packs (:358) is in no
pipeline and is not copied.
"""

from __future__ import annotations

from ..ir import Function, Module, Operation, TppBuilder
from ..ir.matcher import ELTWISE_UNARY
from ..utils.target import pack_min_tile
from .pass_manager import Pass, register

MIN_TILES = 2           # the reference's tiny-matmul threshold (min_dim)
VNNI = 2                # the reference's VNNI factor for bf16/f16


def _divisor(dim: int, target: int, mult: int = 1) -> int:
    """Largest d <= target with d % mult == 0 and dim % d == 0, else 0."""
    d = min(dim, target)
    d -= d % mult
    while d >= mult:
        if dim % d == 0:
            return d
        d -= mult
    return 0


def default_tiles(M: int, N: int, K: int, dtype: str) -> tuple[int, int, int]:
    """The reference's default block factors (`pack.py:37-48`): nb == kb
    wherever possible, so that unpack(layer i) and pack(layer i+1) have the
    same recipe and cancel, and an MLP chain stays blocked end to end."""
    sub, lane = pack_min_tile(dtype)
    mb = _divisor(M, 256, sub) or _divisor(M, 256) or M
    nb = _divisor(N, 512, lane) or _divisor(N, 512) or N
    kb = _divisor(K, 512, lane) or _divisor(K, 512) or K
    return mb, nb, kb


def _insert_before(func: Function, anchor: Operation, b: TppBuilder, emit):
    """Run `emit(builder)` and splice the emitted ops before `anchor`."""
    start = len(func.ops)
    result = emit(b)
    new_ops = func.ops[start:]
    del func.ops[start:]
    idx = func.ops.index(anchor)
    func.ops[idx:idx] = new_ops
    return result


@register
class PackMatmulPass(Pass):
    """matmul -> pack A/B/C + blocked_matmul + unpack."""

    name = "pack-matmul"

    def run_on_function(self, func: Function, module: Module) -> bool:
        tiles = module.attrs.get("tiles")
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.matmul":
                continue
            if op.attrs.get("transpose_b"):
                continue
            A, B, C = op.operands
            M, K = A.type.shape
            _, N = B.type.shape
            mb, nb, kb = tiles or default_tiles(M, N, K, A.type.dtype)
            if M % mb or N % nb or K % kb:
                continue
            if M // mb < 1 or (M // mb) * (N // nb) * (K // kb) < MIN_TILES:
                continue        # too few tiles to pay for the relayout

            def emit(bb):
                pa = bb.pack(A, (0, 1), (mb, kb))
                pb = bb.pack(B, (0, 1), (kb, nb), outer_perm=(1, 0))
                pc = bb.pack(C, (0, 1), (mb, nb))
                blocked = bb.blocked_matmul(pa, pb, pc)
                return bb.unpack(blocked, (0, 1), (mb, nb), (M, N))

            res = _insert_before(func, op, b, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed


@register
class PackVNNIPass(Pass):
    """The B operand of bf16 contractions in VNNI layout (the reference's
    PackVNNI): a layout-parity feature; csrc/blocked_matmul.cu reads the
    packed operand in place."""

    name = "pack-vnni"

    def run_on_function(self, func: Function, module: Module) -> bool:
        vf = VNNI
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None:
                continue
            if op.opname == "tl.matmul" and not op.attrs.get("transpose_b") \
                    and op.operands[0].type.dtype in ("bf16", "f16"):
                A, B, C = op.operands
                K, N = B.type.shape
                M = A.type.shape[0]
                if K % vf:
                    continue

                def emit(bb):
                    a3 = bb.reshape(A, (1, M, K))
                    packed = bb.create(
                        "tl.vnni_pack", [B],
                        [B.type.with_shape((K // vf, N, vf))],
                        {"vnni": vf}).result
                    p3 = bb.reshape(packed, (1, K // vf, N, vf))
                    r = bb.create("tl.vnni_brgemm", [a3, p3, C],
                                  [C.type], {"vnni": vf})
                    for key in ("fusion_group", "tile_m", "tile_n", "tile_k"):
                        if key in op.attrs:
                            r.attrs[key] = op.attrs[key]
                    return r.result
            elif op.opname == "tl.brgemm" \
                    and op.operands[0].type.dtype in ("bf16", "f16"):
                A, B, C = op.operands
                Bb, K, N = B.type.shape
                if K % vf:
                    continue

                def emit(bb):
                    packed = bb.create(
                        "tl.vnni_pack", [B],
                        [B.type.with_shape((Bb, K // vf, N, vf))],
                        {"vnni": vf}).result
                    return bb.create("tl.vnni_brgemm", [A, packed, C],
                                     [C.type], {"vnni": vf}).result
            elif op.opname == "tl.blocked_matmul" and not op.attrs.get("vnni") \
                    and op.operands[0].type.dtype in ("bf16", "f16"):
                A, B, C = op.operands
                Nb, Kb, kb, nb = B.type.shape
                if kb % vf:
                    continue

                def emit(bb):
                    packed = bb.create(
                        "tl.vnni_pack", [B],
                        [B.type.with_shape((Nb, Kb, kb // vf, nb, vf))],
                        {"vnni": vf}).result
                    return bb.create("tl.blocked_matmul", [A, packed, C],
                                     [C.type], {"vnni": vf}).result
            else:
                continue
            res = _insert_before(func, op, b, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed


@register
class PropagatePackPass(Pass):
    """Push unpack past eltwise users so epilogues run on the blocked layout
    (the reference's PropagatePackUnPack)."""

    name = "propagate-pack"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        while self._round(func):
            changed = True
        return changed

    def _round(self, func: Function) -> bool:
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.unpack":
                continue
            if len(op.result.uses) != 1:
                continue
            user, uidx = op.result.uses[0]
            packed = op.operands[0]
            attrs = {k: op.attrs[k] for k in
                     ("inner_dims", "inner_tiles") if k in op.attrs}
            if "outer_perm" in op.attrs:
                attrs["outer_perm"] = op.attrs["outer_perm"]

            # unary(unpack(x)) -> unpack(unary(x))
            if user.opname in ELTWISE_UNARY:
                def emit(bb):
                    inner = bb.create(user.opname, [packed], [packed.type],
                                      dict(user.attrs)).result
                    return bb.create("tl.unpack", [inner],
                                     [user.result.type], attrs).result
                res = _insert_before(func, user, b, emit)
                func.replace_all_uses(user.result, res)
                func.erase(user)
                if not op.result.uses:
                    func.erase(op)
                return True

            # add/mul/...(unpack(x), smallvec) -> blocked binary on packed x
            if user.opname in ("tl.add", "tl.sub", "tl.mul", "tl.div",
                               "tl.max") and uidx == 0:
                other = user.operands[1]
                # only [M,N] (+) [N] with C packed [Mb,Nb,mb,nb]
                if (packed.type.rank == 4 and other.type.rank == 1
                        and tuple(op.attrs.get("inner_dims", ())) == (0, 1)
                        and "outer_perm" not in op.attrs):
                    mb_t, nb_t = op.attrs["inner_tiles"]
                    Mb, Nb, mb, nb = packed.type.shape
                    N = other.type.shape[0]
                    if nb_t == nb and Nb * nb == N:
                        def emit(bb):
                            pbias = bb.pack(other, (0,), (nb,))
                            rbias = bb.reshape(pbias, (1, Nb, 1, nb))
                            inner = bb.create(user.opname, [packed, rbias],
                                              [packed.type]).result
                            return bb.create("tl.unpack", [inner],
                                             [user.result.type], attrs).result
                        res = _insert_before(func, user, b, emit)
                        func.replace_all_uses(user.result, res)
                        func.erase(user)
                        if not op.result.uses:
                            func.erase(op)
                        return True

            # binary(unpack(x), unpack(y)) same layout -> unpack(binary(x,y))
            if user.opname in ("tl.add", "tl.sub", "tl.mul", "tl.div",
                               "tl.max"):
                other = user.operands[1 - uidx]
                oop = other.owner
                if (oop is not None and oop.opname == "tl.unpack"
                        and oop.attrs == op.attrs
                        and oop.operands[0].type == packed.type
                        and len(other.uses) == 1):
                    lhs = packed if uidx == 0 else oop.operands[0]
                    rhs = oop.operands[0] if uidx == 0 else packed

                    def emit(bb):
                        inner = bb.create(user.opname, [lhs, rhs],
                                          [packed.type]).result
                        return bb.create("tl.unpack", [inner],
                                         [user.result.type], attrs).result
                    res = _insert_before(func, user, b, emit)
                    func.replace_all_uses(user.result, res)
                    func.erase(user)
                    for dead in (op, oop):
                        if not dead.result.uses and dead.parent is not None:
                            func.erase(dead)
                    return True
        return False


@register
class ConstantFoldPackPass(Pass):
    """pack(constant) / vnni_pack(constant) -> pre-packed constant.

    The folded constant keeps the original init recipe plus the pack recipe
    (`pack_*` attributes); the executor makes and packs it once, when the
    function is compiled (runtime/tensor_init.apply_pack_recipe), so weight
    relayout never runs in the timed loop."""

    name = "constant-fold-pack"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname not in ("tl.pack", "tl.vnni_pack"):
                continue
            src = op.operands[0].owner
            if src is None or src.opname != "tl.constant":
                continue
            attrs = dict(src.attrs)
            # on a second fold (vnni_pack of an already pack-folded
            # constant) keep the true original shape
            attrs.setdefault("orig_shape", tuple(src.result.type.shape))
            if op.opname == "tl.pack":
                attrs["pack_inner_dims"] = tuple(op.attrs["inner_dims"])
                attrs["pack_inner_tiles"] = tuple(op.attrs["inner_tiles"])
                if "outer_perm" in op.attrs:
                    attrs["pack_outer_perm"] = tuple(op.attrs["outer_perm"])
            else:
                attrs["pack_vnni"] = op.attrs.get("vnni", 2)

            def emit(bb):
                return bb.create("tl.constant", [], [op.result.type],
                                 attrs).result

            res = _insert_before(func, op, b, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            if not src.result.uses:
                func.erase(src)
            changed = True
        return changed


@register
class SimplifyPackPass(Pass):
    """pack(unpack(x)) -> x and unpack(pack(x)) -> x when recipes match."""

    name = "simplify-pack"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        for op in list(func.ops):
            if op.parent is None:
                continue
            inner = op.operands[0].owner if op.operands else None
            if inner is None:
                continue
            pair = {op.opname, inner.opname}
            if pair == {"tl.pack", "tl.unpack"} \
                    and op.attrs == inner.attrs \
                    and op.result.type == inner.operands[0].type:
                func.replace_all_uses(op.result, inner.operands[0])
                func.erase(op)
                if not inner.result.uses:
                    func.erase(inner)
                changed = True
        return changed
