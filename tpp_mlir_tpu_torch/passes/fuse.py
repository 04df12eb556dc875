"""tile-and-fuse: fusion-group formation + tile hints.

The grouping is a copy of `tpp_mlir_tpu/passes/fuse.py` (the reference's
TileConsumerAndFuseProducers, consumer-anchored producer BFS), and so is
the register blocking: the pass's `blocks` option (bm, bn, bk), or the
module's `register_blocking` attr (tpp-run's --register-blocking), sets
binding `tile_m/n/k` on the anchor with `register_blocked`, which
convert-tl-to-xsmm carries to the dispatch and the executor puts into the
key's bm/bn/bk (on Hopper: the mainloop's output tile and the depth of one
k slice, xsmm/tune.py). Without it the tiles are unbound hints
(HOPPER_TILE): the executor's keys leave them out, nothing reads them, and
the launcher chooses its own plan.
"""

from __future__ import annotations

import itertools

from ..ir import Function, Module, Operation
from ..ir.matcher import (ELTWISE_BINARY, ELTWISE_UNARY, is_contraction,
                          is_zero_op)
from .pass_manager import Pass, register

FUSABLE_CONSUMERS = ELTWISE_UNARY + ELTWISE_BINARY + ("tl.unpack",)
MAX_DEPTH, NUM_ITERS = 5, 3     # the reference's defaults

# the unbound tile hints, the first brgemm.cu's tile (its f32-FMA body's
# 64 x 64 and 32-deep k step); nothing reads them: the launcher plans on its
# own (csrc/gemm_sm90.cuh gemm_plan) unless register blocking binds a plan
HOPPER_TILE = (64, 64, 32)


def hopper_tiles(m: int, n: int, k: int) -> tuple[int, int, int]:
    tm, tn, tk = HOPPER_TILE
    return min(m, tm), min(n, tn), min(k, tk)


@register
class TileAndFusePass(Pass):
    name = "tile-and-fuse"

    def run_on_function(self, func: Function, module: Module) -> bool:
        changed = False
        for _ in range(NUM_ITERS):
            if not self._round(func, MAX_DEPTH):
                break
            changed = True
        return changed

    def _round(self, func: Function, max_depth: int) -> bool:
        gid_counter = itertools.count(
            max((op.attrs.get("fusion_group", -1) for op in func.ops),
                default=-1) + 1)
        changed = False
        # start from the last op of an eltwise chain and walk operands
        # upward; a producer joins only if all its users are already in the
        # worklist (no recomputation)
        for op in reversed(list(func.ops)):
            if op.parent is None or "fusion_group" in op.attrs:
                continue
            if op.opname not in FUSABLE_CONSUMERS and not is_contraction(op):
                continue
            # roots only: the walk reaches ops whose single use is an
            # ungrouped fusable eltwise from that consumer
            if len(op.results) == 1 and len(op.result.uses) == 1:
                user, _ = op.result.uses[0]
                if user.opname in FUSABLE_CONSUMERS \
                        and "fusion_group" not in user.attrs:
                    continue
            worklist = {op}
            frontier = [op]
            anchor = op if is_contraction(op) else None
            depth = 0
            escaped = {id(v) for v in func.returns}
            while frontier and depth < max_depth:
                nxt = []
                for cur in frontier:
                    for v in cur.operands:
                        p = v.owner
                        if p is None or p in worklist \
                                or "fusion_group" in p.attrs:
                            continue
                        if len(p.results) != 1:
                            continue
                        if id(p.result) in escaped:
                            continue   # value escapes via return
                        if not (p.opname in FUSABLE_CONSUMERS
                                or is_zero_op(p)
                                or (is_contraction(p) and anchor is None)):
                            continue
                        if not all(u in worklist
                                   for u, _ in p.result.uses):
                            continue   # fusing would recompute p elsewhere
                        worklist.add(p)
                        nxt.append(p)
                        if is_contraction(p):
                            anchor = p
                frontier = nxt
                depth += 1
            if anchor is None or len(worklist) < 2:
                continue
            gid = next(gid_counter)
            for g in worklist:
                g.attrs["fusion_group"] = gid
            self._assign_tiles(anchor)
            changed = True
        return changed

    def _assign_tiles(self, anchor: Operation) -> None:
        if anchor.opname == "tl.blocked_matmul":
            return  # block sizes are the packed tile sizes already
        shapes = {
            "tl.matmul": lambda a, b, c: (c.shape[0], c.shape[1], a.shape[1]),
            "tl.brgemm": lambda a, b, c: (c.shape[0], c.shape[1], a.shape[2]),
            "tl.vnni_brgemm": lambda a, b, c: (c.shape[0], c.shape[1],
                                               a.shape[2]),
        }
        get = shapes.get(anchor.opname)
        if get is None:
            return
        a, b, c = (v.type for v in anchor.operands)
        # explicit register blocking (the reference's --registerBlocking)
        # by pass option or module attr binds the kernel's plan; else hints
        rb = self.options.get("blocks")
        if not rb and anchor.parent is not None \
                and anchor.parent.module is not None:
            rb = anchor.parent.module.attrs.get("register_blocking")
        if rb:
            bm, bn, bk = rb
            anchor.attrs["register_blocked"] = True
        else:
            bm, bn, bk = hopper_tiles(*get(a, b, c))
        anchor.attrs.setdefault("tile_m", bm)
        anchor.attrs.setdefault("tile_n", bn)
        anchor.attrs.setdefault("tile_k", bk)
