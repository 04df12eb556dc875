"""split-reduction-dim: serialize a matmul's K dimension into a BRGEMM
batch (a copy of `tpp_mlir_tpu/passes/split_reduction.py`).

The reference's SplitReductionDim (Passes.td:559-576) tiles the reduction
dimension for serialized accumulation. Here the same split turns tl.matmul
into tl.brgemm with batch K/tile: A[M,K] -> A'[B,M,kb], B[K,N] ->
B'[B,kb,N], C += sum_b A'[b] @ B'[b], which convert-tl-to-xsmm lowers to
csrc/brgemm.cu (B1). The pass is in no bundle: a caller runs it ahead of
one, `make_pass("split-reduction-dim", tile=256)`; tile 0 (the default)
leaves the IR as it is.
"""

from __future__ import annotations

from ..ir import Function, Module, TppBuilder
from .pack import _insert_before
from .pass_manager import Pass, register


@register
class SplitReductionDimPass(Pass):
    name = "split-reduction-dim"

    def run_on_function(self, func: Function, module: Module) -> bool:
        tile = self.options.get("tile", 0)
        if not tile:
            return False
        changed = False
        b = TppBuilder(func)
        for op in list(func.ops):
            if op.parent is None or op.opname != "tl.matmul" \
                    or op.attrs.get("transpose_b"):
                continue
            A, B, C = op.operands
            M, K = A.type.shape
            N = B.type.shape[1]
            if K % tile or K == tile:
                continue
            nb = K // tile

            def emit(bb):
                a3 = bb.reshape(A, (M, nb, tile))
                a3 = bb.transpose(a3, (1, 0, 2))     # [B, M, kb]
                b3 = bb.reshape(B, (nb, tile, N))    # [B, kb, N]
                return bb.brgemm(a3, b3, C)

            res = _insert_before(func, op, b, emit)
            func.replace_all_uses(op.result, res)
            func.erase(op)
            changed = True
        return changed
