"""Model FLOP accounting — BENCH_TOTAL_FLOPS for arbitrary IR (a copy of
`count_flops` in `tpp_mlir_tpu/utils/flops.py`, for the copied importer).

The reference computes flops in the generator (MLIRGen.cpp:315-333); here a
module walk covers hand-written and imported IR too (matmul 2MNK; conv
2*N*K*P*Q*C*R*S; eltwise/bias |out|; softmax 4|out|)."""

from __future__ import annotations

from ..ir import Module
from ..ir.matcher import ELTWISE_BINARY, ELTWISE_UNARY


def count_flops(module: Module, func_name: str = "entry") -> int:
    total = 0
    for op in module[func_name].ops:
        name = op.opname
        if name == "tl.matmul":
            m, k = op.operands[0].type.shape
            n = op.results[0].type.shape[1]
            total += 2 * m * n * k
        elif name in ("tl.brgemm", "tl.vnni_brgemm"):
            b, m, k = op.operands[0].type.shape
            n = op.results[0].type.shape[1]
            total += 2 * b * m * n * k
        elif name == "tl.batch_matmul":
            b, m, k = op.operands[0].type.shape
            n = op.results[0].type.shape[2]
            total += 2 * b * m * n * k
        elif name == "tl.blocked_matmul":
            Mb, Kb, mb, kb = op.operands[0].type.shape
            _, Nb, _, nb = op.results[0].type.shape
            total += 2 * Mb * Nb * Kb * mb * nb * kb
        elif name in ("tl.conv2d_nchw_fchw", "tl.conv2d_nhwc_hwcf"):
            w = op.operands[1].type.shape
            o = op.results[0].type.shape
            rs_c = (w[1] * w[2] * w[3] if name.endswith("nchw_fchw")
                    else w[0] * w[1] * w[2])
            total += 2 * o[0] * o[1] * o[2] * o[3] * rs_c
        elif name == "tl.blocked_conv2d":
            Kb, Cb, R, S, c, k = op.operands[1].type.shape
            N, _, P, Q, _ = op.results[0].type.shape
            total += 2 * N * Kb * k * P * Q * Cb * c * R * S
        elif name == "tl.attention":
            B, S_, D = op.operands[0].type.shape
            Skv = op.operands[1].type.shape[1]
            dots = 4 * B * S_ * Skv * D
            if op.attrs.get("causal"):
                dots //= 2   # useful-work convention: triangle only
            total += dots + 4 * B * S_ * Skv
        elif name == "tl.softmax":
            total += 4 * op.results[0].type.num_elements
        elif name in ELTWISE_UNARY or name in ELTWISE_BINARY:
            total += op.results[0].type.num_elements
    return total
