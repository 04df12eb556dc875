"""The loader table of the port's packed GEMM mainloop (csrc/gemm_sm90.cuh):
xsmm/reference.py brgemm_route (B1/B2, csrc/brgemm.cu) and
blocked_matmul_route (B19/B20, csrc/blocked_matmul.cu), pinned for every
key form chip_smoke.py's phase 3 holds on the card. Pure functions of the
key: these run without a card."""

import pytest
import torch

from tpp_mlir_tpu_torch.xsmm import BlockedMatmulKey, BrgemmKey
from tpp_mlir_tpu_torch.xsmm.kernels import _native
from tpp_mlir_tpu_torch.xsmm.reference import (blocked_matmul_route,
                                               brgemm_route)

FC = dict(beta0=True, binary_kind="add", unary_kind="relu")
LN = dict(beta0=True, binary_kind="add", prologue="layer_norm")

BRGEMM = {
    # the MLP's fc and +C keys: f32 "default" is bf16 products, loaded
    # through registers; bf16 by TMA
    "fc-f32": (BrgemmKey(1, 256, 1024, 1024, "f32", **FC), "convert"),
    "fc-bf16": (BrgemmKey(1, 256, 1024, 1024, "bf16", **FC), "tma"),
    "gemm-f32-c": (BrgemmKey(1, 256, 1024, 1024, "f32"), "convert"),
    "gemm-bf16-c": (BrgemmKey(1, 256, 1024, 1024, "bf16"), "tma"),
    # every broadcast of D: the route does not depend on it
    "bcast-row-mul": (BrgemmKey(1, 256, 1024, 1024, "bf16", beta0=True,
                                binary_kind="mul", binary_bcast="bcast_row"),
                      "tma"),
    "bcast-scalar-sub-gelu": (BrgemmKey(1, 256, 1024, 1024, "bf16",
                                        beta0=True, binary_kind="sub",
                                        binary_bcast="bcast_scalar",
                                        unary_kind="gelu"), "tma"),
    "full-add-tanh-f32": (BrgemmKey(1, 256, 1024, 1024, "f32",
                                    binary_kind="add", binary_bcast="none",
                                    unary_kind="tanh"), "convert"),
    # transpose_b reads B [n, k]: only k's stride goes to TMA
    "transpose-b": (BrgemmKey(1, 256, 1024, 1024, "bf16", beta0=True,
                              transpose_b=True), "tma"),
    "transpose-b-odd-n": (BrgemmKey(1, 33, 65, 64, "bf16", beta0=True,
                                    transpose_b=True), "tma"),
    "transpose-b-k60": (BrgemmKey(1, 64, 64, 60, "bf16", beta0=True,
                                  transpose_b=True), "convert"),
    "batch-4": (BrgemmKey(4, 256, 1024, 1024, "bf16", beta0=True), "tma"),
    # VNNI B is un-VNNI'd by the wrapper: the flat B's route
    "vnni-2": (BrgemmKey(1, 256, 1024, 1024, "bf16", beta0=True, vnni=2,
                         binary_kind="add", unary_kind="relu"), "tma"),
    "ragged-f32": (BrgemmKey(1, 1024, 352, 512, "f32", **FC), "convert"),
    "ragged-bf16": (BrgemmKey(1, 1024, 352, 512, "bf16", **FC), "tma"),
    # a row stride TMA cannot take (n 100: 200 bytes) goes to convert
    "misaligned-n100-bf16": (BrgemmKey(1, 1000, 100, 96, "bf16", **FC),
                             "convert"),
    "misaligned-k90-bf16": (BrgemmKey(1, 64, 128, 90, "bf16", **FC),
                            "convert"),
    # the four LayerNorm-prologue keys and the "highest" one
    "ln-gpt2-qkv": (BrgemmKey(1, 2048, 2304, 768, "bf16", **LN), "tma"),
    "ln-gpt2-fc1": (BrgemmKey(1, 2048, 3072, 768, "bf16", unary_kind="gelu",
                              **LN), "tma"),
    "ln-enc-qkv-f32": (BrgemmKey(1, 2048, 3072, 1024, "f32", **LN),
                       "convert"),
    "ln-enc-fc1-f32": (BrgemmKey(1, 2048, 4096, 1024, "f32",
                                 unary_kind="gelu", **LN), "convert"),
    "ln-enc-qkv-highest": (BrgemmKey(1, 2048, 3072, 1024, "f32",
                                     precision="highest", **LN), "fma"),
    # the MLP training step's keys
    "train-fc-highest": (BrgemmKey(1, 256, 1024, 1024, "f32",
                                   precision="highest", **FC), "fma"),
    "train-dx-highest-tb": (BrgemmKey(1, 256, 1024, 1024, "f32",
                                      beta0=True, precision="highest",
                                      transpose_b=True), "fma"),
    "train-fc-2048-bf16": (BrgemmKey(1, 2048, 1024, 1024, "bf16", **FC),
                           "tma"),
    "train-dx-2048-bf16-tb": (BrgemmKey(1, 2048, 1024, 1024, "bf16",
                                        beta0=True, transpose_b=True),
                              "tma"),
}


@pytest.mark.parametrize("name", list(BRGEMM))
def test_brgemm_route(name):
    key, want = BRGEMM[name]
    assert brgemm_route(key) == want


BLOCKED = {
    # the packed fc rows' keys: f32 "default" and bf16 VNNI both convert
    # (VNNI2 is no wgmma layout: re-laid in registers, read in place)
    "fc-f32": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, "f32", **FC),
               "convert"),
    "fc-bf16-vnni": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16",
                                      vnni=2, **FC), "convert"),
    "fc-bf16-flat": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16", **FC),
                     "tma"),
    # a partial mb is masked by TMA's zero fill (4D maps), not a route
    "partial-mb8-bf16": (BlockedMatmulKey(2, 2, 2, 8, 512, 512, "bf16",
                                          **FC), "tma"),
    "partial-mb8-f32": (BlockedMatmulKey(2, 2, 2, 8, 512, 512, "f32", **FC),
                        "convert"),
    "partial-mb8-bf16-vnni": (BlockedMatmulKey(2, 3, 2, 8, 40, 48, "bf16",
                                               vnni=2, **FC), "convert"),
    "misaligned-kb36-bf16": (BlockedMatmulKey(1, 2, 2, 64, 64, 36, "bf16",
                                              **FC), "convert"),
    "misaligned-nb20-bf16": (BlockedMatmulKey(1, 2, 2, 64, 20, 64, "bf16",
                                              **FC), "convert"),
    "highest": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, "f32",
                                 precision="highest", **FC), "fma"),
    "highest-vnni": (BlockedMatmulKey(1, 2, 2, 64, 128, 128, "f32",
                                      precision="highest", vnni=2), "fma"),
    "with-c": (BlockedMatmulKey(1, 2, 2, 64, 128, 128, "bf16"), "tma"),
    # B20's warm bench is its own kernel
    "warm": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, "f32", repeats=200,
                              **FC), "warm"),
    "warm-bf16-vnni": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16",
                                        vnni=2, repeats=3, **FC), "warm"),
}


@pytest.mark.parametrize("name", list(BLOCKED))
def test_blocked_matmul_route(name):
    key, want = BLOCKED[name]
    assert blocked_matmul_route(key) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_operands_keep_their_dtype(dtype):
    """C and D reach the kernel in their stored dtype (f32 or bf16, widened
    in registers): no conversion kernel before the GEMM. A strided operand
    is made contiguous, any other dtype goes to f32."""
    dev = torch.device("cpu")
    c = torch.randn(8, 6).to(dtype).t()
    got = _native(c, "C", 48, dev)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, c)
    half = _native(torch.randn(6, dtype=torch.float16), "D", 6, dev)
    assert half.dtype == torch.float32
    with pytest.raises(ValueError, match="expected 7"):
        _native(torch.randn(6), "D", 7, dev)
