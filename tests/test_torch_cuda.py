"""The Hopper kernels on the card, against their plain versions.

Marked `cuda`: without an NVIDIA card every test here skips. On the card,
where JAX is absent, run them without tests/conftest.py (which imports it):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Error measure: max|kernel - plain| / max|plain|. 1e-4 where both sides round
the operands the same way and only the sum order differs: a single GEMM
with an f32 output (f32 "default" included), an f32 "highest" chain,
attention or LayerNorm-prologue GEMM, and an f32 LayerNorm. 1e-2 for a bf16
output, for chains that re-round each layer's input to bf16, for attention
in the bf16 MXU dtype (the kernel rounds unnormalized P and divides by the
row sum after P.V, the plain version normalizes P first, as B7 does) and
for a LayerNorm prologue that rounds its f32 result to bf16, where a
sum-order difference can flip a rounding; an f32 "default" chain (one pass)
must also sit nearer the "default" plain version than the "highest" one.
"""

import dataclasses
import io

import pytest
import torch

import chip_smoke
from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.models.mlp import MlpConfig
from tpp_mlir_tpu_torch.tools.mlir_gen import generate_text
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                     BrgemmKey, ChainKey, ConvBrgemmKey,
                                     ConvNhwcKey, DecodeAttnKey, FlashMhaKey,
                                     FlashTrainBwdKey,
                                     FlashTrainKey, GroupedGemmKey,
                                     GroupedWgradKey, Int8GemmKey,
                                     LayerNormKey, build_kernel,
                                     global_cache, reference_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _err(got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30)


def _tol(key):
    if isinstance(key, BrgemmKey):
        return 1e-4 if (key.out_dtype or key.dtype) == "f32" else 1e-2
    return 1e-4 if key.dtype == "f32" and key.precision == "highest" \
        else 1e-2


def _rnd(g, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(
        {"f32": torch.float32, "bf16": torch.bfloat16,
         "f16": torch.float16}[dtype])


@pytest.mark.parametrize("key", [
    BrgemmKey(1, 100, 72, 40, "f32", beta0=True, binary_kind="add",
              unary_kind="relu"),
    BrgemmKey(1, 64, 64, 64, "f32", precision="highest"),
    BrgemmKey(3, 48, 80, 96, "bf16", beta0=True, binary_kind="max",
              binary_bcast="bcast_row", unary_kind="gelu_tanh"),
    BrgemmKey(1, 33, 65, 64, "bf16", out_dtype="f32", beta0=True,
              transpose_b=True, binary_kind="div",
              binary_bcast="bcast_scalar", unary_kind="exp"),
    BrgemmKey(2, 64, 32, 64, "bf16", vnni=2, binary_kind="add",
              binary_bcast="none", unary_kind="square"),
], ids=["ragged-fc", "highest-C", "batch-row-max", "tb-scalar-div",
        "vnni-full"])
def test_brgemm_kernel_matches_plain(cuda, key):
    g = cuda
    a = _rnd(g, (key.batch, key.m, key.k), key.dtype)
    if key.vnni:
        b = _rnd(g, (key.batch, key.k // 2, key.n, 2), key.dtype, 0.1)
    elif key.transpose_b:
        b = _rnd(g, (key.batch, key.n, key.k), key.dtype, 0.1)
    else:
        b = _rnd(g, (key.batch, key.k, key.n), key.dtype, 0.1)
    c = None if key.beta0 else _rnd(g, (key.m, key.n), "f32")
    shape = {"bcast_col": (key.n,), "bcast_row": (key.m, 1),
             "bcast_scalar": (), "none": (key.m, key.n)}[key.binary_bcast]
    d = _rnd(g, shape, "f32") + (3.0 if key.binary_kind == "div" else 0.0) \
        if key.binary_kind else None
    kern = build_kernel(key)
    got = kern(a, b, c, d)
    want = reference_kernel(key)(a, b, c, d)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert _err(got, want) <= _tol(key)


# the packed GEMM mainloop (csrc/gemm_sm90.cuh) on each of its routes
# (reference.brgemm_route / blocked_matmul_route) at ragged m, n and k: a
# partial tile, a partial 64-deep k slice, and TMA's zero fill or the
# convert loader's masks at every edge; C and D in bf16 read as stored
GEMM_ROUTES = {
    "tma-ragged": (BrgemmKey(1, 77, 136, 200, "bf16", binary_kind="add",
                             unary_kind="gelu"), "tma"),
    "tma-tb-odd-n-f32-out": (BrgemmKey(2, 130, 65, 72, "bf16",
                                       out_dtype="f32", beta0=True,
                                       transpose_b=True, binary_kind="mul",
                                       binary_bcast="bcast_row"), "tma"),
    "convert-f32-ragged": (BrgemmKey(1, 77, 100, 90, "f32",
                                     binary_kind="add", binary_bcast="none",
                                     unary_kind="relu"), "convert"),
    "convert-bf16-misaligned": (BrgemmKey(1, 77, 100, 90, "bf16",
                                          beta0=True, binary_kind="sub",
                                          binary_bcast="bcast_scalar"),
                                "convert"),
    "convert-f32-tb-batch3": (BrgemmKey(3, 100, 72, 136, "f32", beta0=True,
                                        transpose_b=True), "convert"),
    "fma-highest-ragged": (BrgemmKey(1, 77, 100, 90, "f32",
                                     precision="highest", binary_kind="add",
                                     unary_kind="tanh"), "fma"),
    "ln-tma-ragged": (BrgemmKey(1, 77, 136, 200, "bf16", beta0=True,
                                binary_kind="add", prologue="layer_norm"),
                      "tma"),
    "ln-convert-f32-ragged": (BrgemmKey(1, 77, 100, 90, "f32", beta0=True,
                                        binary_kind="add", unary_kind="gelu",
                                        prologue="layer_norm"), "convert"),
    "ln-convert-bf16-no-affine": (BrgemmKey(1, 77, 100, 90, "bf16",
                                            prologue="layer_norm",
                                            prologue_affine=False),
                                  "convert"),
}


@pytest.mark.parametrize("name", list(GEMM_ROUTES))
def test_brgemm_routes_match_plain_at_ragged_shapes(cuda, name):
    from tpp_mlir_tpu_torch.xsmm.reference import brgemm_route
    key, route = GEMM_ROUTES[name]
    assert brgemm_route(key) == route
    g = cuda
    a = _rnd(g, (key.batch, key.m, key.k), key.dtype) * 2 + 0.5
    b = _rnd(g, (key.batch, key.n, key.k) if key.transpose_b
             else (key.batch, key.k, key.n), key.dtype, 0.1)
    c = None if key.beta0 else _rnd(g, (key.m, key.n), key.dtype)
    shape = {"bcast_col": (key.n,), "bcast_row": (key.m, 1),
             "bcast_scalar": (), "none": (key.m, key.n)}[key.binary_bcast]
    d = _rnd(g, shape, key.dtype) if key.binary_kind else None
    gamma, beta = _rnd(g, (key.k,), "f32"), _rnd(g, (key.k,), "f32")
    kern = build_kernel(key)
    got = kern(a, b, c, d, gamma, beta)
    want = reference_kernel(key)(a, b, c, d, gamma, beta)
    torch.cuda.synchronize()
    assert kern.launches == 1 and got.shape == want.shape
    tol = 1e-2 if key.prologue and key.precision != "highest" else _tol(key)
    assert _err(got, want) <= tol


BLOCKED_ROUTES = {
    "tma-partial-blocks": (BlockedMatmulKey(2, 3, 2, 40, 72, 56, "bf16",
                                            binary_kind="add",
                                            unary_kind="relu"), "tma"),
    "convert-f32-mb8": (BlockedMatmulKey(2, 2, 3, 8, 48, 40, "f32",
                                         binary_kind="add",
                                         unary_kind="gelu"), "convert"),
    "convert-vnni-mb8-f32-out": (BlockedMatmulKey(2, 3, 2, 8, 40, 48, "bf16",
                                                  out_dtype="f32", vnni=2,
                                                  beta0=True,
                                                  binary_kind="add"),
                                 "convert"),
    "convert-bf16-misaligned": (BlockedMatmulKey(1, 2, 2, 33, 20, 36, "bf16",
                                                 beta0=True), "convert"),
    "fma-highest-vnni": (BlockedMatmulKey(1, 2, 2, 24, 40, 48, "f32",
                                          precision="highest", vnni=2,
                                          binary_kind="add"), "fma"),
}


@pytest.mark.parametrize("name", list(BLOCKED_ROUTES))
def test_blocked_matmul_routes_match_plain_at_ragged_shapes(cuda, name):
    from tpp_mlir_tpu_torch.xsmm.reference import blocked_matmul_route
    key, route = BLOCKED_ROUTES[name]
    assert blocked_matmul_route(key) == route
    g = cuda
    a = _rnd(g, (key.Mb, key.Kb, key.mb, key.kb), key.dtype)
    b = _rnd(g, (key.Nb, key.Kb, key.kb, key.nb), key.dtype,
             (key.Kb * key.kb) ** -0.5)
    if key.vnni:
        b = b.reshape(key.Nb, key.Kb, key.kb // 2, 2, key.nb) \
            .movedim(-2, -1).contiguous()
    c = None if key.beta0 else _rnd(g, (key.Mb, key.Nb, key.mb, key.nb),
                                    key.dtype)
    d = _rnd(g, (key.Nb, key.nb), key.dtype) if key.binary_kind else None
    kern = build_kernel(key)
    got = kern(a, b, c, d)
    want = reference_kernel(key)(a, b, c, d)
    torch.cuda.synchronize()
    assert kern.launches == 1 and got.shape == want.shape
    assert _err(got, want) <= (1e-4 if (key.out_dtype or key.dtype) == "f32"
                               else 1e-2)


@pytest.mark.parametrize("key", [
    BrgemmKey(1, 256, 1024, 1024, "f32", beta0=True, binary_kind="add",
              unary_kind="relu"),
    BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16", vnni=2, beta0=True,
                     binary_kind="add", unary_kind="relu"),
], ids=["brgemm-fc-f32", "blocked-fc-bf16-vnni"])
def test_split_k_plan_is_bit_repeatable(cuda, key):
    """The fc keys' grid is under one wave, so the launcher splits k; the
    partials are summed in slice order: two runs agree bit for bit."""
    from tpp_mlir_tpu_torch.xsmm.kernels import gemm_plan
    assert gemm_plan(key)[2] > 1
    g = cuda
    if isinstance(key, BrgemmKey):
        args = (_rnd(g, (1, key.m, key.k), key.dtype),
                _rnd(g, (1, key.k, key.n), key.dtype, key.k ** -0.5), None,
                _rnd(g, (key.n,), "f32"))
    else:
        args = (_rnd(g, (key.Mb, key.Kb, key.mb, key.kb), key.dtype),
                _rnd(g, (key.Nb, key.Kb, key.kb // 2, key.nb, 2), key.dtype,
                     (key.Kb * key.kb) ** -0.5), None,
                _rnd(g, (key.Nb, key.nb), "f32"))
    kern = build_kernel(key)
    first, second = kern(*args), kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _err(first, want) <= _tol(key)


@pytest.mark.parametrize("key", [
    BrgemmKey(1, 64, 64, 64, "bf16", beta0=True),
    BlockedMatmulKey(1, 1, 1, 64, 64, 64, "bf16", beta0=True),
], ids=["brgemm", "blocked"])
def test_tma_route_refuses_a_misaligned_base(cuda, key):
    """A contiguous A two bytes past a 16-byte boundary: TMA cannot take
    it, and the wrapper raises rather than launch."""
    n = 64 * 64
    buf = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")
    shape = (1, 64, 64) if isinstance(key, BrgemmKey) else (1, 1, 64, 64)
    a = buf[1:1 + n].view(shape)
    assert a.is_contiguous() and a.data_ptr() % 16
    b = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        build_kernel(key)(a, b)


# sha256 of B16's and B17's outputs from scripts/port_gemm_times.py
# grouped_digests, as the parent commit's kernels gave them on an NVIDIA
# H100 80GB HBM3: consume_ring moved into csrc/gemm_sm90.cuh and B16/B17
# must stay bit for bit what they were
GROUPED_DIGESTS = {
    "B16 gelu":
        "bb27b1038932ce55cf4a5c91d6919839db4585a1c0fa450d0e52b5b0eb07e8b7",
    "B16 transpose_b":
        "45dded48cec4a70a3854cacf63f089ff885fd30c46597aa46b1b3b0deef1dc7c",
    "B17 dw":
        "1bc15fd59c0a658d2725f4b16a6e04f130d55cbd146700343f36b68656531e27",
}


def test_grouped_outputs_bit_identical_to_before_the_ring_moved(cuda):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "port_gemm_times.py"
    spec = importlib.util.spec_from_file_location("port_gemm_times", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.grouped_digests() == GROUPED_DIGESTS


@pytest.mark.parametrize("key", [
    ChainKey(m=40, dims=(64, 128, 32), dtype="bf16", unary_kind="gelu",
             last_unary=None),
    ChainKey(m=17, dims=(48, 48, 48), precision="highest", has_bias=False),
    ChainKey(m=64, dims=(64, 64, 64), repeats=5),
    ChainKey(m=64, dims=(256, 256, 256, 256)),
    ChainKey(m=256, dims=(1024,) * 4, dtype="bf16"),
    ChainKey(m=256, dims=(1024,) * 4, dtype="bf16", repeats=8),
    ChainKey(m=256, dims=(1024,) * 4, repeats=8),
    ChainKey(m=17, dims=(48, 160, 48), dtype="bf16"),
    ChainKey(m=40, dims=(160, 48, 160), repeats=3),
], ids=["bf16-gelu", "highest-ragged-rows", "f32-repeats", "f32-default",
        "flagship-bf16", "flagship-bf16-r8", "flagship-f32-r8",
        "ragged-masked-bf16", "ragged-masked-f32-r3"])
def test_chain_kernel_matches_plain(cuda, key):
    g = cuda
    args = [_rnd(g, (key.m, key.dims[0]), key.dtype)]
    for i in range(len(key.dims) - 1):
        args.append(_rnd(g, (key.dims[i], key.dims[i + 1]), key.dtype,
                         key.dims[i] ** -0.5))
        if key.has_bias:
            args.append(_rnd(g, (key.dims[i + 1],), key.dtype, 0.1))
    got = build_kernel(key)(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert _err(got, want) <= _tol(key)
    if key.dtype == "f32" and key.precision == "default" and \
            key.repeats == 1:
        # f32 "default" means bf16 operands: a true-f32 kernel would sit
        # nearer the "highest" plain version
        hi = reference_kernel(dataclasses.replace(key, precision="highest"))
        assert _err(got, want) < _err(got, hi(*args))


@pytest.mark.parametrize("key", [
    BrgemmKey(1, 100, 72, 200, "bf16", beta0=True, binary_kind="add",
              unary_kind="gelu", prologue="layer_norm"),
    BrgemmKey(1, 64, 96, 128, "f32", precision="highest",
              prologue="layer_norm", prologue_affine=False),
    BrgemmKey(1, 128, 192, 256, "f32", beta0=True, binary_kind="add",
              prologue="layer_norm"),
], ids=["bf16-gelu-ragged", "highest-C-no-affine", "f32-default"])
def test_ln_prologue_gemm_matches_plain(cuda, key):
    g = cuda
    a = _rnd(g, (1, key.m, key.k), key.dtype) * 2 + 0.5
    b = _rnd(g, (1, key.k, key.n), key.dtype, 0.1)
    c = None if key.beta0 else _rnd(g, (key.m, key.n), "f32")
    d = _rnd(g, (key.n,), "f32") if key.binary_kind else None
    gamma, beta = _rnd(g, (key.k,), "f32"), _rnd(g, (key.k,), "f32")
    kern = build_kernel(key)
    got = kern(a, b, c, d, gamma, beta)
    want = reference_kernel(key)(a, b, c, d, gamma, beta)
    torch.cuda.synchronize()
    assert kern.launches == 1
    tol = 1e-4 if key.precision == "highest" else 1e-2
    assert _err(got, want) <= tol


@pytest.mark.parametrize("key", [
    FlashMhaKey(2, 128, 128, 64, "bf16", scale=0.125, causal=True, heads=2,
                qkv_packed=True),
    FlashMhaKey(2, 100, 100, 128, "f32", scale=128 ** -0.5, heads=2),
    FlashMhaKey(1, 96, 160, 64, "f32", scale=0.125, causal=True,
                precision="highest", heads=3),
    FlashMhaKey(2, 128, 128, 32, "bf16", scale=32 ** -0.5, heads=4,
                qkv_packed=True, strategy="tokens"),
    FlashMhaKey(1, 64, 64, 128, "f32", scale=128 ** -0.5, precision="highest",
                heads=1, qkv_packed=True),
    FlashMhaKey(2, 128, 128, 64, "bf16", scale=0.125, causal=True, heads=3),
], ids=["bf16-causal-packed-d64", "f32-ragged-d128", "highest-causal-skv",
        "bf16-packed-d32", "highest-packed-d128", "bf16-causal-split-d64"])
def test_attention_kernel_matches_plain(cuda, key):
    g = cuda
    E = key.heads * key.head_dim
    if key.qkv_packed:
        args = [_rnd(g, (key.batch, key.seq, 3 * E), key.dtype)] * 3
    else:
        args = [_rnd(g, (key.batch, s, E), key.dtype)
                for s in (key.seq, key.seq_kv, key.seq_kv)]
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 1 and got.shape == want.shape
    tol = 1e-4 if key.precision == "highest" else 1e-2
    assert _err(got, want) <= tol


# csrc/attention.cu's wgmma kernel at its edges: ragged S (77, 1000),
# seq_kv != seq, causal with S below the block's 128 rows, D 32/64/128,
# packed and split, repeats 2 (B11), on the TMA loader (bf16) and the
# register loader (f32 "default")
ATTN_EDGES = {
    "s77-flat-d64": FlashMhaKey(3, 77, 77, 64, "bf16", scale=0.125),
    "s77-causal-tokens-d128": FlashMhaKey(2, 77, 77, 128, "bf16",
                                          scale=0.09, causal=True, heads=2),
    "s1000-causal-packed-d64": FlashMhaKey(2, 1000, 1000, 64, "bf16",
                                           scale=0.125, causal=True,
                                           heads=2, qkv_packed=True),
    "skv160-s96-split-d64": FlashMhaKey(1, 96, 160, 64, "bf16", scale=0.125,
                                        heads=3),
    "skv160-s96-causal-flat-d32": FlashMhaKey(2, 96, 160, 32, "bf16",
                                              scale=0.2, causal=True),
    "skv70-s200-flat-d128": FlashMhaKey(2, 200, 70, 128, "bf16",
                                        scale=0.09),
    "causal-s50-packed-d32": FlashMhaKey(2, 50, 50, 32, "bf16", scale=0.2,
                                         causal=True, heads=4,
                                         qkv_packed=True),
    "repeats2-flat-d128": FlashMhaKey(3, 200, 200, 128, "bf16", scale=0.09,
                                      repeats=2),
    "repeats2-causal-tokens-d32": FlashMhaKey(2, 130, 130, 32, "bf16",
                                              scale=0.2, causal=True,
                                              heads=3, repeats=2),
    "f32-convert-skv180-d128": FlashMhaKey(2, 100, 180, 128, "f32",
                                           scale=0.09, heads=2),
    "f32-convert-causal-packed-d32": FlashMhaKey(2, 77, 77, 32, "f32",
                                                 scale=0.2, causal=True,
                                                 heads=4, qkv_packed=True),
    "f32-convert-repeats2-d64": FlashMhaKey(2, 256, 256, 64, "f32",
                                            scale=0.125, repeats=2),
}


@pytest.mark.parametrize("name", list(ATTN_EDGES))
def test_attention_wgmma_edges_match_plain(cuda, name):
    from tpp_mlir_tpu_torch.xsmm.reference import attention_loader
    key = ATTN_EDGES[name]
    assert attention_loader(key) == ("tma" if key.dtype == "bf16"
                                     else "convert")
    g = cuda
    E = (key.heads or 1) * key.head_dim
    if key.qkv_packed:
        args = [_rnd(g, (key.batch, key.seq, 3 * E), key.dtype)] * 3
    else:
        args = [_rnd(g, (key.batch, s, E), key.dtype)
                for s in (key.seq, key.seq_kv, key.seq_kv)]
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 1 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= 1e-2


def test_attention_bf16_register_loader_matches_plain(cuda):
    # the route reference.attention_loader gives a bf16 key whose strides
    # TMA cannot take; no head_dim attention.cu instantiates makes one, so
    # the C entry is called with that loader (code 2) directly
    import ctypes

    from tpp_mlir_tpu_torch.xsmm.build import check, library
    from tpp_mlir_tpu_torch.xsmm.reference import LOG2E
    key = FlashMhaKey(2, 150, 150, 64, "bf16", scale=0.125, causal=True,
                      heads=3, qkv_packed=True)
    E = 3 * 64
    x = _rnd(cuda, (2, 150, 3 * E), "bf16")
    out = torch.empty(2, 150, E, dtype=torch.bfloat16, device="cuda")
    ptrs = [x.data_ptr() + g * E * 2 for g in range(3)]
    check(library().tpp_attention(
        *ptrs, out.data_ptr(), 2, 150, 150, 3, 64, 3 * E, 1, 2, 1, 1, 0,
        0.125 * LOG2E,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)),
        "attention bf16 register loader")
    want = reference_kernel(key)(x, x, x)
    torch.cuda.synchronize()
    assert _err(out, want) <= 1e-2


# B12's keys, with the route layer_norm_route gives each: the register
# template's edges (1 and 8 vectors a lane) and one width past them
LN_CASES = [
    ("bf16-768", LayerNormKey(m=100, n=768, dtype="bf16"), "register"),
    ("f32-1024-no-affine", LayerNormKey(m=64, n=1024, dtype="f32",
                                        affine=False), "register"),
    ("f32-in-bf16-out", LayerNormKey(m=33, n=200, dtype="f32",
                                     out_dtype="bf16", eps=1e-6),
     "register"),
    ("ln-f-2048x768", LayerNormKey(m=2048, n=768, dtype="bf16"), "register"),
    ("bf16-8-one-vector", LayerNormKey(m=17, n=8, dtype="bf16"), "register"),
    ("bf16-2048-edge", LayerNormKey(m=40, n=2048, dtype="bf16"), "register"),
    ("bf16-2056-past", LayerNormKey(m=40, n=2056, dtype="bf16"), "strided"),
    ("f32-1028-past", LayerNormKey(m=9, n=1028, dtype="f32"), "strided"),
    ("bf16-100-ragged", LayerNormKey(m=5, n=100, dtype="bf16"), "strided"),
]


@pytest.mark.parametrize("g_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,key,route", LN_CASES,
                         ids=[c[0] for c in LN_CASES])
def test_layer_norm_kernel_matches_plain(cuda, name, key, route, g_dtype):
    """Both bodies (the key's own and the first design forced) against the
    plain version, gamma and beta read in their stored dtype."""
    from tpp_mlir_tpu_torch.xsmm.kernels import build_layer_norm
    from tpp_mlir_tpu_torch.xsmm.reference import layer_norm_route
    g = cuda
    assert layer_norm_route(key) == route
    x = _rnd(g, (key.m, key.n), key.dtype) * 3 + 1
    gamma, beta = _rnd(g, (key.n,), g_dtype), _rnd(g, (key.n,), g_dtype)
    kern = build_kernel(key)
    got = kern(x, gamma, beta)
    old = build_layer_norm(key, "strided")(x, gamma, beta)
    want = reference_kernel(key)(x, gamma, beta)
    torch.cuda.synchronize()
    assert kern.launches == 1
    tol = 1e-4 if (key.out_dtype or key.dtype) == "f32" else 1e-2
    assert _err(got, want) <= tol
    assert _err(old, want) <= tol
    if route == "strided":
        with pytest.raises(ValueError, match="cannot run"):
            build_layer_norm(key, "register")


@pytest.mark.parametrize("layers,invoke", [
    ((128, 128, 128, 128), "ChainKey"), ((128, 96), "BrgemmKey")])
def test_main_path_on_the_card_matches_linalg_to_loops(cuda, layers, invoke):
    cfg = MlpConfig(batch=64, layers=layers, bias=True, relu=True,
                    float_type="bf16")
    cache = global_cache()
    cache.reset_launches()
    got = run_module(parse_module(generate_text(cfg)), device="cuda",
                     out_stream=io.StringIO())["outputs"][0]
    assert cache.launches_by_kind().get(invoke, 0) == 1
    want = run_module(parse_module(generate_text(cfg)), device="cuda",
                      linalg_to_loops=True,
                      out_stream=io.StringIO())["outputs"][0]
    assert _err(got, want) <= 1e-2


def test_trace_times_each_invoke_of_a_gpt(cuda):
    from tpp_mlir_tpu_torch.tools.bench_driver import build_module
    from tpp_mlir_tpu_torch.tools.trace import trace_module
    res = trace_module(build_module({"model": (
        'gpt:{"batch": 1, "seq": 128, "vocab": 256, "embed": 128, '
        '"heads": 2, "layers": 2, "dtype": "bf16"}')}), iters=2, n=0)
    assert "bench" not in res      # ids -> logits: no perf.bench wrapper
    names = {name.split()[0]: n for name, n, ms in res["invokes"]}
    assert names["attention"] == 2 and names["layer_norm"] == 1
    assert all(ms > 0 for _, _, ms in res["invokes"])


def test_trace_sees_the_chain_kernel(cuda):
    from tpp_mlir_tpu_torch.tools.trace import trace_module
    cfg = MlpConfig(batch=64, layers=(128, 128, 128), bias=True, relu=True,
                    float_type="bf16")
    res = trace_module(parse_module(generate_text(cfg)), iters=3, n=5)
    for region in ("eager", "bench"):
        r = res[region]
        assert 0.0 <= r["idle_share"] < 1.0 and r["busy_ms"] > 0.0
        # chain.cu runs a bf16 chain on csrc/warm_panel.cuh's kernel
        assert any("warm_panel_kernel" in name for _, name in r["shares"])


# -- the serving kernels (B13 decode attention, B15 int8 GEMM) --------------

@pytest.mark.parametrize("key,pos", [
    (DecodeAttnKey(4, 6, 256, 64, "bf16", stacked=3), [200]),
    (DecodeAttnKey(4, 6, 256, 64, "bf16", slotted=True, stacked=3),
     [0, 256, 100, 255]),
    (DecodeAttnKey(4, 2, 256, 64, "bf16", groups=3, stacked=3), [130]),
    (DecodeAttnKey(4, 6, 256, 64, "bf16", kv_quant=True, stacked=3), [77]),
    (DecodeAttnKey(4, 6, 256, 64, "bf16", pack2=True, stacked=3), [199]),
    (DecodeAttnKey(2, 2, 128, 128, "f32", groups=8, kv_quant=True,
                   stacked=3), [127]),
    (DecodeAttnKey(2, 4, 64, 32, "f32", stacked=3), [40]),
], ids=["mha-bf16", "slotted-sentinel", "gqa-g3", "int8-kv", "pack2",
        "d128-g8-f32-int8", "d32-f32"])
def test_decode_attn_kernel_matches_plain(cuda, key, pos):
    """1e-4: the kernel and its plain version compute in f32 from the same
    values and differ in summation order only."""
    q, k, v, pos, kw = _decode_inputs(cuda, key, pos)
    kern = build_kernel(key)
    got = kern(q, k, v, pos, 1, **kw)
    want = reference_kernel(key)(q, k, v, pos, 1, **kw)
    torch.cuda.synchronize()
    assert kern.launches == 1 and got.shape == want.shape
    assert _err(got, want) <= 1e-4


def _decode_inputs(g, key, pos):
    """q, a stacked cache of `key.stacked` layers (int8 payloads with f32
    scales for kv_quant), pos on the card, and the scales as keywords."""
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    L = key.stacked
    if key.pack2:
        q_shape, slab = (B, H // 2, 2 * D), (L, B, H // 2, S, 2 * D)
    else:
        q_shape = (B, H, D) if G == 1 else (B, H, G, D)
        slab = (L, B, H, S, D)
    q = _rnd(g, q_shape, key.dtype)
    kw = {}
    if key.kv_quant:
        k = torch.randint(-127, 128, slab, generator=g, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, slab, generator=g, device="cuda",
                          dtype=torch.int8)
        kw = {n: torch.rand(slab[:4], generator=g, device="cuda") * 0.02
              for n in ("k_s", "v_s")}
    else:
        k, v = _rnd(g, slab, key.dtype), _rnd(g, slab, key.dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q, k, v, pos, kw


# decode_attn.cu's split edges: 64-row chunks (reference.decode_attn_plan),
# pos 0 (splits with no live row), 63 and 64 (a chunk edge: one whole
# chunk, then a chunk of one row), S - 1, S (a free slot: every row)
@pytest.mark.parametrize("key,pos", [
    (DecodeAttnKey(5, 2, 512, 64, "bf16", slotted=True, stacked=2),
     [0, 63, 64, 511, 512]),
    (DecodeAttnKey(2, 4, 256, 128, "f32", groups=8, stacked=2), [191]),
    (DecodeAttnKey(3, 2, 384, 32, "bf16", slotted=True, kv_quant=True,
                   stacked=2), [383, 127, 128]),
    (DecodeAttnKey(2, 4, 512, 64, "bf16", pack2=True, stacked=2), [300]),
    (DecodeAttnKey(8, 12, 1024, 64, "bf16", stacked=12), [639]),
], ids=["slotted-edges", "d128-g8-f32", "int8-slotted", "pack2",
        "serving-key"])
def test_decode_attn_split_edges_are_bit_repeatable(cuda, key, pos):
    """Within 1e-4 of the plain version, bit-equal across launches (the
    splits merge in split order whatever order the blocks ran in), and the
    merge's arrival counters left at zero for the next launch."""
    from tpp_mlir_tpu_torch.xsmm.kernels import _DECODE_COUNTS
    from tpp_mlir_tpu_torch.xsmm.reference import decode_attn_plan
    assert decode_attn_plan(key)[1] > 1
    q, k, v, pos, kw = _decode_inputs(cuda, key, pos)
    kern = build_kernel(key)
    got = kern(q, k, v, pos, 1, **kw)
    again = kern(q, k, v, pos, 1, **kw)
    want = reference_kernel(key)(q, k, v, pos, 1, **kw)
    torch.cuda.synchronize()
    assert kern.launches == 2
    assert torch.equal(got, again)
    assert _err(got, want) <= 1e-4
    assert int(_DECODE_COUNTS[torch.cuda.current_device()].abs().sum()) == 0


def test_decode_attn_graph_replays_right_at_every_position(cuda):
    """pos is read on the card: one captured graph, replayed after pos
    moves in place, matches the plain version at each position."""
    key = DecodeAttnKey(4, 6, 512, 64, "bf16", slotted=True, stacked=2)
    q, k, v, pos, _ = _decode_inputs(cuda, key, [10, 200, 512, 511])
    kern = build_kernel(key)
    kern(q, k, v, pos, 1)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kern(q, k, v, pos, 1)
    for p in ([10, 200, 512, 511], [0, 64, 65, 127], [511, 63, 1, 300]):
        pos.copy_(torch.tensor(p, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert _err(out, reference_kernel(key)(q, k, v, pos, 1)) <= 1e-4


# B15's keys: the cuda tests' first three, the int8 prefill's four (B 8 x S
# 512 rows: QKV/out projection, fc1 + gelu, fc2, the LM head), a ragged m
# and n (masked stores), and a key whose plan splits k
INT8_CASES = [
    ("bias-f32", Int8GemmKey(m=256, n=384, k=768, has_bias=True)),
    ("ragged-gelu-bf16", Int8GemmKey(m=33, n=200, k=64, has_bias=True,
                                     unary_kind="gelu", out_dtype="bf16")),
    ("lm-head-width", Int8GemmKey(m=128, n=50304, k=128)),
    ("prefill-qkv", Int8GemmKey(m=4096, n=768, k=768, has_bias=True)),
    ("prefill-fc1", Int8GemmKey(m=4096, n=3072, k=768, has_bias=True,
                                unary_kind="gelu")),
    ("prefill-fc2", Int8GemmKey(m=4096, n=768, k=3072, has_bias=True)),
    ("prefill-lm-head", Int8GemmKey(m=4096, n=50304, k=768)),
    ("ragged-m-n", Int8GemmKey(m=1000, n=1001, k=784, has_bias=True,
                               unary_kind="gelu")),
    ("split-k", Int8GemmKey(m=64, n=256, k=3072, has_bias=True,
                            unary_kind="relu")),
]
INT8_PARAMS = [(name, key, bdt) for name, key in INT8_CASES
               for bdt in (("bf16", "f32") if key.has_bias else (None,))]


@pytest.mark.parametrize(
    "name,key,bias_dtype", INT8_PARAMS,
    ids=[f"{n}-{b}" if b else n for n, _, b in INT8_PARAMS])
def test_int8_gemm_kernel_matches_plain(cuda, name, key, bias_dtype):
    """The s32 product is exact on both sides and the epilogue runs the same
    f32 operations in the same order: 1e-5 for an f32 output, 1e-2 for
    bf16. The wgmma body is bit-equal across launches, without the K-major
    copy (the wrapper makes one) and to the first design forced."""
    from tpp_mlir_tpu_torch.xsmm.kernels import build_int8
    from tpp_mlir_tpu_torch.xsmm.reference import int8_gemm_route
    g = cuda
    assert int8_gemm_route(key) == "wgmma"
    xq = torch.randint(-127, 128, (key.m, key.k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (key.k, key.n), generator=g, device="cuda",
                       dtype=torch.int8)
    args = [xq, wq, torch.rand(key.m, generator=g, device="cuda") * 0.01,
            torch.rand(1, key.n, generator=g, device="cuda") * 0.01]
    if key.has_bias:
        args.append(_rnd(g, (key.n,), bias_dtype))
    wt = wq.t().contiguous()
    kern = build_kernel(key)
    got = kern(*args, wt=wt)
    again = kern(*args, wt=wt)
    own_copy = kern(*args)
    old = build_int8(key, "wmma")(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 3
    assert _err(got, want) <= (1e-5 if key.out_dtype == "f32" else 1e-2)
    assert torch.equal(got, again)
    assert torch.equal(got, own_copy)
    assert torch.equal(got, old)


def _serving_model(kv_quant=None, **kw):
    from tpp_mlir_tpu_torch.serving import GptConfig, init_params
    cfg = GptConfig(vocab=512, embed=256, heads=4, layers=2, max_seq=128,
                    dtype="bf16", kv_quant=kv_quant, **kw)
    return cfg, init_params(cfg, seed=0, device="cuda")


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_graph_replay_equals_eager(cuda, kv_quant):
    from tpp_mlir_tpu_torch.serving import make_generate
    cfg, params = _serving_model(kv_quant)
    ids = torch.randint(0, cfg.vocab, (4, 32), generator=cuda,
                        device="cuda", dtype=torch.int32)
    cache = global_cache()
    cache.reset_launches()
    eager = make_generate(cfg, 8, graph=False)(params, ids)
    counts = cache.launches_by_kind()
    assert counts["DecodeAttnKey"] == cfg.layers * 7
    assert counts["FlashMhaKey"] == cfg.layers
    graphed = make_generate(cfg, 8)(params, ids)
    assert torch.equal(graphed, eager)


@pytest.mark.parametrize("mode", ["host", "device", "beam", "speculative"])
def test_serving_modes_graph_replay_equals_eager(cuda, mode):
    """Continuous batching (both schedulers), beam search and speculative
    decoding: the loops replayed from CUDA graphs give the eager loops'
    tokens, and the eager run launches B7 (prefills) and B13 (decode)."""
    from tpp_mlir_tpu_torch.serving import (BatchingEngine,
                                            DeviceBatchingEngine,
                                            make_beam_generate,
                                            make_speculative_generate)
    cfg, params = _serving_model()
    ids = torch.randint(0, cfg.vocab, (2, 32), generator=cuda,
                        device="cuda", dtype=torch.int32)
    prompts = [ids[0, :n].cpu().numpy() for n in (5, 17, 32, 9)]

    def run(graph):
        if mode in ("host", "device"):
            eng = DeviceBatchingEngine(params, cfg, slots=2, sync_steps=4,
                                       wave=3, graph=graph) \
                if mode == "device" else BatchingEngine(
                    params, cfg, slots=2, sync_steps=4, graph=graph)
            for p in prompts:
                eng.submit(p, max_new=6)
            return eng.run()
        if mode == "beam":
            return make_beam_generate(cfg, 6, 3, graph=graph)(
                params, ids)[0].tolist()
        return make_speculative_generate(cfg, None, 8, k=3, trunk_layers=1,
                                         graph=graph)(
            params, ids[:1])[0].tolist()
    cache = global_cache()
    cache.reset_launches()
    eager = run(False)
    counts = cache.launches_by_kind()
    assert counts["FlashMhaKey"] > 0 and counts["DecodeAttnKey"] > 0
    assert run(True) == eager


def test_serving_kernels_match_the_kernels_off_engine(cuda):
    """Prefill (B7 + B15) and decode (B13) through the kernels against the
    same engine on its composed and einsum paths, teacher-forced."""
    import dataclasses

    from tpp_mlir_tpu_torch.serving import (make_decode_step, make_prefill,
                                            quantize_params)
    cfg, params = _serving_model("int8", int8_compute=True)
    params = quantize_params(params)
    off = dataclasses.replace(cfg, decode_attn="xla")
    ids = torch.randint(0, cfg.vocab, (4, 40), generator=cuda,
                        device="cuda", dtype=torch.int32)
    la, ca = make_prefill(cfg)(params, ids[:, :32])
    lb, cb = make_prefill(off, use_kernels=False)(params, ids[:, :32])
    assert _err(la, lb) <= 3e-2
    for t in range(32, 40):
        la, ca = make_decode_step(cfg)(params, ca, ids[:, t])
        lb, cb = make_decode_step(off, use_kernels=False)(params, cb,
                                                          ids[:, t])
        assert _err(la, lb) <= 3e-2


def test_trace_serving_sees_the_decode_kernel(cuda):
    from tpp_mlir_tpu_torch.tools.trace import trace_serving
    cfg, params = _serving_model()
    ids = torch.randint(0, cfg.vocab, (2, 16), generator=cuda,
                        device="cuda", dtype=torch.int32)
    res = trace_serving(cfg, params, ids, steps=3)
    graph = res["decode graph (3 steps)"]
    assert 0.0 <= graph["idle_share"] < 1.0 and graph["busy_ms"] > 0.0
    assert any("decode_attn" in name for _, name in graph["shares"])
    assert any("attention_kernel" in name for _, name in
               res["prefill"]["shares"])


# ---------------------------------------------------------------------------
# the training slice: B14/B18 and the train steps
# Tolerances: f32 1e-4 (sum order only); bf16 2e-2 (P and dS rounded to
# bf16 on both sides; the kernel's online softmax rounds P against the
# running max, the plain version against the row's).

@pytest.mark.parametrize("key", [
    FlashTrainKey(2, 3, 100, 32, "bf16", False, 32 ** -0.5),
    FlashTrainKey(1, 2, 200, 128, "bf16", True, 128 ** -0.5),
    FlashTrainKey(2, 2, 130, 64, "f32", True, 0.125),
    FlashTrainKey(2, 4, 200, 64, "bf16", True, 0.125),
    FlashTrainKey(2, 3, 256, 32, "bf16", True, 32 ** -0.5),
    FlashTrainKey(1, 2, 256, 128, "bf16", False, 128 ** -0.5),
    FlashTrainKey(8, 12, 512, 64, "bf16", True, 0.125),
    FlashTrainKey(2, 4, 192, 64, "bf16", True, 0.125),
], ids=["bf16-d32-tail", "bf16-d128-causal", "f32-d64-causal-tail",
        "bf16-d64-causal-s200", "bf16-d32-causal", "bf16-d128-full",
        "bf16-gpt2-train", "bf16-d64-causal-s192"])
def test_flash_train_kernels_match_plain(cuda, key):
    """B14 (attention.cu's training mode for bf16, the f32-FMA forward for
    f32) and B18 (flash_train.cu's wgmma passes for bf16, its FMA passes
    for f32) against their plain versions; B18 fed the kernel's lse2 and
    delta within the same tolerance of B18 fed the plain ones. S 192 puts
    the diagonal of pass 1's second 128-row block in both its consumer
    warpgroups' halves."""
    import dataclasses

    from tpp_mlir_tpu_torch.xsmm.reference import flash_train_bwd_route
    assert flash_train_bwd_route(key) == (
        "wgmma" if key.dtype == "bf16" else "fma")
    t = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    q, k, v, do = (torch.randn(key.batch, key.seq, key.heads, key.head_dim,
                               generator=cuda, device="cuda").to(t)
                   for _ in range(4))
    tol = 1e-4 if key.dtype == "f32" else 2e-2
    o, lse2 = build_kernel(key)(q, k, v)
    po, plse2 = reference_kernel(key)(q, k, v)
    assert _err(o, po) <= tol and _err(lse2, plse2) <= 1e-4
    delta = (do.float() * po.float()).sum(-1).transpose(1, 2).contiguous()
    bkey = FlashTrainBwdKey(**dataclasses.asdict(key))
    got = build_kernel(bkey)(q, k, v, do, plse2, delta)
    again = build_kernel(bkey)(q, k, v, do, plse2, delta)
    want = reference_kernel(bkey)(q, k, v, do, plse2, delta)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)           # no atomics: bit-repeatable
        assert _err(a, w) <= tol
    kdelta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    fed = build_kernel(bkey)(q, k, v, do, lse2, kdelta)
    for a, w in zip(fed, got):
        assert _err(a, w) <= tol


def test_flash_attention_train_gqa_grads_match_composed(cuda):
    from tpp_mlir_tpu_torch.serving import composed_causal_attention
    from tpp_mlir_tpu_torch.xsmm.flash_train import flash_attention_train
    q = torch.randn(2, 64, 4, 32, generator=cuda, device="cuda")
    k, v = (torch.randn(2, 64, 2, 32, generator=cuda, device="cuda")
            for _ in range(2))
    g = torch.randn(2, 64, 4, 32, generator=cuda, device="cuda")
    grads = []
    for attn in (flash_attention_train, composed_causal_attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        attn(*leaves, 32 ** -0.5).backward(g)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert _err(a, b) <= 1e-4


def test_f32_matmul_backward_runs_bf16_gemms(cuda):
    from tpp_mlir_tpu_torch.ops.trainable import f32_matmul
    x = torch.randn(64, 48, generator=cuda, device="cuda").bfloat16()
    w = torch.randn(48, 32, generator=cuda, device="cuda").bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = f32_matmul(x, w)
    assert y.dtype == torch.float32
    g = torch.randn(64, 32, generator=cuda, device="cuda")
    y.backward(g)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    gb = g.bfloat16().float()
    assert _err(x.grad, gb @ w.float().t()) <= 1e-2
    assert _err(w.grad, x.float().t() @ gb) <= 1e-2


@pytest.mark.parametrize("dtype,precision", [("bf16", "default"),
                                             ("f32", "highest")])
def test_mlp_train_step_on_the_card_matches_kernels_off(cuda, dtype,
                                                        precision):
    from tpp_mlir_tpu_torch.parallel import make_train_step, mlp_init
    layers = (128, 128, 128, 128)
    params = mlp_init(layers, {"bf16": "bfloat16", "f32": "float32"}[dtype])
    t = params[0][0].dtype
    x = torch.randn(64, 128, generator=cuda, device="cuda").to(t)
    y = torch.randn(64, 128, generator=cuda, device="cuda").to(t)
    out = []
    for kernels in (True, False):
        step = make_train_step(layers, 0.05, use_kernels=kernels,
                               precision=precision)
        cache = global_cache()
        cache.reset_launches()
        p = params
        for _ in range(2):
            p, loss = step(p, x, y)
        assert (cache.launches_by_kind().get("BrgemmKey", 0) > 0) == kernels
        out.append(p)
    for (wk, bk), (wp, bp) in zip(*out):
        assert _err(wk, wp) <= (1e-4 if dtype == "f32" else 1e-2)
        assert _err(bk, bp) <= (1e-4 if dtype == "f32" else 1e-2)


# ---------------------------------------------------------------------------
# the MoE slice: B16 (grouped GEMM) and B17 (grouped weight gradient) on
# routings made by the engine's own dispatch. Tolerances: 1e-4 for an f32
# output (both sides round the operands alike: sum order only), 1e-2 for
# bf16; padding rows and experts no token chose come out exactly zero, and
# B17 is bit-repeatable (no atomics).

def _moe_routing(g, T, n_e, bm, skew):
    """The dispatch maps of a top-2 routing of T random tokens; skewed:
    expert n_e - 1 gets no token (it keeps only its padding block)."""
    from tpp_mlir_tpu_torch.serving.engine import _grouped_dispatch
    logits = torch.randn(T, n_e, generator=g, device="cuda")
    if skew:
        logits[:, 0] += 2.0
        logits[:, n_e - 1] -= 100.0
    return _grouped_dispatch(logits.topk(2, -1).indices, T, n_e, bm, 2)


# (T, n_e, bm, k, n, key fields, skewed routing)
GROUPED = {
    "bf16-gelu-bm128": (512, 8, 128, 256, 512,
                        dict(dtype="bf16", unary_kind="gelu"), False),
    "bf16-bm16-tb-f32out": (200, 4, 16, 128, 96,
                            dict(dtype="bf16", transpose_b=True,
                                 out_dtype="f32"), True),
    "f32-default-bm32": (100, 4, 32, 96, 64, dict(dtype="f32"), False),
    "f32-highest-layers": (64, 4, 64, 64, 128,
                           dict(dtype="f32", precision="highest", layers=3,
                                unary_kind="gelu"), True),
    # the WMMA tile's 8-row form (the serving fuzzer's moe_group_bm 8)
    "bf16-bm8": (200, 4, 8, 128, 96, dict(dtype="bf16"), False),
    "f32-default-bm8-gelu-skewed": (100, 4, 8, 96, 64,
                                    dict(dtype="f32", unary_kind="gelu"),
                                    True),
    "f32-highest-bm24-tb": (100, 4, 24, 64, 96,
                            dict(dtype="f32", precision="highest",
                                 transpose_b=True), False),
}


@pytest.mark.parametrize("name", list(GROUPED))
def test_grouped_gemm_kernel_matches_plain(cuda, name):
    T, n_e, bm, k, n, fields, skew = GROUPED[name]
    d = _moe_routing(cuda, T, n_e, bm, skew)
    key = GroupedGemmKey(n_groups=n_e, m=d["A_pad"], n=n, k=k, bm=bm,
                         **fields)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    h = _rnd(cuda, (T, k), key.dtype)
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    wshape = (n, k) if key.transpose_b else (k, n)
    w = _rnd(cuda, ((key.layers,) if key.layers else ()) + (n_e, *wshape),
             key.dtype, k ** -0.5)
    args = ((1,) if key.layers else ()) + (d["ge"], xs.to(dt), w)
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert _err(got, want) <= (1e-4 if (key.out_dtype or key.dtype) == "f32"
                               else 1e-2)
    assert not got[d["tt"] == T].any()          # padding rows stay zero


# B16's TMA + wgmma tile at its edges (xsmm/reference.py grouped_gemm_route
# sends each here): bm 64 and 128, transpose_b, a stacked table, an f32
# output, the gelu epilogue, n and k off the 128/64 tiles (multiples of 8,
# as TMA's row strides need), skewed routing; and hand-made maps where an
# expert owns no block at all
GROUPED_EDGES = {
    "bm64-gelu": (300, 8, 64, 256, 512, dict(dtype="bf16",
                                             unary_kind="gelu"), False),
    "bm128-tb-f32-out": (300, 8, 128, 384, 256,
                         dict(dtype="bf16", transpose_b=True,
                              out_dtype="f32"), False),
    "bm128-layers-gelu": (256, 4, 128, 128, 256,
                          dict(dtype="bf16", layers=3, unary_kind="gelu"),
                          True),
    "bm64-ragged-n200-k136": (200, 4, 64, 136, 200, dict(dtype="bf16"),
                              False),
    "bm128-ragged-tb-skewed": (300, 8, 128, 200, 136,
                               dict(dtype="bf16", transpose_b=True), True),
}


@pytest.mark.parametrize("name", list(GROUPED_EDGES))
def test_grouped_gemm_wgmma_edges_match_plain(cuda, name):
    from tpp_mlir_tpu_torch.xsmm.reference import grouped_gemm_route
    T, n_e, bm, k, n, fields, skew = GROUPED_EDGES[name]
    d = _moe_routing(cuda, T, n_e, bm, skew)
    key = GroupedGemmKey(n_groups=n_e, m=d["A_pad"], n=n, k=k, bm=bm,
                         **fields)
    assert grouped_gemm_route(key) == "wgmma"
    h = _rnd(cuda, (T, k), "bf16")
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    wshape = (n, k) if key.transpose_b else (k, n)
    w = _rnd(cuda, ((key.layers,) if key.layers else ()) + (n_e, *wshape),
             "bf16", k ** -0.5)
    args = ((2,) if key.layers else ()) + (d["ge"], xs, w)
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert _err(got, want) <= (1e-4 if key.out_dtype == "f32" else 1e-2)
    assert not got[d["tt"] == T].any()          # padding rows stay zero


@pytest.mark.parametrize("bm", [64, 128])
def test_grouped_gemm_wgmma_with_an_expert_that_owns_no_block(cuda, bm):
    # experts 1 and 3 of 5 own no row block; expert 4 owns the most
    ge = torch.tensor([0, 2, 2, 4, 4, 4], dtype=torch.int32, device="cuda")
    key = GroupedGemmKey(n_groups=5, m=6 * bm, n=256, k=192, bm=bm,
                         dtype="bf16")
    a = _rnd(cuda, (key.m, key.k), "bf16")
    b = _rnd(cuda, (5, key.k, key.n), "bf16", key.k ** -0.5)
    got = build_kernel(key)(ge, a, b)
    want = reference_kernel(key)(ge, a, b)
    torch.cuda.synchronize()
    assert _err(got, want) <= 1e-2


def test_grouped_gemm_forced_tiles(cuda):
    from tpp_mlir_tpu_torch.xsmm.kernels import build_grouped_gemm
    d = _moe_routing(cuda, 256, 4, 128, False)
    key = GroupedGemmKey(n_groups=4, m=d["A_pad"], n=256, k=128, bm=128,
                         dtype="bf16", out_dtype="f32")
    h = _rnd(cuda, (256, 128), "bf16")
    xs = torch.cat([h, h.new_zeros(1, 128)])[d["tt"]]
    w = _rnd(cuda, (4, 128, 256), "bf16", 128 ** -0.5)
    want = reference_kernel(key)(d["ge"], xs, w)
    for route in ("wgmma", "wmma"):
        got = build_grouped_gemm(key, route)(d["ge"], xs, w)
        torch.cuda.synchronize()
        assert _err(got, want) <= 1e-4, route
    small = dataclasses.replace(key, bm=16, m=d["A_pad"])
    with pytest.raises(ValueError, match="wgmma tile cannot take"):
        build_grouped_gemm(small, "wgmma")(
            torch.zeros(small.m // 16, dtype=torch.int32, device="cuda"), xs,
            w)


# (T, n_e, bm, k, n, dtype, precision, skewed routing): B17 at the MoE
# slice's dw1 and dw2 (9216 padded rows), skewed routing, bm 64 and k, n off
# the wgmma tile's 128 on the TMA + wgmma tile; bm 16 and f32 "highest" on
# the WMMA / FMA tile
WGRAD = {
    "bf16-bm128": (512, 8, 128, 256, 512, "bf16", "default", False),
    "bf16-bm16-skewed": (200, 4, 16, 128, 96, "bf16", "default", True),
    "f32-highest-skewed": (100, 4, 32, 64, 96, "f32", "highest", True),
    "bf16-dw1": (4096, 8, 128, 768, 3072, "bf16", "default", False),
    "bf16-dw2": (4096, 8, 128, 3072, 768, "bf16", "default", False),
    "bf16-dw1-skewed": (4096, 8, 128, 768, 3072, "bf16", "default", True),
    "bf16-bm64": (600, 8, 64, 256, 512, "bf16", "default", False),
    "bf16-ragged-k200-n136": (300, 8, 128, 200, 136, "bf16", "default",
                              False),
    "bf16-bm64-ragged-k136-n200-skewed": (300, 8, 64, 136, 200, "bf16",
                                          "default", True),
}


@pytest.mark.parametrize("name", list(WGRAD))
def test_grouped_wgrad_kernel_matches_plain(cuda, name):
    """xt as the transpose of a contiguous x (an MN-major A tile on wgmma)
    and as a contiguous (K-major) xt, bit-equal to each other and over two
    runs; the forced WMMA tile at the same key within the same tolerance."""
    from tpp_mlir_tpu_torch.xsmm.kernels import build_grouped_gemm
    from tpp_mlir_tpu_torch.xsmm.reference import grouped_wgrad_route
    T, n_e, bm, k, n, dtype, precision, skew = WGRAD[name]
    d = _moe_routing(cuda, T, n_e, bm, skew)
    key = GroupedWgradKey(n_groups=n_e, m=d["A_pad"], k=k, n=n, bm=bm,
                          dtype=dtype, precision=precision)
    route = grouped_wgrad_route(key)
    assert route == ("wgmma" if dtype == "bf16" and bm % 64 == 0
                     else "wmma")
    assert grouped_wgrad_route(key, (d["A_pad"], 1)) == route
    h = _rnd(cuda, (T, k), dtype)
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    dy = _rnd(cuda, (d["A_pad"], n), dtype)
    kern = build_kernel(key)
    got = kern(d["ge"], xs.t(), dy)         # the transpose, read in place
    again = kern(d["ge"], xs.t().contiguous(), dy)
    twice = kern(d["ge"], xs.t(), dy)
    want = reference_kernel(key)(d["ge"], xs.t(), dy)
    forced = build_grouped_gemm(key, "wmma")(d["ge"], xs.t(), dy)
    torch.cuda.synchronize()
    assert kern.launches == 3
    assert torch.equal(got, again) and torch.equal(got, twice)
    assert _err(got, want) <= 1e-4
    assert _err(forced, want) <= 1e-4
    if skew:
        assert not got[n_e - 1].any()


@pytest.mark.parametrize("bm", [64, 128])
def test_grouped_wgrad_wgmma_with_an_expert_that_owns_no_block(cuda, bm):
    # experts 1 and 3 of 5 own no row block: the wgmma tile runs no slice
    # for them and writes exactly zero
    ge = torch.tensor([0, 2, 2, 4, 4, 4], dtype=torch.int32, device="cuda")
    key = GroupedWgradKey(n_groups=5, m=6 * bm, k=192, n=256, bm=bm,
                          dtype="bf16")
    x = _rnd(cuda, (key.m, key.k), "bf16")
    dy = _rnd(cuda, (key.m, key.n), "bf16")
    got = build_kernel(key)(ge, x.t(), dy)
    want = reference_kernel(key)(ge, x.t(), dy)
    torch.cuda.synchronize()
    assert _err(got, want) <= 1e-4
    assert not got[1].any() and not got[3].any()


def test_grouped_wgrad_forced_wgmma_refuses_what_it_cannot_take(cuda):
    from tpp_mlir_tpu_torch.xsmm.kernels import build_grouped_gemm
    key = GroupedWgradKey(n_groups=2, m=64, k=32, n=32, bm=16, dtype="bf16")
    ge = torch.zeros(4, dtype=torch.int32, device="cuda")
    x = _rnd(cuda, (64, 32), "bf16")
    with pytest.raises(ValueError, match="wgmma tile cannot take"):
        build_grouped_gemm(key, "wgmma")(ge, x.t(), x)


def _moe_model(**kw):
    from tpp_mlir_tpu_torch.serving import GptConfig, init_params
    cfg = GptConfig(vocab=512, embed=256, heads=4, layers=2, max_seq=128,
                    dtype="bf16", n_experts=4, moe_prefill_form="grouped",
                    moe_group_bm=64, **kw)
    return cfg, init_params(cfg, seed=0, device="cuda")


def test_moe_grouped_prefill_matches_the_kernels_off_engine(cuda,
                                                           monkeypatch):
    """Two B16 launches a layer; logits within the model tolerance of the
    kernels-off engine run at the kernel run's routing: once the numerics
    differ, a bf16 near-tie of the router can flip a token's experts."""
    from tpp_mlir_tpu_torch.serving import engine, make_prefill
    cfg, params = _moe_model()
    ids = torch.randint(0, cfg.vocab, (4, 64), generator=cuda,
                        device="cuda", dtype=torch.int32)
    router, routes = engine._moe_gates, []

    def record(*a):
        out = router(*a)
        routes.append(out[1])
        return out
    monkeypatch.setattr(engine, "_moe_gates", record)
    cache = global_cache()
    cache.reset_launches()
    got = make_prefill(cfg)(params, ids)[0]
    assert cache.launches_by_kind()["GroupedGemmKey"] == 2 * cfg.layers
    pinned = iter(routes)

    def pin(h, wr, top_k, mm=None):
        idx = next(pinned)
        return torch.softmax(engine._mm(h, wr).gather(-1, idx), -1), idx
    monkeypatch.setattr(engine, "_moe_gates", pin)
    want = make_prefill(dataclasses.replace(cfg, decode_attn="xla"),
                        use_kernels=False)(params, ids)[0]
    assert _err(got, want) <= 3e-2


def test_moe_grouped_train_step_launches_b16_and_b17(cuda):
    from tpp_mlir_tpu_torch.parallel import adamw, make_gpt_train_step
    cfg, params = _moe_model()
    ids = torch.randint(0, cfg.vocab, (2, 64), generator=cuda,
                        device="cuda", dtype=torch.int32)
    step, init = make_gpt_train_step(cfg, adamw(1e-3))
    state = init(params)
    cache = global_cache()
    cache.reset_launches()
    losses = [float(step(params, state, ids)[2]) for _ in range(3)]
    counts = cache.launches_by_kind()
    assert counts["GroupedGemmKey"] == 3 * 4 * cfg.layers
    assert counts["GroupedWgradKey"] == 3 * 2 * cfg.layers
    assert losses[-1] < losses[0]


# the MHA suite's kernels: flat-layout attention under each strategy and its
# warm bench (B6, B8-B11), the batched matmul (B21/B22), the ping-pong fc
# bench (B5)
FLAT = {
    "auto-s256-d64": FlashMhaKey(6, 256, 256, 64, "f32", scale=0.125),
    "grouped-causal-bf16": FlashMhaKey(4, 128, 128, 32, "bf16", scale=0.2,
                                       causal=True, strategy="grouped"),
    "qblock-highest-d128": FlashMhaKey(3, 192, 320, 128, "f32",
                                       scale=0.09, precision="highest",
                                       strategy="qblock"),
    "twocall-causal": FlashMhaKey(4, 256, 256, 64, "bf16", scale=0.125,
                                  causal=True, strategy="twocall"),
    "twocall2-causal-ragged": FlashMhaKey(2, 200, 200, 64, "bf16",
                                          scale=0.125, causal=True,
                                          strategy="twocall2"),
    "bench-flat-r3": FlashMhaKey(4, 256, 256, 128, "bf16", scale=0.09,
                                 repeats=3),
    "bench-flat-causal-highest": FlashMhaKey(2, 128, 128, 64, "f32",
                                             scale=0.125, causal=True,
                                             precision="highest", repeats=2),
    "bench-tokens-packed": FlashMhaKey(2, 128, 128, 64, "bf16", scale=0.125,
                                       causal=True, heads=4, repeats=2,
                                       qkv_packed=True),
    "flash-heads": FlashMhaKey(2, 256, 256, 64, "bf16", scale=0.125,
                               causal=True, heads=4,
                               strategy="flash_heads"),
    "xla": FlashMhaKey(2, 128, 128, 64, "bf16", scale=0.125, heads=4,
                       strategy="xla"),
}


@pytest.mark.parametrize("name", list(FLAT))
def test_flat_attention_and_bench_match_plain(cuda, name):
    key = FLAT[name]
    g = cuda
    if key.heads:
        E = key.heads * key.head_dim
        if key.qkv_packed:
            x = _rnd(g, (key.batch, key.seq, 3 * E), key.dtype)
            args = (x, x, x)
        else:
            args = tuple(_rnd(g, (key.batch, s, E), key.dtype)
                         for s in (key.seq, key.seq_kv, key.seq_kv))
    else:
        args = tuple(_rnd(g, (key.batch, s, key.head_dim), key.dtype)
                     for s in (key.seq, key.seq_kv, key.seq_kv))
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == (0 if key.strategy == "xla" else 1)
    assert torch.isfinite(got.float()).all()
    tol = 2e-2 if key.strategy == "flash_heads" else _tol(key)
    assert _err(got, want) <= tol


BMM = {
    "qk-f32": BatchMatmulKey(64, 32, 32, 64, "f32", beta0=True),
    "softmax-v-bf16": BatchMatmulKey(64, 32, 64, 32, "bf16", beta0=True,
                                     softmax_lhs=True),
    "softmax-highest-C": BatchMatmulKey(5, 70, 90, 100, "f32",
                                        softmax_lhs=True,
                                        precision="highest"),
    "lhs-shared-C-bf16-out-f32": BatchMatmulKey(7, 96, 130, 80, "bf16",
                                                out_dtype="f32",
                                                lhs_shared=True),
    # the tiled route's bf16 products: softmax_lhs at f32 "default" and a
    # plain bf16 key, both over 64
    "softmax-default-tiled": BatchMatmulKey(5, 70, 90, 100, "f32",
                                            softmax_lhs=True),
    "bf16-tiled": BatchMatmulKey(6, 80, 72, 96, "bf16", beta0=True),
    # the multi route: a batch the warps do not divide, a batch beyond the
    # resident warps (each warp takes problems in turn), lhs_shared, +C,
    # softmax_lhs at k 32 and 64, m below 16, n 40, k 24 (a half k16 step)
    "multi-qk-f32-b1000": BatchMatmulKey(1000, 32, 32, 64, "f32",
                                         beta0=True),
    "multi-qk-f32-b5000-loop": BatchMatmulKey(5000, 32, 32, 64, "f32",
                                              beta0=True),
    "multi-lhs-shared-bf16": BatchMatmulKey(300, 48, 64, 40, "bf16",
                                            beta0=True, lhs_shared=True),
    "multi-C-bf16-out-f32": BatchMatmulKey(257, 64, 40, 64, "bf16",
                                           out_dtype="f32"),
    "multi-softmax-k32-f32": BatchMatmulKey(1024, 32, 64, 32, "f32",
                                            beta0=True, softmax_lhs=True),
    "multi-softmax-k64-bf16-C": BatchMatmulKey(130, 20, 32, 64, "bf16",
                                               softmax_lhs=True),
    "multi-softmax-k24-shared": BatchMatmulKey(33, 10, 16, 24, "f32",
                                               lhs_shared=True,
                                               softmax_lhs=True),
}


@pytest.mark.parametrize("name", list(BMM))
def test_batch_matmul_kernel_matches_plain(cuda, name):
    from tpp_mlir_tpu_torch.xsmm.reference import batch_matmul_route
    key = BMM[name]
    tiled = ("softmax-highest-C", "lhs-shared-C-bf16-out-f32",
             "softmax-default-tiled", "bf16-tiled")
    assert batch_matmul_route(key) == ("tiled" if name in tiled else "multi")
    g = cuda
    a = _rnd(g, (key.m, key.k) if key.lhs_shared
             else (key.batch, key.m, key.k), key.dtype, 2.0)
    b = _rnd(g, (key.batch, key.k, key.n), key.dtype)
    c = None if key.beta0 else _rnd(g, (key.batch, key.m, key.n), "f32")
    kern = build_kernel(key)
    got = kern(a, b, c)
    want = reference_kernel(key)(a, b, c)
    torch.cuda.synchronize()
    assert kern.launches == 1
    f32_out = (key.out_dtype or key.dtype) == "f32"
    # softmax_lhs rounds P to bf16 at "default": an ulp of exp between
    # kernel and plain version can flip a rounding
    soft = key.softmax_lhs and key.precision == "default"
    assert _err(got, want) <= (1e-4 if f32_out and not soft else 1e-2)


@pytest.mark.parametrize("dtype,precision,repeats", [
    ("bf16", "default", 2), ("f32", "default", 3), ("f32", "highest", 4)])
def test_pingpong_chain_matches_plain(cuda, dtype, precision, repeats):
    g = cuda
    key = ChainKey(m=40, dims=(64, 160), dtype=dtype, precision=precision,
                   repeats=repeats, pingpong=True)
    args = (_rnd(g, (40, 64), dtype), _rnd(g, (64, 160), dtype, 64 ** -0.5),
            _rnd(g, (160,), dtype, 0.1))
    got = build_kernel(key)(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert got.shape == (40, 160)
    assert _err(got, want) <= _tol(key)


@pytest.mark.parametrize("dtype,repeats", [("f32", 2), ("f32", 3),
                                           ("bf16", 3)])
def test_pingpong_full_key_matches_plain(cuda, dtype, repeats):
    # fc_128x768x2304's B5 key: the forward owns three 64-column tiles a
    # block, the backward one, both streamed
    g = cuda
    key = ChainKey(m=128, dims=(768, 2304), dtype=dtype, repeats=repeats,
                   pingpong=True)
    args = (_rnd(g, (128, 768), dtype), _rnd(g, (768, 2304), dtype,
                                             768 ** -0.5),
            _rnd(g, (2304,), dtype, 0.1))
    got = build_kernel(key)(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert got.shape == (128, 2304)
    assert _err(got, want) <= _tol(key)


def _warm_args(g, key):
    if isinstance(key, ChainKey):
        args = [_rnd(g, (key.m, key.dims[0]), key.dtype)]
        for k, n in zip(key.dims[:-1], key.dims[1:]):
            args.append(_rnd(g, (k, n), key.dtype, k ** -0.5))
            if key.has_bias:
                args.append(_rnd(g, (n,), key.dtype, 0.1))
        return args
    b = _rnd(g, (key.Nb, key.Kb, key.kb, key.nb), key.dtype,
             (key.Kb * key.kb) ** -0.5)
    if key.vnni:
        b = b.reshape(key.Nb, key.Kb, key.kb // 2, 2, key.nb) \
            .movedim(-2, -1).contiguous()
    d = _rnd(g, (key.Nb, key.nb), "f32") if key.binary_kind else None
    return [_rnd(g, (key.Mb, key.Kb, key.mb, key.kb), key.dtype), b, None, d]


# csrc/warm_panel.cuh under each route and forced plans: (key, route, plan
# overrides for reference.warm_plan or None)
FC = dict(beta0=True, binary_kind="add", unary_kind="relu")
WARM = {
    "chain-panel": (ChainKey(m=40, dims=(64, 128, 32), dtype="bf16"),
                    "panel", None),
    "chain-wmma": (ChainKey(m=40, dims=(64, 128, 32), dtype="bf16"),
                   "wmma", None),
    "chain-streamed-masked": (ChainKey(m=17, dims=(48, 160, 48),
                                       repeats=3), "panel",
                              {"resident": False}),
    "chain-rows64-c1": (ChainKey(m=70, dims=(96, 128, 96), dtype="bf16",
                                 unary_kind="gelu", repeats=2), "panel",
                        {"rows": 64, "cluster": 1}),
    "chain-rows32-streamed": (ChainKey(m=70, dims=(256, 256, 256)), "panel",
                              {"rows": 32, "resident": False}),
    "pingpong-panel": (ChainKey(m=40, dims=(64, 160), repeats=3,
                                pingpong=True), "panel", None),
    "pingpong-streamed": (ChainKey(m=40, dims=(64, 160), repeats=4,
                                   pingpong=True), "panel",
                          {"resident": False}),
    "pingpong-wmma": (ChainKey(m=40, dims=(64, 160), repeats=3,
                               pingpong=True), "wmma", None),
    "b20-panel": (BlockedMatmulKey(2, 2, 2, 24, 64, 64, "bf16", vnni=2,
                                   repeats=3, **FC), "panel", None),
    "b20-wmma": (BlockedMatmulKey(2, 2, 2, 24, 64, 64, "bf16", vnni=2,
                                  repeats=3, **FC), "wmma", None),
    "b20-f32-panel-c1": (BlockedMatmulKey(1, 3, 3, 40, 48, 48, repeats=2,
                                          **FC), "panel",
                         {"rows": 16, "cluster": 1}),
    "b20-f32-wmma": (BlockedMatmulKey(1, 3, 3, 40, 48, 48, repeats=2, **FC),
                     "wmma", None),
}


@pytest.mark.parametrize("name", list(WARM))
def test_warm_routes_forced_both_ways(cuda, name):
    from tpp_mlir_tpu_torch.xsmm import reference
    from tpp_mlir_tpu_torch.xsmm.kernels import build_warm
    key, route, over = WARM[name]
    plan = reference.warm_plan(key, **over) if over else None
    kern = build_warm(key, route, plan)
    args = _warm_args(cuda, key)
    got, again = kern(*args), kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 2
    assert torch.equal(got, again)
    assert _err(got, want) <= _tol(key)


@pytest.mark.parametrize("key", [
    ChainKey(m=256, dims=(1024,) * 4, dtype="bf16", repeats=8),
    ChainKey(m=128, dims=(768, 2304), repeats=3, pingpong=True),
    BlockedMatmulKey(1, 2, 2, 256, 512, 512, repeats=3, **FC),
    BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16", vnni=2, repeats=3,
                     **FC),
], ids=["flagship-r8", "b5-r3", "b20-fc-f32-r3", "b20-fc-bf16-vnni-r3"])
def test_warm_kernels_are_bit_repeatable(cuda, key):
    from tpp_mlir_tpu_torch.xsmm import reference
    route = reference.chain_route(key) if isinstance(key, ChainKey) \
        else reference.warm_route(key)
    assert route == "panel"
    kern = build_kernel(key)
    args = _warm_args(cuda, key)
    got = kern(*args)
    for _ in range(3):
        assert torch.equal(kern(*args), got)
    assert _err(got, reference_kernel(key)(*args)) <= _tol(key)


def test_flat_attention_refuses_shapes_beyond_the_kernel(cuda):
    # head_dim outside attention.cu's instantiations; a batch beyond
    # gridDim.z, where the kernel puts it
    q = torch.zeros(2, 64, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        build_kernel(FlashMhaKey(2, 64, 64, 48))(q, q, q)
    q = torch.zeros(70000, 16, 32, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="65535"):
        build_kernel(FlashMhaKey(70000, 16, 16, 32, "bf16"))(q, q, q)


# csrc/conv.cu's wgmma implicit GEMM (routes "tma", bf16, and "convert",
# f32 "default"; reference.conv_kernel_route) at its edges: C and K off the
# 64 / 128 tiles (C 8 and 24, K 72 and 40), asymmetric padding, P.Q not a
# multiple of 64, 1x1, the channel-blocked entry at Cb 2 (rows per image),
# 64 x 128 and 128 x 128 tiles, k splits on both routes, C and D in bf16
# read as stored
CONV_WGMMA = {
    "c8-k72-bf16-asym-pad": (ConvNhwcKey(N=3, H=9, W=7, C=8, K=72, R=3,
                                         S=3, dtype="bf16", pad=(1, 0, 2, 1),
                                         beta0=True, binary_kind="add",
                                         unary_kind="relu"), "tma"),
    "c24-k72-f32-asym-residual": (ConvNhwcKey(N=2, H=11, W=10, C=24, K=72,
                                              R=3, S=2, pad=(0, 2, 1, 0),
                                              binary_kind="add",
                                              binary_bcast="none",
                                              unary_kind="gelu"), "convert"),
    "1x1-c24-bf16-f32-out": (ConvNhwcKey(N=2, H=7, W=9, C=24, K=72,
                                         dtype="bf16", out_dtype="f32"),
                             "tma"),
    "blocked-cb2-f32": (ConvBrgemmKey(N=2, H=9, W=8, Cb=2, c=24, Kb=2, k=72,
                                      R=3, S=3, beta0=True,
                                      binary_kind="add", unary_kind="relu"),
                        "convert"),
    "blocked-cb2-kb3-bf16-c": (ConvBrgemmKey(N=2, H=6, W=7, Cb=2, c=64, Kb=3,
                                             k=40, R=2, S=3, dtype="bf16"),
                               "tma"),
    "64x128-bf16": (ConvNhwcKey(N=8, H=36, W=36, C=64, K=128, R=3, S=3,
                                dtype="bf16", beta0=True, binary_kind="add",
                                unary_kind="relu"), "tma"),
    "tma-split-bf16": (ConvNhwcKey(N=2, H=18, W=18, C=128, K=128, R=3, S=3,
                                   dtype="bf16"), "tma"),
    "128x128-f32": (ConvNhwcKey(N=8, H=36, W=36, C=64, K=128, R=3, S=3,
                                beta0=True, binary_kind="add",
                                unary_kind="relu"), "convert"),
    "c128-30-f32-c-relu": (ConvNhwcKey(N=8, H=30, W=30, C=128, K=128, R=3,
                                       S=3, unary_kind="relu"), "convert"),
}


def _conv_args(g, key, cd="f32"):
    """I and W of a NHWC or channel-blocked key, C and D (in dtype cd)
    where the key reads them."""
    if isinstance(key, ConvBrgemmKey):
        out = (key.N, key.Kb, key.P, key.Q, key.k)
        i = _rnd(g, (key.N, key.Cb, key.H, key.W, key.c), key.dtype)
        w = _rnd(g, (key.Kb, key.Cb, key.R, key.S, key.c, key.k), key.dtype,
                 (key.R * key.S * key.Cb * key.c) ** -0.5)
        bias = (key.Kb, key.k)
    else:
        out = (key.N, key.P, key.Q, key.K)
        i = _rnd(g, (key.N, key.H, key.W, key.C), key.dtype)
        w = _rnd(g, (key.R, key.S, key.C, key.K), key.dtype,
                 (key.R * key.S * key.C) ** -0.5)
        bias = (key.K,)
    c = None if key.beta0 else _rnd(g, out, cd)
    d = None
    if key.binary_kind:
        d = _rnd(g, out if key.binary_bcast == "none" else bias, cd)
    return i, w, c, d


@pytest.mark.parametrize("name", list(CONV_WGMMA))
def test_conv_wgmma_routes_match_plain(cuda, name):
    """Single GEMMs: 1e-4 for an f32 output (both sides round I and W to
    bf16 the same way), 1e-2 for bf16; a k split sums its partials in
    slice order, so two launches are bit-equal."""
    from tpp_mlir_tpu_torch.xsmm.reference import conv_kernel_route
    key, route = CONV_WGMMA[name]
    assert conv_kernel_route(key) == route
    args = _conv_args(cuda, key)
    kern = build_kernel(key)
    got = kern(*args)
    again = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 2 and got.shape == want.shape
    assert torch.equal(got, again)
    assert _err(got, want) <= (1e-4 if (key.out_dtype or key.dtype) == "f32"
                               else 1e-2)


@pytest.mark.parametrize("name,cd", [
    ("c24-k72-f32-asym-residual", "bf16"), ("blocked-cb2-kb3-bf16-c", "bf16"),
    ("c128-30-f32-c-relu", "bf16")])
def test_conv_reads_c_and_d_in_their_stored_dtype(cuda, name, cd):
    """bf16 C and D go to the kernel as they are (no conversion kernel
    first) and are widened in registers: the plain version widens them
    the same way."""
    key, _ = CONV_WGMMA[name]
    args = _conv_args(cuda, key, cd)
    got = build_kernel(key)(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert _err(got, want) <= (1e-4 if (key.out_dtype or key.dtype) == "f32"
                               else 1e-2)


@pytest.mark.parametrize("name", ["c8-k72-bf16-asym-pad",
                                  "c24-k72-f32-asym-residual",
                                  "blocked-cb2-f32", "c128-30-f32-c-relu"])
def test_conv_forced_wmma_route(cuda, name):
    """The tile body forced (kernels.build_conv), as phase 5 times it
    beside the wgmma kernel: the same function within the same tolerance;
    "highest" keys cannot be forced off their f32 FMA body."""
    from tpp_mlir_tpu_torch.xsmm.kernels import build_conv
    key, _ = CONV_WGMMA[name]
    args = _conv_args(cuda, key)
    kern = build_conv(key, "wmma")
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert _err(got, want) <= (1e-4 if (key.out_dtype or key.dtype) == "f32"
                               else 1e-2)
    with pytest.raises(ValueError, match="only 'wmma' may be forced"):
        build_conv(dataclasses.replace(key, dtype="f32",
                                       precision="highest"), "wmma")


# the conv family: csrc/conv.cu (B24/B25) at the conv suite's key forms, a
# ragged shape (C, K and the pixel count off the 32/64 tiles), the xla
# route with TF32 off, and the conv suite's nets against --linalg-to-loops
CONV = {
    "3x3-f32-bias-relu": ConvNhwcKey(N=2, H=12, W=12, C=64, K=64, R=3, S=3,
                                     beta0=True, binary_kind="add",
                                     unary_kind="relu"),
    "3x3-highest-acc": ConvNhwcKey(N=2, H=10, W=9, C=64, K=96, R=3, S=3,
                                   precision="highest"),
    "same-residual-bf16": ConvNhwcKey(N=2, H=16, W=16, C=128, K=128, R=3,
                                      S=3, dtype="bf16", pad=(1, 1, 1, 1),
                                      binary_kind="add", binary_bcast="none",
                                      unary_kind="relu"),
    "1x1-w14-fullrow": ConvNhwcKey(N=2, H=14, W=14, C=256, K=64,
                                   beta0=True, binary_kind="add",
                                   unary_kind="relu", strategy="fullrow"),
    "ragged-window-bf16-out-f32": ConvNhwcKey(N=3, H=7, W=11, C=40, K=72,
                                              R=3, S=2, dtype="bf16",
                                              out_dtype="f32",
                                              pad=(2, 0, 1, 1),
                                              strategy="window"),
    "xla-stride2-highest": ConvNhwcKey(N=2, H=9, W=9, C=32, K=32, R=3, S=3,
                                       stride_h=2, stride_w=2, beta0=True,
                                       binary_kind="add",
                                       precision="highest"),
}


@pytest.mark.parametrize("name", list(CONV))
def test_conv_kernel_matches_plain(cuda, name):
    from tpp_mlir_tpu_torch.xsmm.reference import conv_nhwc_reference
    key = CONV[name]
    g = cuda
    i = _rnd(g, (key.N, key.H, key.W, key.C), key.dtype)
    w = _rnd(g, (key.R, key.S, key.C, key.K), key.dtype, key.C ** -0.5)
    c = None if key.beta0 else _rnd(g, (key.N, key.P, key.Q, key.K), "f32")
    d = None
    if key.binary_kind:
        d = _rnd(g, (key.N, key.P, key.Q, key.K)
                 if key.binary_bcast == "none" else (key.K,), "f32")
    kern = build_kernel(key)
    got = kern(i, w, c, d)
    # the per-tap plain version: the xla route's F.conv2d must agree with
    # it at "highest" too, which TF32 would not
    want = conv_nhwc_reference(key)(i, w, c, d)
    torch.cuda.synchronize()
    assert got.shape == (key.N, key.P, key.Q, key.K)
    assert kern.launches == (0 if key.stride_h > 1 else 1)
    assert torch.backends.cudnn.allow_tf32     # restored after the route
    assert _err(got, want) <= _tol(key)


@pytest.mark.parametrize("model", [
    'convnet:{"batch": 2, "channels": 64, "filters": 64, "height": 12, '
    '"width": 12, "kernel": 3, "layers": 2}',
    'convnet:{"batch": 2, "channels": 64, "filters": 64, "height": 8, '
    '"width": 8, "kernel": 3, "layers": 2, "float_type": "bf16", '
    '"layout": "nhwc", "padding": "same", "residual": true}',
    'resnet_block:{"batch": 2, "channels": 64, "hw": 8}',
    'vit:{"batch": 2, "image": 32, "patch": 16, "embed": 128, "heads": 2, '
    '"layers": 1}',
], ids=["convnet-2layer", "resnet-nhwc-bf16", "resnet_block", "vit"])
def test_conv_nets_on_the_card_match_linalg_to_loops(cuda, model):
    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    cache = global_cache()
    cache.reset_launches()
    res = run_entry({"model": model}, device="cuda",
                    out_stream=io.StringIO())
    assert cache.launches_by_kind().get("ConvNhwcKey", 0) >= \
        (0 if model.startswith("vit") else 2)
    got = res["lowered"]["outputs"][0]
    want = res["baseline"]["outputs"][0]
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= 3e-2


# packed parity mode: csrc/blocked_matmul.cu (B19, and B20 with repeats) and
# csrc/conv.cu's channel-blocked entry (B23), at the fc rows' key forms, a
# masked key (mb 8, kb and nb off the 32/64 tiles), VNNI read in place, and
# the packed nets against --linalg-to-loops
BLOCKED = {
    "fc-f32-default": BlockedMatmulKey(1, 2, 2, 64, 128, 128, beta0=True,
                                       binary_kind="add", unary_kind="relu"),
    "fc-f32-highest-c": BlockedMatmulKey(1, 2, 2, 64, 128, 128,
                                         precision="highest"),
    "fc-bf16-vnni": BlockedMatmulKey(1, 2, 2, 64, 128, 128, "bf16",
                                     beta0=True, vnni=2, binary_kind="add",
                                     unary_kind="relu"),
    "masked-mb8-gelu": BlockedMatmulKey(2, 3, 2, 8, 40, 48, "bf16",
                                        out_dtype="f32", vnni=2,
                                        binary_kind="add",
                                        unary_kind="gelu"),
    "warm-f32-default-r3": BlockedMatmulKey(1, 2, 2, 32, 128, 128,
                                            beta0=True, binary_kind="add",
                                            unary_kind="relu", repeats=3),
    "warm-f32-r3": BlockedMatmulKey(1, 2, 2, 32, 128, 128, beta0=True,
                                    binary_kind="add", unary_kind="relu",
                                    precision="highest", repeats=3),
    "warm-bf16-vnni-r3": BlockedMatmulKey(2, 2, 2, 24, 64, 64, "bf16",
                                          beta0=True, vnni=2,
                                          binary_kind="add",
                                          unary_kind="relu", repeats=3),
    "warm-fc-f32-default-r3": BlockedMatmulKey(1, 2, 2, 256, 512, 512,
                                               beta0=True, binary_kind="add",
                                               unary_kind="relu", repeats=3),
    "warm-fc-bf16-vnni-r3": BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16",
                                             beta0=True, vnni=2,
                                             binary_kind="add",
                                             unary_kind="relu", repeats=3),
}


@pytest.mark.parametrize("name", list(BLOCKED))
def test_blocked_matmul_kernel_matches_plain(cuda, name):
    key = BLOCKED[name]
    g = cuda
    a = _rnd(g, (key.Mb, key.Kb, key.mb, key.kb), key.dtype)
    b = _rnd(g, (key.Nb, key.Kb, key.kb, key.nb), key.dtype,
             (key.Kb * key.kb) ** -0.5)
    if key.vnni:
        b = b.reshape(key.Nb, key.Kb, key.kb // 2, 2, key.nb) \
            .movedim(-2, -1).contiguous()
    c = None if key.beta0 else _rnd(g, (key.Mb, key.Nb, key.mb, key.nb),
                                    "f32")
    d = _rnd(g, (key.Nb, key.nb), "f32") if key.binary_kind else None
    kern = build_kernel(key)
    got = kern(a, b, c, d)
    want = reference_kernel(key)(a, b, c, d)
    torch.cuda.synchronize()
    assert got.shape == (key.Mb, key.Nb, key.mb, key.nb)
    assert kern.launches == 1
    out_f32 = (key.out_dtype or key.dtype) == "f32"
    # B20 re-rounds its state to the MXU dtype every repeat
    tol = 1e-4 if out_f32 and (not key.repeats
                               or key.precision == "highest") else 1e-2
    assert _err(got, want) <= tol


CONV_BLOCKED = {
    "c128-30-bias-relu": ConvBrgemmKey(N=2, H=12, W=12, Cb=1, c=128, Kb=1,
                                       k=128, R=3, S=3, beta0=True,
                                       binary_kind="add", unary_kind="relu"),
    "cb2-highest-c-acc": ConvBrgemmKey(N=2, H=8, W=8, Cb=2, c=64, Kb=2, k=64,
                                       R=3, S=3, precision="highest",
                                       unary_kind="relu"),
    "bf16-masked-c16": ConvBrgemmKey(N=2, H=7, W=9, Cb=2, c=16, Kb=3, k=24,
                                     R=3, S=2, dtype="bf16", beta0=True,
                                     binary_kind="add"),
}


@pytest.mark.parametrize("name", list(CONV_BLOCKED))
def test_conv_blocked_kernel_matches_plain(cuda, name):
    key = CONV_BLOCKED[name]
    g = cuda
    i = _rnd(g, (key.N, key.Cb, key.H, key.W, key.c), key.dtype)
    w = _rnd(g, (key.Kb, key.Cb, key.R, key.S, key.c, key.k), key.dtype,
             (key.Cb * key.c) ** -0.5)
    c = None if key.beta0 else _rnd(g, (key.N, key.Kb, key.P, key.Q, key.k),
                                    "f32")
    d = _rnd(g, (key.Kb, key.k), "f32") if key.binary_kind else None
    kern = build_kernel(key)
    got = kern(i, w, c, d)
    want = reference_kernel(key)(i, w, c, d)
    torch.cuda.synchronize()
    assert got.shape == (key.N, key.Kb, key.P, key.Q, key.k)
    assert kern.launches == 1
    assert _err(got, want) <= (1e-4 if key.dtype == "f32" else 1e-2)


@pytest.mark.parametrize("entry", [
    {"gen": "--batch=64 --layers=1024,1024,1024 --bias --relu "
            "--float-type=bf16"},
    {"model": 'convnet:{"batch": 2, "channels": 128, "filters": 128, '
              '"height": 10, "width": 10, "layers": 2}'},
    {"model": 'resnet_block:{"batch": 2, "channels": 128, "hw": 8}'},
], ids=["mlp-bf16", "convnet-2layer", "resnet_block"])
def test_packed_nets_on_the_card_match_linalg_to_loops(cuda, entry):
    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    cache = global_cache()
    cache.reset_launches()
    res = run_entry({**entry, "pipeline": "default-tpp-passes-packed"},
                    n=3, device="cuda", out_stream=io.StringIO())
    kinds = cache.launches_by_kind()
    assert kinds.get("BlockedMatmulKey", 0) + kinds.get("ConvBrgemmKey", 0) \
        >= 2
    got = res["lowered"]["outputs"][0]
    want = res["baseline"]["outputs"][0]
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= 3e-2


# B2's LN-stats pair (csrc/brgemm.cu): the producer's y at the single-GEMM
# tolerance, its mean and var against the plain statistics of its own y at
# 1e-5, the consumer at the LayerNorm-prologue tolerance, both bit-equal
# across launches; ragged m and an n no tile divides, on each route
@pytest.mark.parametrize("dtype,precision,m,n,k", [
    ("bf16", "default", 200, 200, 64), ("f32", "default", 130, 96, 72),
    ("f32", "highest", 100, 136, 40), ("bf16", "default", 256, 3000, 768)],
    ids=["bf16-tma-ragged", "f32-convert", "f32-fma", "bf16-n3000"])
def test_ln_stats_pair_matches_plain_and_repeats(cuda, dtype, precision, m,
                                                n, k):
    from tpp_mlir_tpu_torch.xsmm.reference import ln_stats_out
    g = cuda
    common = dict(batch=1, m=m, dtype=dtype, precision=precision,
                  beta0=True, binary_kind="add")
    kp = BrgemmKey(n=n, k=k, unary_kind="gelu", ln_stats_out=True, **common)
    kc = BrgemmKey(n=64, k=n, prologue="ln_stats", **common)
    a, w1 = _rnd(g, (1, m, k), dtype), _rnd(g, (1, k, n), dtype, k ** -0.5)
    b1 = _rnd(g, (n,), "f32", 0.1)
    w2, b2 = _rnd(g, (1, n, 64), dtype, n ** -0.5), _rnd(g, (64,), "f32")
    gamma, beta = _rnd(g, (n,), "f32") + 1, _rnd(g, (n,), "f32")
    prod, cons = build_kernel(kp), build_kernel(kc)
    y, mu, var = prod(a, w1, None, b1)
    y2, mu2, var2 = prod(a, w1, None, b1)
    kw = dict(gamma=gamma, beta=beta, mu=mu, var=var)
    z = cons(y.reshape(1, m, n), w2, None, b2, **kw)
    z2 = cons(y.reshape(1, m, n), w2, None, b2, **kw)
    want_y = reference_kernel(kp)(a, w1, None, b1)[0]
    want_z = reference_kernel(kc)(y.reshape(1, m, n), w2, None, b2, **kw)
    torch.cuda.synchronize()
    assert prod.launches == 2 and cons.launches == 2
    assert _err(y, want_y) <= _tol(kp)
    own_mu, own_var = ln_stats_out(y)
    assert _err(mu, own_mu) <= 1e-5 and _err(var, own_var) <= 1e-5
    tol = 1e-4 if precision == "highest" else 1e-2
    assert _err(z, want_z) <= tol
    assert torch.equal(y, y2) and torch.equal(mu, mu2) and \
        torch.equal(var, var2) and torch.equal(z, z2)


def test_lora_step_on_the_card_matches_kernels_off(cuda):
    """A LoRA step through the prefill with B14/B18 (no B7: it has no
    backward) against the kernels-off route's step-0 adapter grads (3e-2,
    relative Frobenius over all of them), and a QLoRA int4 base trains."""
    from tpp_mlir_tpu_torch.parallel import adamw, tree_leaves
    from tpp_mlir_tpu_torch.serving import (lora_init, make_lora_train_step,
                                            quantize_params)
    cfg, params = _serving_model()
    ids = torch.randint(0, cfg.vocab, (2, 64), generator=cuda,
                        device="cuda", dtype=torch.int32)
    grads = []
    for kernels in (True, False):
        ad = lora_init(params, rank=4, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(5)
        for blk in ad["blocks"]:
            for ab in blk.values():
                ab["b"].normal_(0, 0.01, generator=gen)
        step, init = make_lora_train_step(cfg, adamw(1e-3),
                                          use_kernels=kernels)
        cache = global_cache()
        cache.reset_launches()
        step(params, ad, init(ad), ids)
        counts = cache.launches_by_kind()
        if kernels:
            assert counts["FlashTrainKey"] == cfg.layers
            assert counts["FlashTrainBwdKey"] == cfg.layers
            assert counts.get("FlashMhaKey", 0) == 0
        grads.append([t.grad.clone() for t in tree_leaves(ad)])
    # all adapter grads jointly: a single top-layer wq leaf is
    # ill-conditioned at initialization (chip_smoke.py phase_lora)
    got, want = (torch.cat([t.float().flatten() for t in g]) for g in grads)
    assert (got - want).norm() / want.norm() <= 3e-2
    q4 = quantize_params(params, bits=4)
    ad = lora_init(q4, rank=4, seed=1)
    step, init = make_lora_train_step(cfg, adamw(1e-2))
    st = init(ad)
    losses = [step(q4, ad, st, ids)[2].item() for _ in range(3)]
    assert losses[-1] < losses[0]


def test_int4_serving_matches_the_kernels_off_engine(cuda):
    import dataclasses

    from tpp_mlir_tpu_torch.serving import (make_decode_step, make_prefill,
                                            quantize_params)
    cfg, params = _serving_model()
    params = quantize_params(params, bits=4)
    off = dataclasses.replace(cfg, decode_attn="xla")
    ids = torch.randint(0, cfg.vocab, (4, 40), generator=cuda,
                        device="cuda", dtype=torch.int32)
    la, ca = make_prefill(cfg)(params, ids[:, :32])
    lb, cb = make_prefill(off, use_kernels=False)(params, ids[:, :32])
    assert _err(la, lb) <= 3e-2
    for t in range(32, 40):
        la, ca = make_decode_step(cfg)(params, ca, ids[:, t])
        lb, cb = make_decode_step(off, use_kernels=False)(params, cb,
                                                          ids[:, t])
        assert _err(la, lb) <= 3e-2


def test_remat_lora_step_gives_the_same_losses(cuda):
    import dataclasses

    from tpp_mlir_tpu_torch.parallel import adamw
    from tpp_mlir_tpu_torch.serving import lora_init, make_lora_train_step
    cfg, params = _serving_model()
    ids = torch.randint(0, cfg.vocab, (2, 64), generator=cuda,
                        device="cuda", dtype=torch.int32)
    runs = []
    for remat in (False, True):
        rcfg = dataclasses.replace(cfg, remat=remat)
        ad = lora_init(params, rank=4, seed=0)
        step, init = make_lora_train_step(rcfg, adamw(1e-2))
        st = init(ad)
        runs.append([step(params, ad, st, ids)[2].item() for _ in range(2)])
    assert runs[0] == runs[1]


def test_tp_decode_graph_replay_equals_eager_over_nccl(cuda):
    """The tensor-parallel decode in a world of one NCCL rank on the card:
    replayed from a CUDA graph (its all-reduces captured) over shards that
    only the runner holds, fed the eager run's tokens, every step's logits
    are the eager step's, bit for bit, and finite."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from tpp_mlir_tpu_torch.parallel import make_mesh, shard_tree
    from tpp_mlir_tpu_torch.serving import (DecodeRunner, GptConfig,
                                            init_params, make_prefill)
    from tpp_mlir_tpu_torch.serving.engine import (decode_cache_specs,
                                                   decode_param_specs,
                                                   make_tp_decode_step)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        cfg = GptConfig(vocab=512, embed=128, heads=4, layers=3,
                        max_seq=96, dtype="bf16")
        params = init_params(cfg, seed=0)
        ids = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (4, 40)).astype(np.int32)).cuda()
        mesh = make_mesh({"tp": 1})
        step = make_tp_decode_step(mesh, cfg)
        runs = []
        for graph, feed in ((False, None), (True, "eager")):
            logits, cache = make_prefill(cfg)(params, ids)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            run = DecodeRunner(step, shard_tree(params, decode_param_specs(
                cfg), mesh), shard_tree(cache, decode_cache_specs(cfg),
                                        mesh), tok, graph)
            toks, lgs = [tok], []
            for t in range(8):
                lg = run(toks[t] if feed is None else runs[0][0][t]).clone()
                lgs.append(lg)
                toks.append(lg.argmax(-1).to(torch.int32))
            runs.append((toks, lgs))
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.isfinite(a).all() and torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# ---- forced launch plans (xsmm/tune.py, csrc/gemm_sm90.cuh resolve_plan) --

def _gemm_args(g, key):
    """A, B (N(0, 1/k)), C and a full-width D of a BrgemmKey."""
    a = _rnd(g, (key.batch, key.m, key.k), key.dtype)
    b = _rnd(g, (key.batch, key.k, key.n), key.dtype, key.k ** -0.5)
    c = None if key.beta0 else _rnd(g, (key.m, key.n), key.dtype)
    d = None
    if key.binary_kind:
        d = _rnd(g, (key.m, key.n) if key.binary_bcast == "none"
                 else (key.n,), key.dtype, 0.1)
    return a, b, c, d


def _forced(key, plan):
    from tpp_mlir_tpu_torch.xsmm import tune
    with tune.trial(key, dict(zip(("bm", "bn", "split"), plan))):
        return build_kernel(key)


FC = dict(batch=1, m=256, n=1024, k=1024, beta0=True, binary_kind="add",
          unary_kind="relu")


@pytest.mark.parametrize("dtype,precision", [
    ("f32", "default"), ("bf16", "default"), ("f32", "highest")])
def test_a_forced_plan_reaches_the_kernel(cuda, dtype, precision):
    """At fc 256 x 1024 x 1024 every legal tile at splits 1, 2, 4 and 16:
    the plan the Kernel records is the one the C++ launcher resolves for it
    (tpp_gemm_plan), the workspace is sized for it, and the result is the
    plain version's; the forced split repeats bit for bit."""
    from tpp_mlir_tpu_torch.xsmm import reference
    from tpp_mlir_tpu_torch.xsmm.kernels import gemm_plan
    key = BrgemmKey(dtype=dtype, precision=precision, **FC)
    args = _gemm_args(cuda, key)
    want = reference_kernel(key)(*args)
    tiles, most = reference.legal_gemm_plans(key)
    for bm, bn in tiles:
        for split in (s for s in (1, 2, 4, 16) if s <= most):
            kern = _forced(key, (bm, bn, split))
            card = gemm_plan(key, force=(bm, bn, split))
            assert tuple(kern.plan) == card[:3] == (bm, bn, split)
            assert kern._launch.work_bytes == card[3]
            assert (card[3] > 0) == (split > 1)
            got, again = kern(*args), kern(*args)
            torch.cuda.synchronize()
            assert _err(got, want) <= _tol(key), (bm, bn, split)
            assert torch.equal(got, again)


def test_a_launch_refuses_a_plan_its_workspace_was_not_sized_for(cuda):
    key = BrgemmKey(dtype="bf16", **FC)
    args = _gemm_args(cuda, key)
    kern = _forced(key, (64, 64, 4))
    kern(*args)
    kern._launch.work_bytes //= 2       # sized for another plan
    with pytest.raises(RuntimeError, match="launch failed"):
        kern(*args)
    kern = _forced(key, (64, 64, 4))
    kern._launch.plan = kern.plan._replace(split=99)   # more than 16 stages
    with pytest.raises(RuntimeError, match="launch failed"):
        kern(*args)


def test_an_illegal_plan_raises_naming_the_legal_set(cuda):
    from tpp_mlir_tpu_torch.xsmm.kernels import gemm_plan
    key = BrgemmKey(dtype="bf16", **FC)
    for plan in ((128, 64, 1), (64, 64, 17), (32, 32, 1)):
        with pytest.raises(ValueError, match="128x128, 64x128, 64x64"):
            _forced(key, plan)
        with pytest.raises(ValueError):
            gemm_plan(key, force=plan)
    hi = BrgemmKey(dtype="f32", precision="highest", **FC)
    with pytest.raises(ValueError, match="f32-FMA body"):
        _forced(hi, (64, 64, 2))


# The column run that starts at n (ROADMAP queue C): the ragged widths of
# the LN-stats cases (n 136, 200, 3000) under every tile and every split
# the key allows, with C and a full-width residual D read in the epilogue,
# and the ln_stats_out producer (no split) under every tile.
@pytest.mark.parametrize("m,n,k", [(100, 136, 512), (200, 200, 256),
                                   (256, 3000, 768)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ragged_widths_under_every_plan(cuda, m, n, k, dtype):
    from tpp_mlir_tpu_torch.xsmm import reference
    from tpp_mlir_tpu_torch.xsmm.reference import ln_stats_out
    g = cuda
    key = BrgemmKey(1, m, n, k, dtype, beta0=False, binary_kind="add",
                    binary_bcast="none", unary_kind="gelu")
    args = _gemm_args(g, key)
    want = reference_kernel(key)(*args)
    prod = BrgemmKey(1, m, n, k, dtype, beta0=True, binary_kind="add",
                     unary_kind="gelu", ln_stats_out=True)
    pargs = _gemm_args(g, prod)
    pwant = reference_kernel(prod)(*pargs)[0]
    tiles, most = reference.legal_gemm_plans(key)
    for bm, bn in tiles:
        for split in sorted({1, 2, most}):
            got = _forced(key, (bm, bn, split))(*args)
            torch.cuda.synchronize()
            assert _err(got, want) <= _tol(key), (bm, bn, split)
        y, mu, var = _forced(prod, (bm, bn, 1))(*pargs)
        torch.cuda.synchronize()
        assert _err(y, pwant) <= _tol(prod), (bm, bn)
        own_mu, own_var = ln_stats_out(y)
        assert _err(mu, own_mu) <= 1e-5 and _err(var, own_var) <= 1e-5


def test_forced_warm_panels_match_plain(cuda):
    """The flagship chain (B3) at panel rows x clusters the engine places
    and the card holds, each against the plain version; a plan it cannot
    place raises."""
    from tpp_mlir_tpu_torch.xsmm import reference, tune
    from tpp_mlir_tpu_torch.xsmm.kernels import warm_max_clusters
    key = ChainKey(m=256, dims=(1024,) * 4, dtype="bf16")
    g = cuda
    x = _rnd(g, (256, 1024), "bf16")
    wb = []
    for _ in range(3):
        wb += [_rnd(g, (1024, 1024), "bf16", 1024 ** -0.5),
               _rnd(g, (1024,), "bf16", 0.1)]
    want = reference_kernel(key)(x, *wb)
    for rows in reference.WARM_ROWS:
        for cluster in (1, 2, 4, 8, 16):
            plan = reference.warm_plan(key, rows=rows, cluster=cluster)
            if plan is None or not warm_max_clusters(rows, cluster,
                                                     plan.smem):
                continue
            with tune.trial(key, {"bm": rows, "cluster": cluster}):
                kern = build_kernel(key)
            assert (kern.plan.rows, kern.plan.cluster) == (rows, cluster)
            got = kern(x, *wb)
            torch.cuda.synchronize()
            assert _err(got, want) <= 1e-2, (rows, cluster)
    with tune.trial(key, {"bm": 48}):
        with pytest.raises(ValueError, match="rows in"):
            build_kernel(key)


# ROADMAP A14: every route an f16 key takes, with A = 1 + 2^-10 (exact in
# f16, 1.0 in bf16): the probes and their inputs are chip_smoke.py's
# phase_f16 (b) and phase_f16_transformer (b) (the GEMM family; B2, B12,
# attention, B21/B22), held here at their launch counts
F16_ROUTES = {label: (key, forced)
              for label, key, forced in chip_smoke.f16_route_probes()}


@pytest.mark.parametrize("name", list(F16_ROUTES))
def test_f16_products_are_not_bf16(cuda, name):
    key, forced = F16_ROUTES[name]
    kern = chip_smoke.f16_probe_kernel(key, forced)
    args, value = chip_smoke.f16_probe(key)
    got = kern(*args)
    torch.cuda.synchronize()
    want = reference_kernel(key)(*args)
    assert kern.launches == 1
    assert chip_smoke.f16_probe_holds(got, want, value), \
        (got, want) if isinstance(got, tuple) else \
        (got.flatten()[:4], want.flatten()[:4])


# ROADMAP A14 item 8: B13 (decode_attn.cu over an f16 cache, or f16 q over
# an int8 one), B14 (attention.cu's training mode) and B18
# (flash_train.cu's wgmma passes) at f16 keys against their plain
# versions: B13 1e-4 (f32 math from the same f16 values, f32 out), B14 and
# B18 2e-2 as their bf16 keys (P and dS rounded to bf16 on both sides, O
# and the grads bf16); and chip_smoke.py's phase_f16_attention probes
F16_ATTENTION = {
    "decode-mha": DecodeAttnKey(4, 6, 256, 64, "f16", stacked=3),
    "decode-slotted": DecodeAttnKey(4, 6, 256, 64, "f16", slotted=True,
                                    stacked=3),
    "decode-gqa-g3": DecodeAttnKey(4, 2, 256, 64, "f16", groups=3,
                                   stacked=3),
    "decode-pack2": DecodeAttnKey(4, 6, 256, 64, "f16", pack2=True,
                                  stacked=3),
    "decode-int8-kv": DecodeAttnKey(4, 6, 256, 64, "f16", kv_quant=True,
                                    stacked=3),
    "decode-d128-g8": DecodeAttnKey(2, 2, 128, 128, "f16", groups=8,
                                    stacked=3),
    "decode-d32": DecodeAttnKey(2, 4, 64, 32, "f16", stacked=3),
    "train-d64-causal-s200": FlashTrainKey(2, 4, 200, 64, "f16", True,
                                           0.125),
    "train-d32-tail": FlashTrainKey(2, 3, 100, 32, "f16", False,
                                    32 ** -0.5),
    "train-d128-causal": FlashTrainKey(1, 2, 200, 128, "f16", True,
                                       128 ** -0.5),
    "train-d128-full": FlashTrainKey(1, 2, 256, 128, "f16", False,
                                     128 ** -0.5),
}


@pytest.mark.parametrize("name", list(F16_ATTENTION))
def test_f16_attention_kernels_match_plain(cuda, name):
    key = F16_ATTENTION[name]
    if isinstance(key, DecodeAttnKey):
        pos = [0, key.seq, 100, key.seq - 1] if key.slotted else \
            [key.seq - 37]
        q, k, v, pos, kw = _decode_inputs(cuda, key, pos)
        kern = build_kernel(key)
        got = kern(q, k, v, pos, 1, **kw)
        want = reference_kernel(key)(q, k, v, pos, 1, **kw)
        torch.cuda.synchronize()
        assert kern.launches == 1 and got.dtype == torch.float32
        assert _err(got, want) <= 1e-4
        return
    q, k, v, do = (_rnd(cuda, (key.batch, key.seq, key.heads,
                               key.head_dim), "f16") for _ in range(4))
    fwd = build_kernel(key)
    o, lse2 = fwd(q, k, v)
    po, plse2 = reference_kernel(key)(q, k, v)
    assert fwd.route == "wgmma" and o.dtype == torch.bfloat16
    assert _err(o, po) <= 2e-2 and _err(lse2, plse2) <= 1e-4
    delta = (do.float() * po.float()).sum(-1).transpose(1, 2).contiguous()
    bkey = FlashTrainBwdKey(**dataclasses.asdict(key))
    bwd = build_kernel(bkey)
    got = bwd(q, k, v, do, plse2, delta)
    again = bwd(q, k, v, do, plse2, delta)
    want = reference_kernel(bkey)(q, k, v, do, plse2, delta)
    torch.cuda.synchronize()
    assert bwd.route == "wgmma" and bwd.launches == 2
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert _err(a, w) <= 2e-2


F16_ATTENTION_PROBES = {label: (key, probe) for label, key, probe
                        in chip_smoke._f16_attention_probes()}


@pytest.mark.parametrize("name", list(F16_ATTENTION_PROBES))
def test_f16_attention_probes(cuda, name):
    """The operands are read in f16 (a bf16 q, K, V or dO would move the
    output) and P and dS are rounded to bf16 (P kept in f16 would move
    it): chip_smoke.py's f16_attention_probe."""
    key, probe = F16_ATTENTION_PROBES[name]
    args, kw, readings, model, subject = chip_smoke.f16_attention_probe(
        key, probe)
    kern = build_kernel(key)
    got = kern(*args, **kw)
    want = reference_kernel(key)(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert chip_smoke.f16_attention_probe_holds(got, want, readings, model,
                                                subject)


# ROADMAP A14's last item: keys mixing 16-bit types (f16 products with a
# bf16 output, bf16 or f32 products with an f16 output), each route's key
# with C, D and biases in the table's type (chip_smoke.py's phase_f16_mixed
# (a) rows, at its tolerances) and the rounding probes ((b): one rounding of
# an exact f32 sum where the JAX body casts once, the plain version's
# rounding through the products' type at B4, B5, B20 and B11)
MIXED = {label: (key, forced, cd)
         for label, key, forced, cd in chip_smoke._mixed_rows()}
MIXED_PROBES = {label: (key, forced, summands)
                for label, key, forced, summands in chip_smoke.mixed_probes()}


@pytest.mark.parametrize("name", list(MIXED))
def test_mixed_keys_match_their_plain_versions(cuda, name):
    key, forced, cd = MIXED[name]
    args, kw = chip_smoke.mixed_inputs(key, cd, cuda)
    kern = chip_smoke.f16_probe_kernel(key, forced)
    got = chip_smoke._outputs(kern(*args, **kw))
    want = chip_smoke._outputs(reference_kernel(key)(*args, **kw))
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert got[0].dtype == want[0].dtype
    assert all(torch.isfinite(x.float()).all() for x in got)
    assert max(_err(x, y) for x, y in zip(got, want)) <= \
        chip_smoke._mixed_tol(key)


@pytest.mark.parametrize("name", list(MIXED_PROBES))
def test_mixed_keys_round_as_the_jax_bodies(cuda, name):
    key, forced, summands = MIXED_PROBES[name]
    args, kw, exact = chip_smoke.mixed_probe(key, summands)
    kern = chip_smoke.f16_probe_kernel(key, forced)
    got = kern(*args, **kw)
    want = reference_kernel(key)(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert chip_smoke.mixed_probe_holds(got, want, exact), \
        (got.flatten()[:4], want.flatten()[:4])
