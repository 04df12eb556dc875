"""B15's plan and routes and B12's route, and the int8 weights' K-major
copies, on the CPU.

reference.int8_gemm_plan and int8_gemm_route (csrc/int8_gemm.cu) and
layer_norm_route (csrc/layer_norm.cu) are pure functions of the key. These
tests pin them at chip_smoke.py's keys and the `cuda` tests' keys, check
every plan's geometry against the kernel's limits (and emulate the
persistent schedule's walk over tiles and k slices), and show that every
key the first designs took is still taken. The engine's K-major copies
(QTensor.qt) must equal q.T bit for bit, change nothing the decode step or
quantized_bytes read, and the int8-compute prefill must still match the
JAX engine.
"""

import math

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P
from tpp_mlir_tpu_torch.xsmm import (Int8GemmKey, LayerNormKey, build_kernel,
                                     reference_kernel)
from tpp_mlir_tpu_torch.xsmm.kernels import (SM90_SMEM_OPTIN, build_int8,
                                             build_layer_norm)
from tpp_mlir_tpu_torch.xsmm.reference import (H100_SMS, INT8_BK, LN_MAX_VPL,
                                               Int8Plan, int8_gemm_plan,
                                               int8_gemm_route,
                                               int8_smem_bytes,
                                               layer_norm_route)

BIG = 224816      # 128 x 192 tiles, 3 stages
SMALL = 182592    # 64 x 192 tiles, 4 stages

# (key, its plan): chip_smoke.py's int8 prefill keys (B 8 x S 512 rows) and
# ragged m, and tests/test_torch_cuda.py's keys
INT8_PINNED = {
    "prefill-qkv": (Int8GemmKey(4096, 768, 768, has_bias=True),
                    Int8Plan(128, 192, 3, 1, 128, 128, False, BIG)),
    "prefill-fc1": (Int8GemmKey(4096, 3072, 768, has_bias=True,
                                unary_kind="gelu"),
                    Int8Plan(128, 192, 3, 1, 512, 132, True, BIG)),
    "prefill-fc2": (Int8GemmKey(4096, 768, 3072, has_bias=True),
                    Int8Plan(128, 192, 3, 1, 128, 128, False, BIG)),
    "prefill-lm-head": (Int8GemmKey(4096, 50304, 768),
                        Int8Plan(128, 192, 3, 1, 8384, 132, True, BIG)),
    "ragged-33": (Int8GemmKey(33, 768, 768, has_bias=True,
                              unary_kind="gelu"),
                  Int8Plan(64, 192, 4, 1, 4, 4, False, SMALL)),
    "bias-f32": (Int8GemmKey(256, 384, 768, has_bias=True),
                 Int8Plan(128, 192, 3, 1, 4, 4, False, BIG)),
    "ragged-gelu-bf16": (Int8GemmKey(33, 200, 64, has_bias=True,
                                     unary_kind="gelu", out_dtype="bf16"),
                         Int8Plan(64, 192, 4, 1, 2, 2, False, SMALL)),
    "lm-head-width": (Int8GemmKey(128, 50304, 128),
                      Int8Plan(128, 192, 3, 1, 262, 132, True, BIG)),
    "ragged-m-n": (Int8GemmKey(1000, 1001, 784, has_bias=True,
                               unary_kind="gelu"),
                   Int8Plan(128, 192, 3, 1, 48, 48, False, BIG)),
    "split-k": (Int8GemmKey(64, 256, 3072, has_bias=True, unary_kind="relu"),
                Int8Plan(64, 192, 4, 6, 12, 12, False, SMALL)),
}

# (key, its route): chip_smoke.py's B12 keys (GPT-2's ln_f, the encoder's)
# and the cuda tests' keys, the register template's edges and past them
LN_PINNED = {
    "ln-f-2048x768-bf16": (LayerNormKey(2048, 768, "bf16"), "register"),
    "enc-2048x1024-f32": (LayerNormKey(2048, 1024, "f32"), "register"),
    "bf16-768": (LayerNormKey(100, 768, "bf16"), "register"),
    "f32-in-bf16-out": (LayerNormKey(33, 200, "f32", out_dtype="bf16",
                                     eps=1e-6), "register"),
    "bf16-8-one-vector": (LayerNormKey(17, 8, "bf16"), "register"),
    "bf16-2048-edge": (LayerNormKey(40, 2048, "bf16"), "register"),
    "bf16-2056-past": (LayerNormKey(40, 2056, "bf16"), "strided"),
    "f32-1028-past": (LayerNormKey(9, 1028, "f32"), "strided"),
    "bf16-100-ragged": (LayerNormKey(5, 100, "bf16"), "strided"),
}


@pytest.mark.parametrize("name", list(INT8_PINNED))
def test_int8_plan_and_route_are_pinned(name):
    key, plan = INT8_PINNED[name]
    assert int8_gemm_route(key) == "wgmma"
    assert int8_gemm_plan(key) == plan


@pytest.mark.parametrize("name", list(LN_PINNED))
def test_layer_norm_route_is_pinned(name):
    key, route = LN_PINNED[name]
    assert layer_norm_route(key) == route


def _walk(key, plan):
    """The kernel's walk, emulated: block b takes tiles b, b + grid, ...;
    tile t is (k slice t % split, m tile, n tile) with m fastest; split ks
    takes k stages ks KT / split .. (ks + 1) KT / split. Returns the
    (m tile, n tile, k stage) triples visited and the tiles per block."""
    tiles_m = -(-key.m // plan.bm)
    kt = -(-key.k // INT8_BK)
    seen, per_block = [], []
    for b in range(plan.grid):
        mine = range(b, plan.tiles, plan.grid)
        per_block.append(len(mine))
        for t in mine:
            ks, r = t % plan.split, t // plan.split
            mt, nt = r % tiles_m, r // tiles_m
            lo, hi = ks * kt // plan.split, (ks + 1) * kt // plan.split
            assert hi > lo, "every split has a k stage"
            seen += [(mt, nt, s) for s in range(lo, hi)]
    return seen, per_block


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 9000), n=st.integers(1, 60000),
       k16=st.integers(1, 256), out_dtype=st.sampled_from(["f32", "bf16"]),
       unary=st.sampled_from([None, "gelu", "relu", "tanh"]),
       has_bias=st.booleans())
def test_int8_plan_geometry(m, n, k16, out_dtype, unary, has_bias):
    """Every key the first design took (k a multiple of 16) takes the wgmma
    body; its tiles cover m x n, its shared memory fits a block, the grid is
    one wave unless the plan says persistent, a k split only comes under
    half a wave and gives each split four stages or more."""
    key = Int8GemmKey(m=m, n=n, k=16 * k16, out_dtype=out_dtype,
                      unary_kind=unary, has_bias=has_bias)
    assert int8_gemm_route(key) == "wgmma"
    build_kernel(key)
    p = int8_gemm_plan(key)
    assert p.bm == (128 if m > 64 else 64)
    assert p.bn == (192 if n > 128 else 128)
    tiles_m, tiles_n = -(-m // p.bm), -(-n // p.bn)
    assert tiles_m * p.bm >= m and tiles_n * p.bn >= n
    assert (tiles_m - 1) * p.bm < m and (tiles_n - 1) * p.bn < n
    assert p.tiles == tiles_m * tiles_n * p.split
    assert p.smem == int8_smem_bytes(p.bm, p.bn, p.stages) <= SM90_SMEM_OPTIN
    assert p.grid == min(p.tiles, H100_SMS)
    assert p.persistent == (p.tiles > H100_SMS)
    kt = -(-key.k // INT8_BK)
    if p.split > 1:
        assert 2 * tiles_m * tiles_n <= H100_SMS
        assert p.tiles <= H100_SMS and kt // p.split >= 4


@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 700), n=st.integers(1, 2000), k16=st.integers(1, 64))
def test_int8_walk_visits_every_tile_and_stage_once(m, n, k16):
    key = Int8GemmKey(m=m, n=n, k=16 * k16)
    p = int8_gemm_plan(key)
    seen, per_block = _walk(key, p)
    want = {(mt, nt, s) for mt in range(-(-m // p.bm))
            for nt in range(-(-n // p.bn))
            for s in range(-(-key.k // INT8_BK))}
    assert len(seen) == len(want) and set(seen) == want
    assert max(per_block) - min(per_block) <= 1


def test_int8_walk_at_the_lm_head():
    """The LM head's 8,384 tiles over 132 persistent blocks: 63 or 64 each,
    every (m tile, n tile) once; the prefill's 4096 x 768 keys one tile a
    block, one wave."""
    key, plan = INT8_PINNED["prefill-lm-head"]
    seen, per_block = _walk(key, plan)
    assert sorted(set(per_block)) == [63, 64]
    assert len(seen) == len(set(seen)) == 32 * 262 * 6
    for name in ("prefill-qkv", "prefill-fc2"):
        key, plan = INT8_PINNED[name]
        assert _walk(key, plan)[1] == [1] * 128


def test_int8_route_refuses_what_no_body_takes():
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_gemm_route(Int8GemmKey(m=64, n=64, k=40))
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_gemm_plan(Int8GemmKey(m=64, n=64, k=40))
    with pytest.raises(ValueError, match="unknown int8 GEMM route"):
        build_int8(Int8GemmKey(m=64, n=64, k=64), "tma")
    # on the CPU the plain version takes any k, as before
    key = Int8GemmKey(m=33, n=8, k=40)
    xq = torch.ones(33, 40, dtype=torch.int8)
    wq = torch.ones(40, 8, dtype=torch.int8)
    xs, ws = torch.ones(33), torch.ones(1, 8)
    assert torch.equal(build_kernel(key)(xq, wq, xs, ws),
                       torch.full((33, 8), 40.0))


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 5000), dtype=st.sampled_from(["f32", "bf16"]))
def test_layer_norm_route_follows_the_register_template(n, dtype):
    """"register" exactly where a row is whole 16-byte vectors and a lane
    holds at most LN_MAX_VPL of them; any other n keeps the strided body,
    so every key is still taken."""
    key = LayerNormKey(m=3, n=n, dtype=dtype)
    es = 4 if dtype == "f32" else 2
    fits = n * es % 16 == 0 and math.ceil(n * es / 16 / 32) <= LN_MAX_VPL
    assert layer_norm_route(key) == ("register" if fits else "strided")
    build_kernel(key)
    build_layer_norm(key, "strided")


def test_forced_bodies_run_the_plain_version_on_the_cpu():
    """build_int8 / build_layer_norm force a body; on CPU tensors either
    runs the plain version. A strided-only width refuses "register"; B15's
    wrapper takes the K-major copy and gives the same output without it."""
    g = torch.Generator().manual_seed(0)
    key = Int8GemmKey(m=40, n=24, k=32, has_bias=True, unary_kind="gelu")
    xq = torch.randint(-127, 128, (40, 32), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (32, 24), generator=g, dtype=torch.int8)
    args = (xq, wq, torch.rand(40, generator=g), torch.rand(1, 24,
                                                            generator=g),
            torch.randn(24, generator=g).to(torch.bfloat16))
    want = reference_kernel(key)(*args)
    for kern in (build_kernel(key), build_int8(key, "wmma"),
                 build_int8(key, "wgmma")):
        assert torch.equal(kern(*args, wt=wq.t().contiguous()), want)
        assert torch.equal(kern(*args), want)
        assert kern.launches == 0
    ln = LayerNormKey(m=4, n=100, dtype="bf16")
    with pytest.raises(ValueError, match="cannot run"):
        build_layer_norm(ln, "register")
    x = torch.randn(4, 100, generator=g).to(torch.bfloat16)
    gamma, beta = torch.randn(100, generator=g), torch.randn(100, generator=g)
    assert torch.equal(build_layer_norm(ln, "strided")(x, gamma, beta),
                       reference_kernel(ln)(x, gamma, beta))


BASE = dict(vocab=96, embed=64, heads=4, layers=2, mlp_ratio=4, max_seq=24)
MATMUL = ("wq", "wk", "wv", "wo", "w1", "w2")


def _kmajor_ok(params) -> None:
    leaves = [params["lm_head"]] + [blk[k] for blk in params["blocks"]
                                    for k in MATMUL]
    for w in leaves:
        assert isinstance(w, P.QTensor) and w.qt is not None
        assert w.qt.is_contiguous() and w.qt.dtype == torch.int8
        assert torch.equal(w.qt, w.q.t())


def test_kmajor_copies_equal_q_transposed():
    """params_from_numpy under int8 compute and with_kmajor give every
    int8-compute weight qt == q.T bit for bit;
    without int8 compute there is none; q, scale and quantized_bytes (the
    decode denominator) do not change; stack_params carries qt."""
    jcfg = J.GptConfig(dtype="f32", int8_compute=True, **BASE)
    jq = J.quantize_params(J.init_params(jcfg, seed=7))
    tree = jax.tree.map(np.asarray, jq)
    pcfg = P.GptConfig(dtype="f32", int8_compute=True, **BASE)
    carried = P.params_from_numpy(tree, pcfg, device="cpu")
    _kmajor_ok(carried)
    plain = P.params_from_numpy(
        tree, P.GptConfig(dtype="f32", kv_quant="int8", **BASE),
        device="cpu")
    assert plain["lm_head"].qt is None
    assert torch.equal(plain["lm_head"].q, carried["lm_head"].q)
    assert P.quantized_bytes(carried) == P.quantized_bytes(plain) == \
        J.quantized_bytes(jq)
    pp = P.init_params(P.GptConfig(dtype="f32", **BASE), seed=0,
                       device="cpu")
    made = P.with_kmajor(P.quantize_params(pp))
    _kmajor_ok(made)
    stacked = dict(made)
    stacked["blocks"] = {
        k: (P.QTensor(*(torch.stack([getattr(b[k], f) for b in
                                     made["blocks"]])
                        for f in ("q", "scale", "qt")))
            if isinstance(v, P.QTensor)
            else torch.stack([b[k] for b in made["blocks"]]))
        for k, v in made["blocks"][0].items()}
    _kmajor_ok(P.stack_params(stacked))


def test_int8_compute_prefill_with_kmajor_copies_matches_jax():
    """The int8-compute prefill reads the K-major copies where the params
    carry them: the same logits as without them, bit for bit, and the JAX
    engine's within the serving tests' f32 tolerance."""
    jcfg = J.GptConfig(dtype="f32", int8_compute=True, **BASE)
    jq = J.quantize_params(J.init_params(jcfg, seed=7))
    pcfg = P.GptConfig(dtype="f32", int8_compute=True, **BASE)
    params = P.params_from_numpy(jax.tree.map(np.asarray, jq), pcfg,
                                 device="cpu")
    bare = dict(params)
    bare["lm_head"] = params["lm_head"]._replace(qt=None)
    bare["blocks"] = [{k: v._replace(qt=None) if isinstance(v, P.QTensor)
                       else v for k, v in blk.items()}
                      for blk in params["blocks"]]
    ids = np.random.default_rng(7).integers(0, BASE["vocab"],
                                            (2, 16)).astype(np.int32)
    got, _ = P.make_prefill(pcfg)(params, torch.from_numpy(ids))
    again, _ = P.make_prefill(pcfg)(bare, torch.from_numpy(ids))
    want, _ = J.make_prefill(jcfg, use_pallas=False)(jq, ids)
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-4, rtol=1e-4)
