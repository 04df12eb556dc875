"""The port's tensor-parallel decode (serving/engine.py
`make_tp_decode_step`, `decode_param_specs`, `decode_cache_specs`), the tp
batching engine (serving/batching.py) and `tpp_serve --tp`, against the
JAX package's tp decode on a tp=2 mesh of its virtual CPU devices and
against the port's own single-device decode.

One gloo world of 2 ranks on the CPU (`tp_serving_world` in
tests/torch_parallel_workers.py) runs every case from the JAX package's
params passed as numpy: the unsharded prefill, then 8 greedy decode steps
on each rank's shards, and the same 8 steps on one device. f32 weights are
token-exact for all 8 steps, their logits within 1e-5 of the JAX tp decode
and of the single device; int8 and int4 weights and the int8 KV cache are
held at 1e-4 (the same integer values on both sides; only the sum order
over the two shards differs); the decode-kernel cases reach B13's plain
version at kv_h/tp KV heads. The MoE refusal is the JAX package's, in its
words."""

import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as S
from tpp_mlir_tpu.parallel import make_mesh as jax_make_mesh
from tpp_mlir_tpu.serving.engine import \
    decode_cache_specs as jax_cache_specs
from tpp_mlir_tpu.serving.engine import \
    decode_param_specs as jax_param_specs
from tpp_mlir_tpu.serving.engine import make_tp_decode_step as jax_tp_step
from tpp_mlir_tpu_torch.parallel import Mesh, P, World, shard_tree
from tpp_mlir_tpu_torch.serving.engine import (decode_cache_specs,
                                               decode_param_specs,
                                               make_tp_decode_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = dict(vocab=96, embed=64, heads=4, layers=2, mlp_ratio=2, max_seq=24,
             dtype="f32")
TP_CASES = {"f32": ({}, 0), "gqa": ({"kv_heads": 2}, 0), "int8": ({}, 8),
            "int4": ({}, 4), "kv-int8": ({"kv_quant": "int8"}, 0),
            "decode-kernel": ({"decode_attn": "pallas"}, 0),
            "gqa-kv-int8-kernel": ({"kv_heads": 2, "kv_quant": "int8",
                                    "decode_attn": "pallas"}, 0)}
JAX_CASES = ["f32", "gqa", "int8", "kv-int8"]
STEPS = 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    params = {kvh: J.init_params(J.GptConfig(**SERVE, kv_heads=kvh), seed=3)
              for kvh in (4, 2)}
    return {"serve_params": {k: jax.tree.map(np.asarray, v)
                             for k, v in params.items()},
            "serve_ids": rng.integers(0, SERVE["vocab"], (2, 6)).astype(
                np.int32),
            "serve_prompts": [rng.integers(0, SERVE["vocab"], n).astype(
                np.int32) for n in (5, 9, 3)]}


def _jax_tp(d, name):
    """The JAX tp decode at tp 2: (tokens, logits) of 8 greedy steps."""
    extra, bits = TP_CASES[name]
    cfg = J.GptConfig(**SERVE, **extra)
    params = jax.tree.map(jnp.asarray, d["serve_params"][cfg.kv_h])
    if bits:
        params = J.quantize_params(params, bits=bits)
    logits, cache = J.make_prefill(cfg, use_pallas=False)(
        params, jnp.asarray(d["serve_ids"]))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    step = jax_tp_step(jax_make_mesh({"tp": 2}), cfg, quantized=bool(bits))
    toks, lgs = [], []
    for _ in range(STEPS):
        lg, cache = step(params, cache, tok)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        lgs.append(np.asarray(lg))
    return np.stack(toks, 1), np.stack(lgs, 1)


@pytest.fixture(scope="module")
def runs(data):
    from torch_parallel_workers import tp_serving_world
    world = World(tp_serving_world, 2, "gloo", "cpu", (data,))
    refs = {name: _jax_tp(data, name) for name in JAX_CASES}
    return world.result(), refs


@pytest.mark.parametrize("name", JAX_CASES)
def test_tp_decode_matches_the_jax_tp_decode(runs, name):
    """Tokens equal for 8 steps. With the int8 KV cache each step writes
    its K/V requantized from f32 values whose last bits follow each
    package's sum order, and one int8 value may move by one: its logits are
    held at the first step, from the caches the two prefills write
    bit-equal (test_torch_serving.py)."""
    world, refs = runs
    toks, logits = world[0]["tp-" + name]
    jtoks, jlogits = refs[name]
    tol = 1e-5 if TP_CASES[name] == ({}, 0) else 1e-4
    np.testing.assert_array_equal(toks, jtoks)
    steps = 1 if "kv_quant" in TP_CASES[name][0] else STEPS
    np.testing.assert_allclose(logits[:, :steps], jlogits[:, :steps],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_decode_matches_the_single_device(runs, name):
    """Every rank's tokens and logits equal the one-device decode: f32
    token-exact for 8 steps, low-bit weights and caches within 1e-4."""
    world, _ = runs
    tol = 1e-5 if name in ("f32", "gqa", "decode-kernel") else 1e-4
    for out in world:
        toks, logits = out["tp-" + name]
        otoks, ologits = out["one-" + name]
        np.testing.assert_array_equal(toks, otoks)
        np.testing.assert_allclose(logits, ologits, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["f32", "gqa", "kv-int8"])
def test_each_rank_holds_its_heads_of_the_cache(runs, name):
    world, _ = runs
    extra = TP_CASES[name][0]
    kvh = extra.get("kv_heads", SERVE["heads"]) // 2
    shapes = world[0]["shapes-" + name]
    assert shapes["k"] == shapes["v"] == (2, 2, kvh, 24, 16)
    if "kv_quant" in extra:
        assert shapes["k_s"] == (2, 2, kvh, 24)


def test_tp_batching_engine_matches_the_single_device(runs):
    world, _ = runs
    for out in world:
        assert out["batching-tp"] == out["batching-one"]
        assert all(len(t) == 5 for t in out["batching-tp"])


def _spec_tree(tree):
    """A spec tree of either package as dicts, lists and tuples: a QTensor
    spec as [q, scale], a spec as the tuple of its parts."""
    if isinstance(tree, (S.QTensor, J.QTensor)):
        return [tuple(tree.q), tuple(tree.scale)]
    if isinstance(tree, (P, JP)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return [_spec_tree(v) for v in tree]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("extra", [{}, {"kv_quant": "int8"}, "llama",
                                   {"n_experts": 4}],
                         ids=["gpt", "kv-int8", "llama", "moe"])
def test_specs_are_the_jax_specs(extra, quantized):
    """decode_param_specs (per-layer list) and decode_cache_specs give
    every leaf the JAX package's spec."""
    if extra == "llama":
        jcfg = J.GptConfig.llama(**SERVE)
        pcfg = S.GptConfig.llama(**SERVE)
    else:
        jcfg, pcfg = J.GptConfig(**SERVE, **extra), S.GptConfig(**SERVE,
                                                                **extra)
    assert _spec_tree(decode_param_specs(pcfg, quantized=quantized)) == \
        _spec_tree(jax_param_specs(jcfg, quantized=quantized))
    assert _spec_tree(decode_cache_specs(pcfg)) == \
        _spec_tree(jax_cache_specs(jcfg))


def test_moe_tp_decode_is_refused_in_jax_words():
    with pytest.raises(AssertionError) as want:
        jax_tp_step(jax_make_mesh({"tp": 2}), J.GptConfig(
            **SERVE, n_experts=4), quantized=False)
    with pytest.raises(NotImplementedError) as got:
        make_tp_decode_step({"tp": 2}, S.GptConfig(**SERVE, n_experts=4))
    assert str(got.value) == str(want.value)


def test_an_odd_int4_column_split_is_refused_naming_int4():
    """int4 packs two values a byte along the columns: a column shard must
    hold an even count. 12 columns over tp 2 split, 6 over 2 do not (a
    mesh of two axis positions with no world: shard_tree alone)."""
    w = S.quantize(__import__("torch").randn(8, 12), bits=4)
    mesh = Mesh({"tp": 2})
    specs = S.QTensor(q=P(None, "tp"), scale=P(None, "tp"))
    got = shard_tree(w, specs, mesh)
    assert got.dims == (8, 6) and got.q.shape == (8, 3)
    np.testing.assert_array_equal(got.values().numpy(),
                                  w.values()[:, :6].numpy())
    odd = S.quantize(__import__("torch").randn(8, 6), bits=4)
    with pytest.raises(ValueError, match="int4"):
        shard_tree(odd, specs, mesh)


def test_tpp_serve_tp_under_torchrun():
    """`tpp_serve --tp 2 --device cpu` under torch.distributed.run with two
    gloo ranks: rank 0 prints the single-device tool's tokens."""
    from tpp_mlir_tpu_torch.tools import tpp_serve
    flags = ["--vocab", "96", "--embed", "64", "--heads", "4", "--layers",
             "2", "--max-seq", "24", "--prompt-len", "6", "--steps", "5",
             "--dtype", "f32", "--batch", "2", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tpp_mlir_tpu_torch.tools.tpp_serve",
         "--tp", "2"] + flags, capture_output=True, text=True, env=env,
        timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert lines[0].startswith("# tp=2 decode (gloo, eager): 4 steps")
    out = io.StringIO()
    assert tpp_serve.main(flags, out=out) == 0
    assert lines[1:] == out.getvalue().splitlines()[1:]
