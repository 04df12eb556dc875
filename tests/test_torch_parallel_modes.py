"""The port's tp MHA, pipeline, ring attention and expert-parallel MoE
(tpp_mlir_tpu_torch.parallel.transformer, pipeline, sequence, moe) against
the JAX package's sharded functions on meshes of the same shape.

One gloo world of 4 ranks on the CPU (`modes_world` in
tests/torch_parallel_workers.py) runs every case from the JAX package's
initial params passed as numpy and returns the gathered outputs (and the
ring attention's gradients, and the pipeline's losses and params); the
JAX side runs `make_mha_forward`, `make_pipeline_forward`,
`make_pipeline_train_step`, `make_ring_attention` and `make_moe_forward`
over `make_mesh` on its virtual CPU devices, the Pallas kernels off.

Tolerances: f32 1e-5 (gradients and pipeline training 1e-4), bf16 1e-2.
Two cases run the port's kernels (their plain versions here): the tp MHA
through B7 at heads/tp and the pipeline through B1; at their keys' f32
"default" precision both round the operands to bf16, as the compiled TPU
kernels do, so they are held at 1e-2 against the JAX f32 functions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tpp_mlir_tpu.parallel import (make_mesh, make_mha_forward,
                                   make_moe_forward, make_pipeline_forward,
                                   make_pipeline_train_step,
                                   make_ring_attention, mha_params, moe_init,
                                   pipeline_init)
from tpp_mlir_tpu_torch.parallel import World

MHA_CASES = {"dp2tp2": ({"dp": 2, "tp": 2}, "float32", False, False),
             "tp4-causal": ({"dp": 1, "tp": 4}, "float32", True, False),
             "tp2-bf16": ({"dp": 1, "tp": 2}, "bfloat16", False, False),
             "tp2-kernels": ({"dp": 1, "tp": 2}, "float32", True, True)}
PIPE_CASES = {"pp4-m4": (4, 1, 4, False), "pp4-m5": (4, 1, 5, False),
              "pp2-kernels": (2, 1, 4, True)}
PIPE_TRAIN = {"pp4": {"pp": 4}, "pp2-dp2": {"pp": 2, "dp": 2}}
RING_CASES = {"causal": (True, "float32"), "full": (False, "float32"),
              "causal-bf16": (True, "bfloat16")}
MOE_CASES = {"e4": (4, None, "float32"), "e8": (8, None, "float32"),
             "e4-drops": (4, 2, "float32"), "e8-bf16": (8, None, "bfloat16")}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a):
    return np.asarray(a).view(np.uint16)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def data():
    bf = jnp.bfloat16
    d = {"mha_float32": _np(mha_params(32, 8, seed=0)),
         "mha_bfloat16": jax.tree.map(_bits, mha_params(32, 8, dtype=bf,
                                                        seed=0)),
         "mha_x_float32": _normal(1, (4, 8, 32)),
         "pipe4": _np(pipeline_init(16, 4, seed=2)),
         "pipe2": _np(pipeline_init(16, 2, seed=3)),
         "pipe_xs": _normal(4, (5, 8, 16)), "pipe_ys": _normal(5, (5, 8, 16)),
         "ring_q": _normal(6, (2, 16, 2, 8)), "ring_k": _normal(7, (2, 16, 2, 8)),
         "ring_v": _normal(8, (2, 16, 2, 8)), "ring_ct": _normal(9, (2, 16, 2, 8)),
         "moe4": _np(moe_init(16, 32, 4, seed=10)),
         "moe8": _np(moe_init(16, 32, 8, seed=11)),
         "moe_x": _normal(12, (32, 16))}
    d["mha_x_bfloat16"] = _bits(jnp.asarray(d["mha_x_float32"], bf))
    return d


def _jax_refs(d):
    refs = {}
    for name, (shape, dtype, causal, _) in MHA_CASES.items():
        p = jax.tree.map(lambda a: jnp.asarray(a).view(jnp.bfloat16)
                         if dtype == "bfloat16" else jnp.asarray(a),
                         d["mha_" + dtype])
        x = jnp.asarray(d["mha_x_" + dtype])
        if dtype == "bfloat16":
            x = x.view(jnp.bfloat16)
        refs["mha-" + name] = make_mha_forward(
            make_mesh(shape), 32, 8, causal=causal, use_pallas=False)(p, x)
    for name, (pp, _, n_micro, _) in PIPE_CASES.items():
        refs["pipe-" + name] = make_pipeline_forward(
            make_mesh({"pp": pp}), 16, use_pallas=False)(
                d[f"pipe{pp}"], jnp.asarray(d["pipe_xs"][:n_micro]))
    for name, shape in PIPE_TRAIN.items():
        step, init = make_pipeline_train_step(
            make_mesh(shape), 16, optax.sgd(1e-2),
            dp_axis="dp" if "dp" in shape else None, use_pallas=False)
        p = jax.tree.map(jnp.asarray, d[f"pipe{shape['pp']}"])
        s, losses = init(p), []
        for _ in range(3):
            p, s, loss = step(p, s, jnp.asarray(d["pipe_xs"]),
                              jnp.asarray(d["pipe_ys"]))
            losses.append(float(loss))
        refs["pipetrain-" + name] = (losses, p)
    sp = make_mesh({"sp": 4})
    for name, (causal, dtype) in RING_CASES.items():
        q, k, v = (jnp.asarray(d["ring_" + c]).astype(dtype) for c in "qkv")
        attn = make_ring_attention(sp, 2, causal=causal)
        o, vjp = jax.vjp(attn, q, k, v)
        refs["ring-" + name] = o
        if dtype == "float32":
            refs["ringgrad-" + name] = vjp(jnp.asarray(d["ring_ct"]))
    ep = make_mesh({"ep": 4})
    for name, (n_e, cap, dtype) in MOE_CASES.items():
        p = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype),
                         d[f"moe{n_e}"])
        refs["moe-" + name] = make_moe_forward(ep, 16, 32, n_e,
                                               capacity=cap)(
            p, jnp.asarray(d["moe_x"]).astype(dtype))
    return _np(refs)


@pytest.fixture(scope="module")
def runs(data):
    from torch_parallel_workers import modes_world
    world = World(modes_world, 4, "gloo", "cpu", (data,))
    refs = _jax_refs(data)
    return world.result()[0], refs


def _close(got, want, tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("name", list(MHA_CASES))
def test_tp_mha_matches_jax(runs, name):
    got, want = runs
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[MHA_CASES[name][1]]
    _close(got["mha-" + name], want["mha-" + name],
           1e-2 if MHA_CASES[name][3] else tol)


@pytest.mark.parametrize("name", list(PIPE_CASES))
def test_pipeline_forward_matches_jax(runs, name):
    got, want = runs
    _close(got["pipe-" + name], want["pipe-" + name],
           1e-2 if PIPE_CASES[name][3] else 1e-5)


@pytest.mark.parametrize("name", list(PIPE_TRAIN))
def test_pipeline_train_matches_jax(runs, name):
    """Three GPipe SGD steps: the backward runs the schedule in reverse
    through ring_shift's dual (and, at pp 2 x dp 2, one mean over dp)."""
    got, want = runs
    (gl, gp), (wl, wp) = got["pipetrain-" + name], want["pipetrain-" + name]
    _close(gl, wl, 1e-5)
    _close([gp["b"], gp["w"]], [wp["b"], wp["w"]], 1e-4)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_jax(runs, name):
    got, want = runs
    tol = 1e-2 if "bf16" in name else 1e-5
    _close(got["ring-" + name], want["ring-" + name], tol)
    assert np.isfinite(got["ring-" + name]).all()


@pytest.mark.parametrize("name", ["causal", "full"])
def test_ring_attention_grads_match_jax(runs, name):
    """dq, dk, dv through the K/V ring (the early causal steps' fully
    masked rows stay finite)."""
    got, want = runs
    _close(got["ringgrad-" + name], want["ringgrad-" + name], 1e-4)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_matches_jax(runs, name):
    """Lossless routing at 4 and 8 experts, a capacity of 2 a rank that
    drops tokens (the (source, position) order of the exchange shows there),
    and bf16."""
    got, want = runs
    _close(got["moe-" + name], want["moe-" + name],
           1e-2 if "bf16" in name else 1e-5)


def test_the_dropping_case_drops_tokens(runs):
    """Capacity 2 of 8 tokens a rank: some tokens come back zero."""
    got, _ = runs
    drops = got["moe-e4-drops"]
    assert (np.abs(drops).sum(1) == 0).any()
    assert not (np.abs(got["moe-e4"]).sum(1) == 0).any()
