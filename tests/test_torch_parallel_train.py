"""The port's sharded training steps against the JAX package's on meshes of
the same shape: the dp x tp MLP SGD step (tpp_mlir_tpu_torch.parallel.train),
the optimizer step with accumulation and ZeRO-1 (optim.py), ZeRO-1
checkpoints (checkpoint.py) and the GPT step with tp, the vocab-parallel
loss and ZeRO-1 (gpt_train.py).

One gloo world of 4 ranks on the CPU (`train_world` in
tests/torch_parallel_workers.py) runs every case from the JAX package's
initial params passed as numpy, and returns the losses and the gathered
params; the JAX side runs `make_train_step`, `make_optim_train_step` and
`make_gpt_train_step` over `make_mesh` of the same shape on its virtual CPU
devices, kernels off on both sides (f32 products). The ids of the cases
that were refusals before the parallel layer was ported (mlp-dp2,
optim-tp2, zero1, gpt-dp2tp2, gpt-zero1, vocab-parallel) are kept.

Tolerances: MLP steps 2e-5 (losses and params); GPT steps 1e-5 on losses,
1e-4 on params (test_torch_train.py's); gradients at tp > 1 against tp = 1
1e-4 leaf by leaf (the over-count check: a wrong dual is off by a factor
of the tp degree); ZeRO-1 against no ZeRO-1 and a checkpoint resumed on
its own mesh 1e-6, on another mesh 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import tpp_mlir_tpu.serving as J
from tpp_mlir_tpu.parallel import make_mesh
from tpp_mlir_tpu.parallel import make_optim_train_step as jax_optim_step
from tpp_mlir_tpu.parallel import make_train_step as jax_train_step
from tpp_mlir_tpu.parallel import mlp_init as jax_mlp_init
from tpp_mlir_tpu.parallel.gpt_train import \
    make_gpt_train_step as jax_gpt_step
from tpp_mlir_tpu_torch.parallel import World

LAYERS = (16, 32, 32, 16)     # three layers: the chain ends in gather_cols
GPT = dict(vocab=64, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=16,
           dtype="f32")
MLP_CASES = {"mlp-dp2": {"dp": 2, "tp": 1}, "mlp-tp2": {"dp": 1, "tp": 2},
             "mlp-dp2tp2": {"dp": 2, "tp": 2}, "mlp-tp4": {"dp": 1, "tp": 4}}
OPT_CASES = {"optim-tp2": ({"dp": 1, "tp": 2}, 1, False),
             "zero1": ({"dp": 2, "tp": 2}, 2, True),
             "zero1-dp4": ({"dp": 4, "tp": 1}, 1, True),
             "adamw-dp4": ({"dp": 4, "tp": 1}, 1, False)}
GPT_CASES = {"gpt-dp2tp2": ({"dp": 2, "tp": 2}, False, False, {}),
             "gpt-zero1": ({"dp": 2, "tp": 2}, True, False, {}),
             "vocab-parallel": ({"dp": 1, "tp": 2}, False, True, {}),
             "gpt-tp4-zero1-vocab": ({"dp": 1, "tp": 4}, True, True, {}),
             "moe-dp2": ({"dp": 2, "tp": 1}, False, False,
                         {"n_experts": 4})}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    jp = jax_mlp_init(LAYERS, seed=1)
    gp = J.stack_params(J.init_params(J.GptConfig(**GPT), seed=5))
    mp = J.stack_params(J.init_params(J.GptConfig(**GPT, n_experts=4),
                                      seed=6))
    return {"layers": LAYERS, "mlp_params": _np_tree(jp),
            "mlp_x": rng.standard_normal((16, 16)).astype(np.float32),
            "mlp_y": rng.standard_normal((16, 16)).astype(np.float32),
            "gpt_cfg": GPT, "gpt_params": _np_tree(gp),
            "moe_params": _np_tree(mp),
            "gpt_ids": rng.integers(0, GPT["vocab"], (8, 12)).astype(
                np.int32),
            "ckpt": str(tmp_path_factory.mktemp("zero1"))}


def _jax_refs(data):
    """Every case's JAX run: name -> (losses, params[, optimizer state])."""
    x, y = jnp.asarray(data["mlp_x"]), jnp.asarray(data["mlp_y"])
    refs = {}
    for name, shape in MLP_CASES.items():
        jstep = jax_train_step(make_mesh(shape), LAYERS, lr=0.05,
                               use_pallas=False)
        jp, losses = jax_mlp_init(LAYERS, seed=1), []
        for _ in range(3):
            jp, jl = jstep(jp, x, y)
            losses.append(float(jl))
        refs[name] = (losses, jp)
    for name, (shape, accum, zero1) in OPT_CASES.items():
        jstep, jinit = jax_optim_step(make_mesh(shape), LAYERS,
                                      optax.adamw(1e-2), accum_steps=accum,
                                      zero1=zero1, use_pallas=False)
        jp = jax_mlp_init(LAYERS, seed=1)
        js, losses = jinit(jp), []
        for _ in range(3):
            jp, js, jl = jstep(jp, js, x, y)
            losses.append(float(jl))
        refs[name] = (losses, jp, js)
    ids = jnp.asarray(data["gpt_ids"])
    for name, (shape, zero1, vocab, extra) in GPT_CASES.items():
        jcfg = J.GptConfig(**GPT, **extra)
        jp = J.stack_params(J.init_params(jcfg, seed=6 if extra else 5))
        jstep, jinit = jax_gpt_step(make_mesh(shape), jcfg,
                                    optax.adamw(1e-2, eps=1e-4),
                                    zero1=zero1, vocab_parallel=vocab)
        js, losses = jinit(jp), []
        for _ in range(2):
            jp, js, jl = jstep(jp, js, ids)
            losses.append(float(jl))
        refs[name] = (losses, jp)
    return refs


@pytest.fixture(scope="module")
def runs(data):
    """(each rank's results, the JAX runs): the world runs while the JAX
    side computes."""
    from torch_parallel_workers import train_world
    world = World(train_world, 4, "gloo", "cpu", (data,))
    refs = _jax_refs(data)
    return world.result(), refs


def _close(got, want, tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=tol,
                                   rtol=tol)


def _close_gpt(port, jax_stacked, tol):
    """The port's per-layer params against the JAX step's stacked ones."""
    for k, v in jax_stacked.items():
        if k == "blocks":
            for name, arr in v.items():
                got = np.stack([b[name] for b in port["blocks"]])
                _close(got, arr, tol)
        else:
            _close(port[k], v, tol)


@pytest.mark.parametrize("name", list(MLP_CASES))
def test_mlp_sgd_step_matches_jax(runs, name):
    world, refs = runs
    losses, jp = refs[name]
    got_losses, got = world[0][name]
    _close(got_losses, losses, 2e-5)
    _close(got, jp, 2e-5)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("shape", [{"tp": 2}, {"dp": 2, "tp": 2}],
                         ids=["tp2", "dp2tp2"])
def test_grads_at_tp_equal_the_one_device_grads(runs, kernels, shape):
    """The over-count check, leaf by leaf: the complete gradients of one
    step at tp > 1 (the duals of collectives.py) equal the one-device ones;
    with the kernels on, through B1's forward and transpose_b launches."""
    world = runs[0]
    one = world[0][("grads", kernels, ())]
    got = world[0][("grads", kernels, tuple(shape.items()))]
    for (gw, gb), (ow, ob) in zip(got, one):
        _close(gw, ow, 1e-4)
        _close(gb, ob, 1e-4)


@pytest.mark.parametrize("name", list(OPT_CASES))
def test_optim_step_matches_jax(runs, name):
    world, refs = runs
    zero1 = OPT_CASES[name][2]
    losses, jp, js = refs[name]
    got_losses, got = world[0][name]
    _close(got_losses, losses, 2e-5)
    _close(got, jp, 2e-5)
    if zero1:
        # each rank's moments are the JAX device's moment shards
        mu = jax.tree.leaves(js[0].mu)
        for r, out in enumerate(world):
            for (n_mom, _), m in zip(out[name + "-moments"], mu):
                assert n_mom == m.addressable_shards[0].data.size


def test_zero1_moments_are_split_over_dp(runs):
    """The point of ZeRO-1 (tests/parallel/test_optim.py:88 there): at dp 2
    x tp 2 each weight's moments hold half of its tp shard's elements."""
    for out in runs[0]:
        moments = out["zero1-moments"]
        for n_mom, n_param in moments[0::2]:        # the weights
            assert n_mom * 2 == n_param


def test_zero1_matches_the_replicated_optimizer(runs):
    """ZeRO-1 changes where the moments live, not the update: at dp 4 its
    losses and params are the replicated optimizer's."""
    world = runs[0]
    (zl, zp), (al, ap) = world[0]["zero1-dp4"], world[0]["adamw-dp4"]
    _close(zl, al, 1e-6)
    _close(zp, ap, 1e-6)


@pytest.mark.parametrize("label,tol", [("same", 1e-6), ("dp4", 1e-5)])
def test_zero1_checkpoint_resumes_on_its_mesh_and_another(runs, label,
                                                          tol):
    """Saved gathered after 2 steps at dp 2 x tp 2, restored into params and
    moments zeroed out, on the same mesh and resharded onto dp 4, then 2
    more steps: the uninterrupted 4-step run's params (tests/parallel/
    test_optim.py:123 there)."""
    world = runs[0]
    at, got = world[0]["ckpt-" + label]
    assert at == 2
    _close(got, world[0]["ckpt-uninterrupted"], tol)


@pytest.mark.parametrize("name", list(GPT_CASES))
def test_gpt_step_matches_jax(runs, name):
    world, refs = runs
    losses, jp = refs[name]
    got_losses, got = world[0][name]
    _close(got_losses, losses, 1e-5)
    _close_gpt(got, jp, 1e-4)


def test_vocab_parallel_equals_a_replicated_head(runs):
    """At tp 2 the vocab-parallel loss and its SGD step (lr 1: the params
    move by the gradients) equal the replicated head's."""
    (loss_r, rep), (loss_v, vp) = runs[0][0]["vocab-vs-replicated"]
    _close(loss_v, loss_r, 1e-5)
    _close(vp, rep, 1e-5)
