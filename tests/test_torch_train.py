"""The training slice against the JAX package, on the CPU.

The port's trainable ops (tpp_mlir_tpu_torch.ops.trainable), the MLP SGD and
optimizer steps and the GPT step (tpp_mlir_tpu_torch.parallel) against the
JAX ones on a 1x1 mesh, from the same numpy params and batches. The JAX side
runs its Pallas kernels in interpret mode (exact f32), so the port's GEMM
kernels run at precision "highest" here: at "default" they round f32
operands to bf16, as the compiled TPU kernels do (ROADMAP queue C).

Tolerances: trainable ops 1e-5 (f32, sum order only); MLP steps 2e-5 on
losses and params; GPT steps 1e-5 on losses and 1e-4 on params and SGD
grads (sum-order differences through two f32 layers and the LM head, and
Adam's normalization of small gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P
from tpp_mlir_tpu.ops import trainable as jax_trainable
from tpp_mlir_tpu.parallel import make_mesh
from tpp_mlir_tpu.parallel import make_optim_train_step as jax_optim_step
from tpp_mlir_tpu.parallel import make_train_step as jax_train_step
from tpp_mlir_tpu.parallel import mlp_init as jax_mlp_init
from tpp_mlir_tpu.parallel.gpt_train import _gpt_forward_local
from tpp_mlir_tpu.parallel.gpt_train import \
    make_gpt_train_step as jax_gpt_step
from tpp_mlir_tpu.parallel.gpt_train import \
    next_token_loss as jax_next_token_loss
from tpp_mlir_tpu_torch.ops import trainable
from tpp_mlir_tpu_torch.parallel import (adamw, make_gpt_train_step,
                                         make_optim_train_step,
                                         make_train_step, mlp_init,
                                         mlp_params_from_numpy,
                                         next_token_loss, sgd)

MESH = {"dp": 1, "tp": 1}


def _np(x):
    return np.array(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got.detach()) if isinstance(
        got, torch.Tensor) else _np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# trainable ops

@pytest.mark.parametrize("op", ["mlp_layer", "matmul"])
def test_trainable_op_and_vjp_match_jax(op):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 64)) / 7).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal((32, 64)).astype(np.float32)
    args = (x, w, b) if op == "mlp_layer" else (x, w)
    want, vjp = jax.vjp(getattr(jax_trainable, op), *map(jnp.asarray, args))
    tw = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = getattr(trainable, op)(*tw, precision="highest")
    got.backward(torch.from_numpy(g))
    _close(got, want, 1e-5)
    for t, d in zip(tw, vjp(jnp.asarray(g))):
        _close(t.grad, d, 1e-5)


def test_trainable_default_precision_rounds_operands_to_bf16():
    # f32 "default" is the compiled TPU meaning: the JAX kernel (exact f32
    # in interpret mode) on operands rounded to bf16 gives the same forward
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 64)) / 7).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    r = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32))
    want = jax_trainable.mlp_layer(jnp.asarray(r(x)), jnp.asarray(r(w)),
                                   jnp.asarray(b))
    got = trainable.mlp_layer(*map(torch.from_numpy, (x, w, b)))
    _close(got, want, 1e-5)


def test_f32_matmul_gradients_are_the_f32_products():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    trainable.f32_matmul(x, w).sum().backward()
    torch.testing.assert_close(x.grad, w.sum(1).expand(2, 5, 8))
    torch.testing.assert_close(w.grad, x.detach().sum((0, 1))[:, None]
                               .expand(8, 3))


# ---------------------------------------------------------------------------
# the MLP steps

LAYERS = (32, 64, 64, 32)


def _mlp_data(seed=0, batch=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, LAYERS[0])).astype(np.float32),
            rng.standard_normal((batch, LAYERS[-1])).astype(np.float32))


def _port_mlp(jparams):
    return mlp_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_mlp_sgd_step_matches_jax(kernels):
    x, y = _mlp_data()
    jp = jax_mlp_init(LAYERS, seed=1)
    jstep = jax_train_step(make_mesh(MESH), LAYERS, lr=0.05,
                           use_pallas=kernels)
    pp = _port_mlp(jp)
    step = make_train_step(LAYERS, lr=0.05, use_kernels=kernels,
                           device="cpu", precision="highest")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        jp, jl = jstep(jp, jnp.asarray(x), jnp.asarray(y))
        pp, pl = step(pp, tx, ty)
        _close(pl, jl, 2e-5)
    for (pw, pb), (jw, jb) in zip(pp, jp):
        _close(pw, jw, 2e-5)
        _close(pb, jb, 2e-5)


def test_mlp_optim_step_with_accumulation_matches_jax():
    x, y = _mlp_data(seed=3)
    jp = jax_mlp_init(LAYERS, seed=4)
    jstep, jinit = jax_optim_step(make_mesh(MESH), LAYERS,
                                  optax.adamw(1e-2), accum_steps=2,
                                  use_pallas=True)
    pp = _port_mlp(jp)
    step, init = make_optim_train_step(LAYERS, adamw(1e-2), accum_steps=2,
                                       use_kernels=True, device="cpu",
                                       precision="highest")
    js, ps = jinit(jp), init(pp)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(x), jnp.asarray(y))
        pp, ps, pl = step(pp, ps, tx, ty)
        _close(pl, jl, 2e-5)
    for (pw, pb), (jw, jb) in zip(pp, jp):
        _close(pw, jw, 2e-5)
        _close(pb, jb, 2e-5)


def test_mlp_init_is_he_scaled_on_the_device_asked_for():
    params = mlp_init((256, 128, 64), seed=0, device="cpu")
    (w0, b0), (w1, _) = params
    assert w0.shape == (256, 128) and w1.shape == (128, 64)
    assert abs(w0.std().item() - (2 / 256) ** 0.5) < 0.01
    assert not b0.any() and w0.device.type == "cpu"
    bf = mlp_init((16, 16), dtype="bfloat16", device="cpu")
    assert bf[0][0].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the GPT step

CFG = dict(vocab=64, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=16,
           dtype="f32")


def _gpt_setup(seed, **kw):
    jcfg, pcfg = J.GptConfig(**CFG, **kw), P.GptConfig(**CFG, **kw)
    jp = J.stack_params(J.init_params(jcfg, seed=seed))
    ids = np.random.default_rng(seed).integers(0, CFG["vocab"], (8, 12)
                                               ).astype(np.int32)
    return jcfg, pcfg, jp, ids


def _port_params(jp, pcfg):
    return P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                               device="cpu")


def _close_params(port, jax_stacked, tol):
    """The port's per-layer params against the JAX step's stacked ones."""
    for k, v in jax_stacked.items():
        if k == "blocks":
            for name, arr in v.items():
                got = torch.stack([b[name] for b in port["blocks"]])
                _close(got, arr, tol)
        else:
            _close(port[k], v, tol)


def _jax_grads(jcfg, jp, ids, flash):
    """(loss, grads) of the JAX step's own forward and loss on a 1x1 mesh."""
    def local(p, ids):
        def loss_fn(p):
            return jax_next_token_loss(_gpt_forward_local(
                p, ids, jcfg, "tp", jcfg.heads, jcfg.kv_h,
                flash_attn=flash), ids)
        return jax.value_and_grad(loss_fn)(p)
    return jax.shard_map(local, mesh=make_mesh(MESH), in_specs=(PS(), PS()),
                         out_specs=(PS(), PS()), check_vma=False)(
        jp, jnp.asarray(ids))


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "composed"])
def test_gpt_sgd_grads_match_jax_leaf_by_leaf(flash):
    jcfg, pcfg, jp, ids = _gpt_setup(5)
    pp = _port_params(jp, pcfg)
    step, init = make_gpt_train_step(pcfg, sgd(0.1), flash_attn=flash,
                                     device="cpu")
    state = init(pp)
    _, _, loss = step(pp, state, torch.from_numpy(ids))
    jl, jg = _jax_grads(jcfg, jp, ids, flash)
    _close(loss, jl, 1e-5)
    grads = {k: v.grad for k, v in pp.items() if k != "blocks"}
    grads["blocks"] = [{k: v.grad for k, v in b.items()}
                       for b in pp["blocks"]]
    _close_params(grads, jg, 1e-4)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "composed"])
def test_gpt_three_steps_match_jax(flash, opt):
    jcfg, pcfg, jp, ids = _gpt_setup(6)
    # adamw at eps 1e-4: bk's true gradient is 0 and Adam at eps 1e-8 would
    # normalize float noise into O(lr) steps (tests/parallel/
    # test_gpt_train.py:28-33)
    jopt, popt = {"sgd": (optax.sgd(0.1), sgd(0.1)),
                  "adamw": (optax.adamw(1e-2, eps=1e-4),
                            adamw(1e-2, eps=1e-4))}[opt]
    jstep, jinit = jax_gpt_step(make_mesh(MESH), jcfg, jopt,
                                flash_attn=flash)
    pp = _port_params(jp, pcfg)
    step, init = make_gpt_train_step(pcfg, popt, flash_attn=flash,
                                     device="cpu")
    js, ps = jinit(jp), init(pp)
    losses = []
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(ids))
        pp, ps, pl = step(pp, ps, torch.from_numpy(ids))
        _close(pl, jl, 1e-5)
        losses.append(float(pl))
    _close_params(pp, jp, 1e-4)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "composed"])
def test_gpt_gqa_step_matches_jax(flash):
    jcfg, pcfg, jp, ids = _gpt_setup(7, kv_heads=2)
    jstep, jinit = jax_gpt_step(make_mesh(MESH), jcfg, optax.sgd(0.1),
                                flash_attn=flash)
    pp = _port_params(jp, pcfg)
    step, init = make_gpt_train_step(pcfg, sgd(0.1), flash_attn=flash,
                                     device="cpu")
    js, ps = jinit(jp), init(pp)
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(ids))
        pp, ps, pl = step(pp, ps, torch.from_numpy(ids))
        _close(pl, jl, 1e-5)
    _close_params(pp, jp, 1e-4)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "composed"])
def test_gpt_step0_loss_is_the_prefill_ce(flash):
    _, pcfg, jp, ids = _gpt_setup(8)
    pp = _port_params(jp, pcfg)
    tids = torch.from_numpy(ids)
    logits, _ = P.make_prefill(pcfg)(pp, tids)
    want = next_token_loss(logits, tids).item()
    step, init = make_gpt_train_step(pcfg, sgd(0.1), flash_attn=flash,
                                     device="cpu")
    _, _, loss = step(pp, init(pp), tids)
    assert abs(loss.item() - want) <= 1e-5 * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# refusals and device defaults

def _gpt_step(**kw):
    return make_gpt_train_step(P.GptConfig(**CFG), sgd(0.1), device="cpu",
                               **kw)


@pytest.mark.parametrize("build,item", [
    (lambda: make_train_step(LAYERS, device="cpu",
                             mesh={"dp": 2, "tp": 1}), "A11"),
    (lambda: make_optim_train_step(LAYERS, sgd(0.1), device="cpu",
                                   mesh={"dp": 1, "tp": 2}), "A11"),
    (lambda: make_optim_train_step(LAYERS, sgd(0.1), device="cpu",
                                   zero1=True), "A11"),
    (lambda: _gpt_step(mesh={"dp": 2, "tp": 2}), "A11"),
    (lambda: _gpt_step(zero1=True), "A11"),
    (lambda: _gpt_step(vocab_parallel=True), "A11"),
    (lambda: P.GptConfig(**CFG, n_experts=4), "A9"),
    (lambda: make_gpt_train_step(P.GptConfig.llama(**CFG), sgd(0.1),
                                 device="cpu"), "queue C"),
], ids=["mlp-dp2", "optim-tp2", "zero1", "gpt-dp2tp2", "gpt-zero1",
        "vocab-parallel", "moe", "llama"])
def test_refusals_name_their_roadmap_item(build, item):
    with pytest.raises(NotImplementedError, match=item):
        build()


def test_a_one_device_mesh_is_accepted():
    make_train_step(LAYERS, device="cpu", mesh={"dp": 1, "tp": 1})
    _gpt_step(mesh={"dp": 1, "tp": 1})


def _entry_points():
    from tpp_mlir_tpu_torch.ir import parse_module
    from tpp_mlir_tpu_torch.models.mlp import MlpConfig
    from tpp_mlir_tpu_torch.runtime import compile as port_compile
    from tpp_mlir_tpu_torch.runtime.params import module_params
    from tpp_mlir_tpu_torch.tools.mlir_gen import generate_text
    from tpp_mlir_tpu_torch.tools.tpp_run import init_args
    cfg = P.GptConfig(**CFG)
    module = parse_module(generate_text(MlpConfig(batch=4, layers=(8, 8))))
    tree = jax.tree.map(np.asarray, J.init_params(J.GptConfig(**CFG)))
    return {
        "init_params": lambda: P.init_params(cfg),
        "params_from_numpy": lambda: P.params_from_numpy(tree, cfg),
        "params_from_torch": lambda: P.params_from_torch(None, cfg),
        "executor.compile": lambda: port_compile(module),
        "runtime.params": lambda: module_params(module),
        "tpp_run.init_args": lambda: init_args(module, "entry", "normal", 0),
        "mlp_init": lambda: mlp_init(LAYERS),
        "mlp_params_from_numpy": lambda: mlp_params_from_numpy(()),
        "make_train_step": lambda: make_train_step(LAYERS),
        "make_optim_train_step": lambda: make_optim_train_step(LAYERS,
                                                               sgd(0.1)),
        "make_gpt_train_step": lambda: make_gpt_train_step(cfg, sgd(0.1)),
    }


@pytest.mark.parametrize("name", [
    "init_params", "params_from_numpy", "params_from_torch",
    "executor.compile", "runtime.params", "tpp_run.init_args", "mlp_init",
    "mlp_params_from_numpy", "make_train_step", "make_optim_train_step",
    "make_gpt_train_step"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Each entry point defaults to device "cuda" and raises without a card;
    the CPU runs only when the caller names it."""
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        call()
