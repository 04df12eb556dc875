"""The MoE model through the port's entry points against the JAX package,
on the CPU: serving (`make_prefill` in each prefill form, teacher-forced
decode in each decode form, `make_extend`, `make_generate`), training
(`make_gpt_train_step` in the scan and the grouped form), the quantizer
and `tools/tpp_serve.py`.

Both engines run the JAX `init_params` weights (carried into the port by
`params_from_numpy`, expert tables included) on the same numpy prompts.
Tolerances: f32 1e-4 (abs and rel), where only sum orders differ; the f32
grouped form at DEFAULT_TOL of max|JAX| (its kernels' f32 "default" rounds
the expert GEMMs' operands to bf16 where JAX's interpret mode keeps f32;
held at 1e-4 at "highest" through the training step); bf16 3e-2 of
max|JAX|, the serving tests' bf16 tolerance. Training: losses 1e-5,
params 1e-4, as tests/test_torch_train.py holds the dense step.
"""

import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P
from tpp_mlir_tpu.parallel import make_mesh
from tpp_mlir_tpu.parallel.gpt_train import \
    make_gpt_train_step as jax_gpt_step
from tpp_mlir_tpu_torch.parallel import make_gpt_train_step, sgd

BASE = dict(vocab=67, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=32,
            n_experts=4, top_k=2)
B, S0, T = 2, 16, 4
DEFAULT_TOL = 1e-2

# name -> (GptConfig fields beyond BASE, weight seed). grouped-bf16 takes
# seed 4: with seed 3 one token of 32 sits at a near-tie of its layer-2
# router, and the 1-ulp bf16 difference that two f32 sum orders leave in
# layer 1's grouped FFN output flips its experts (0.164 of max|logits| at
# that token, <= 0.007 elsewhere), which a logits comparison cannot tell
# from a fault.
CASES = {
    "scan-f32": (dict(dtype="f32"), 3),
    "sorted-f32": (dict(dtype="f32", moe_prefill_form="sorted"), 3),
    "grouped-f32": (dict(dtype="f32", moe_prefill_form="grouped",
                         moe_group_bm=8), 3),
    "scan-bf16": (dict(dtype="bf16"), 3),
    "sorted-bf16": (dict(dtype="bf16", moe_prefill_form="sorted"), 3),
    "grouped-bf16": (dict(dtype="bf16", moe_prefill_form="grouped",
                          moe_group_bm=16), 4),
}


class Case:
    def __init__(self, name):
        fields, seed = CASES[name]
        kw = dict(BASE, **fields)
        self.name = name
        self.bf16, self.grouped = kw["dtype"] == "bf16", "grouped" in name
        self.jcfg, self.pcfg = J.GptConfig(**kw), P.GptConfig(**kw)
        self.jp = J.init_params(self.jcfg, seed=seed)
        self.pp = P.params_from_numpy(jax.tree.map(np.asarray, self.jp),
                                      self.pcfg, device="cpu")
        self.ids = np.random.default_rng(3).integers(
            0, BASE["vocab"], (B, S0 + T)).astype(np.int32)

    def close(self, got, want, what):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if self.bf16 or self.grouped:
            rel = np.abs(got - want).max() / np.abs(want).max()
            tol = 3e-2 if self.bf16 else DEFAULT_TOL
            assert rel <= tol, f"{self.name} {what}: rel {rel}"
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                       err_msg=f"{self.name} {what}")


@functools.lru_cache(maxsize=None)
def case(name):
    return Case(name)


def test_params_carry_the_expert_tables():
    c = case("scan-f32")
    blk = c.pp["blocks"][1]
    assert blk["w1"].shape == (4, 32, 64) and blk["w2"].shape == (4, 64, 32)
    assert blk["wr"].shape == (32, 4) and "b1" not in blk
    stacked = P.params_from_numpy(
        jax.tree.map(np.asarray, J.stack_params(c.jp)), c.pcfg, device="cpu")
    # stack_params splits a stacked (L, ...) tree by layer, 3-D tables too
    split = P.stack_params(dict(c.pp, blocks={
        k: torch.stack([b[k] for b in c.pp["blocks"]]) for k in blk}))
    for k in ("wr", "w1", "w2"):
        assert torch.equal(stacked["blocks"][1][k], blk[k])
        assert torch.equal(split["blocks"][1][k], blk[k])
        assert np.array_equal(blk[k].numpy(),
                              np.asarray(c.jp["blocks"][1][k]))
    own = P.init_params(c.pcfg, seed=0, device="cpu")["blocks"][0]
    assert {k: tuple(v.shape) for k, v in own.items() if k[0] == "w"} == {
        k: tuple(v.shape) for k, v in c.jp["blocks"][0].items() if k[0] == "w"}


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_form_matches_jax(name):
    c = case(name)
    ids = c.ids[:, :S0]
    jl, jc = J.make_prefill(c.jcfg, use_pallas=False)(c.jp, jnp.asarray(ids))
    pl, pc = P.make_prefill(c.pcfg)(c.pp, torch.from_numpy(ids))
    c.close(pl, jl, "prefill logits")
    assert int(pc["pos"]) == S0


@pytest.mark.parametrize("form", ["gather", "scan", "slice"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_form_teacher_forced_matches_jax(form, dtype):
    c = case(f"scan-{dtype}")
    jcfg = dataclasses.replace(c.jcfg, moe_decode_form=form)
    pcfg = dataclasses.replace(c.pcfg, moe_decode_form=form)
    rows = 1 if form == "slice" else B
    ids = c.ids[:rows]
    _, jc = J.make_prefill(jcfg, use_pallas=False)(c.jp,
                                                    jnp.asarray(ids[:, :S0]))
    _, pc = P.make_prefill(pcfg)(c.pp, torch.from_numpy(ids[:, :S0]))
    jstep, pstep = J.make_decode_step(jcfg), P.make_decode_step(pcfg)
    for t in range(S0, S0 + T):
        jl, jc = jstep(c.jp, jc, jnp.asarray(ids[:, t]))
        pl, pc = pstep(c.pp, pc, torch.from_numpy(ids[:, t]))
        c.close(pl, jl, f"{form} decode at {t}")


@pytest.mark.parametrize("name", ["scan-f32", "sorted-f32", "grouped-f32",
                                  "grouped-bf16"])
def test_extend_matches_jax(name):
    c = case(name)
    jp_, pp_ = J.make_prefill(c.jcfg, use_pallas=False), \
        P.make_prefill(c.pcfg)
    _, jc = jp_(c.jp, jnp.asarray(c.ids[:, :S0 - T]))
    _, pc = pp_(c.pp, torch.from_numpy(c.ids[:, :S0 - T]))
    chunk = c.ids[:, S0 - T:S0]
    jl, _ = J.make_extend(c.jcfg)(c.jp, jc, jnp.asarray(chunk))
    pl, _ = P.make_extend(c.pcfg)(c.pp, pc, torch.from_numpy(chunk))
    c.close(pl, jl, "extend logits")


@pytest.mark.parametrize("name", ["scan-f32", "sorted-f32"])
def test_generate_greedy_tokens_equal_jax(name):
    c = case(name)
    prompt = c.ids[:, :S0]
    want = J.make_generate(c.jcfg, T, use_pallas=False)(
        c.jp, jnp.asarray(prompt), jax.random.PRNGKey(0))
    got = P.make_generate(c.pcfg, T)(c.pp, torch.from_numpy(prompt))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_moe_group_stacked_changes_nothing():
    """The per-layer list's expert tables are views already: True and
    False give bit-identical prefill logits."""
    c = case("grouped-f32")
    ids = torch.from_numpy(c.ids[:, :S0])
    got = [P.make_prefill(dataclasses.replace(c.pcfg, moe_group_stacked=s))(
        c.pp, ids)[0] for s in (True, False)]
    assert torch.equal(got[0], got[1])


# ---------------------------------------------------------------------------
# training

TRAIN = dict(BASE, max_seq=16)


def _train_setup(seed, **kw):
    jcfg, pcfg = J.GptConfig(**TRAIN, **kw), P.GptConfig(**TRAIN, **kw)
    jp = J.stack_params(J.init_params(jcfg, seed=seed))
    ids = np.random.default_rng(seed).integers(0, TRAIN["vocab"], (4, 12)
                                               ).astype(np.int32)
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                             device="cpu")
    return jcfg, pcfg, jp, pp, ids


def _close_params(port, jax_stacked, tol):
    """The port's per-layer params against JAX's stacked ones, leaf by leaf
    (abs and rel tol: bk's true gradient is 0, so it holds noise only)."""
    for k, v in jax_stacked.items():
        pairs = ([(f"blocks.{n}", torch.stack([b[n] for b in port["blocks"]]),
                   a) for n, a in v.items()] if k == "blocks"
                 else [(k, port[k], v)])
        for name, got, want in pairs:
            np.testing.assert_allclose(got.detach().float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=tol, rtol=tol, err_msg=name)


def test_scan_form_step_matches_jax_step():
    """The scan form is the JAX step's own: 3 SGD steps on a 1x1 mesh."""
    jcfg, pcfg, jp, pp, ids = _train_setup(4, dtype="f32")
    jstep, jinit = jax_gpt_step(make_mesh({"dp": 1, "tp": 1}), jcfg,
                                optax.sgd(0.1), flash_attn=False)
    step, init = make_gpt_train_step(pcfg, sgd(0.1), flash_attn=False,
                                     device="cpu")
    js, ps = jinit(jp), init(pp)
    losses = []
    for _ in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(ids))
        pp, ps, pl = step(pp, ps, torch.from_numpy(ids))
        np.testing.assert_allclose(float(pl), float(jl), atol=1e-5,
                                   rtol=1e-5)
        losses.append(float(pl))
    _close_params(pp, jp, 1e-4)
    assert losses[-1] < losses[0]


def _jax_grouped_sgd(jcfg, jp, ids, lr, steps):
    """JAX's grouped training: jax.grad of the CE through make_prefill with
    the grouped form (test_moe_forms.py:209-240), then p - lr * g."""
    prefill = J.make_prefill(jcfg, use_pallas=False)

    def loss(params):
        logits, _ = prefill(params, ids)
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(lp, ids[:, 1:, None], axis=-1))

    losses = []
    for _ in range(steps):
        val, g = jax.value_and_grad(loss)(jp)
        jp = jax.tree.map(lambda p, d: p - lr * d, jp, g)
        losses.append(float(val))
    return jp, losses


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_grouped_form_step_matches_jax_grouped_training(precision):
    kw = dict(dtype="f32", moe_prefill_form="grouped", moe_group_bm=8,
              moe_group_stacked=False)
    jcfg, pcfg, jp, pp, ids = _train_setup(5, **kw)
    jp, jlosses = _jax_grouped_sgd(jcfg, jp, jnp.asarray(ids), 0.1, 2)
    step, init = make_gpt_train_step(pcfg, sgd(0.1), flash_attn=False,
                                     device="cpu", precision=precision)
    state = init(pp)
    plosses = [float(step(pp, state, torch.from_numpy(ids))[2])
               for _ in range(2)]
    if precision == "highest":
        np.testing.assert_allclose(plosses, jlosses, atol=1e-5, rtol=1e-5)
        _close_params(pp, jp, 1e-4)
    else:      # bf16-rounded expert GEMM operands: see DEFAULT_TOL
        np.testing.assert_allclose(plosses, jlosses, rtol=DEFAULT_TOL)
        _close_params(pp, jp, DEFAULT_TOL)


def test_moe_step_refuses_a_mesh():
    """MoE under tp > 1 is refused in the JAX step's words (gpt_train.py:
    188-190 there); dp meshes train (tests/test_torch_parallel_train.py
    moe-dp2)."""
    with pytest.raises(NotImplementedError, match="not tp -- use a dp-only"):
        make_gpt_train_step(P.GptConfig(**TRAIN), sgd(0.1), device="cpu",
                            mesh={"dp": 1, "tp": 2})


# ---------------------------------------------------------------------------
# quantization and tpp_serve (tests/serving/test_moe.py:114 and :137)

def test_quantize_skips_experts_keeps_attention():
    cfg = P.GptConfig(**BASE, dtype="f32")
    q = P.quantize_params(P.init_params(cfg, seed=6, device="cpu"))
    blk = q["blocks"][0]
    assert isinstance(blk["wq"], P.QTensor) and isinstance(q["lm_head"],
                                                           P.QTensor)
    for k in ("w1", "w2", "wr"):
        assert not isinstance(blk[k], P.QTensor), k
    for form in ("scan", "grouped"):      # quantized attention, raw experts
        fcfg = dataclasses.replace(cfg, moe_prefill_form=form,
                                   moe_group_bm=8)
        out = P.make_generate(fcfg, 3)(q, torch.tensor([[1, 2, 3]],
                                                       dtype=torch.int32))
        assert out.shape == (1, 3)


def test_tpp_serve_moe_cli_matches_the_jax_engine():
    from tpp_mlir_tpu_torch.tools import tpp_serve
    argv = ["--embed", "32", "--heads", "4", "--layers", "2", "--mlp-ratio",
            "2", "--vocab", "97", "--max-seq", "32", "--prompt-len", "6",
            "--steps", "4", "--experts", "4", "--top-k-experts", "1",
            "--dtype", "f32"]
    out = io.StringIO()
    assert tpp_serve.main(argv + ["--device", "cpu"], out=out) == 0
    assert len(out.getvalue().strip().splitlines()[-1].split()) == 4
    # the same command's configuration on the JAX engine's weights
    args = tpp_serve.build_parser().parse_args(argv + ["--moe-prefill",
                                                       "sorted"])
    kw = dict(vocab=97, embed=32, heads=4, layers=2, mlp_ratio=2,
              max_seq=32, dtype="f32", n_experts=args.experts,
              top_k=args.top_k_experts, moe_prefill_form=args.moe_prefill)
    jcfg, pcfg = J.GptConfig(**kw), P.GptConfig(**kw)
    jp = J.init_params(jcfg, seed=args.seed)
    ids = np.random.default_rng(args.seed).integers(0, 97, (1, 6))
    want = J.make_generate(jcfg, args.steps)(
        J.stack_params(jp), jnp.asarray(ids, jnp.int32),
        jax.random.PRNGKey(0))
    res = tpp_serve.serve(pcfg, P.params_from_numpy(
        jax.tree.map(np.asarray, jp), pcfg, device="cpu"),
        torch.from_numpy(ids.astype(np.int32)), args.steps)
    assert np.array_equal(res["tokens"].numpy(), np.asarray(want))
