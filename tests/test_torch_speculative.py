"""Speculative decoding in the port (`tpp_mlir_tpu_torch.serving.
speculative`) against the JAX package's, on carried weights.

Mirrors tests/serving/test_speculative.py at its sizes, in f32 on the CPU.
Every variant (an unrelated draft, the target as its own draft, an int8
draft, a long horizon, a truncated draft vocab, tied-trunk drafts, trunk +
truncated vocab) runs both packages on the same weights (JAX `init_params`
through `params_from_numpy`): the tokens equal the JAX speculative output
and the port's own greedy `make_generate`, and the `stats` (rounds,
drafted, accepted) equal JAX's exactly. The trunk draft's cache is a copy
with its own position: were its `pos` the target's, the draft's k + 1
steps a round would advance the target's frontier, and the tokens and
stats would leave JAX's.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P

TARGET = dict(vocab=96, embed=64, heads=4, layers=3, mlp_ratio=4,
              max_seq=48, dtype="f32")
DRAFT = dict(vocab=96, embed=32, heads=2, layers=1, mlp_ratio=2,
             max_seq=48, dtype="f32")
LONG = dict(vocab=96, embed=64, heads=4, layers=2, mlp_ratio=2, max_seq=96,
            dtype="f32")
STEPS = 10


def _carry(kw, seed, quant=False, stacked=False):
    """(JAX cfg, JAX params, port cfg, port params)."""
    jcfg, pcfg = J.GptConfig(**kw), P.GptConfig(**kw)
    jp = J.init_params(jcfg, seed=seed)
    if quant:
        jp = J.quantize_params(jp)
    if stacked:
        jp = J.stack_params(jp)
    return jcfg, jp, pcfg, P.params_from_numpy(
        jax.tree.map(np.asarray, jp), pcfg, device="cpu")


def _prompt(seed, t=6):
    return np.random.default_rng(seed).integers(0, 96, (1, t)).astype(
        np.int32)


# name -> (target (config, seed, stacked), draft (config, seed, int8) or
# "self" (the target's own params) or None (trunk), steps, k, draft_vocab,
# trunk_layers, prompt seed; acceptance 100% expected)
VARIANTS = {
    "unrelated_draft": ((TARGET, 0, False), (DRAFT, 99, False), STEPS, 3, 0,
                        0, 0, False),
    "self_draft": ((TARGET, 1, False), "self", STEPS, 4, 0, 0, 1, True),
    "int8_draft": ((TARGET, 2, False), (DRAFT, 3, True), STEPS, 3, 0, 0, 2,
                   False),
    "self_draft_long_horizon": ((LONG, 4, False), "self", 60, 4, 0, 0, 4,
                                True),
    "draft_vocab_16": ((TARGET, 5, False), (DRAFT, 6, False), STEPS, 3, 16,
                       0, 5, False),
    "draft_vocab_full": ((TARGET, 5, False), (DRAFT, 6, False), STEPS, 3, 96,
                         0, 5, False),
    "self_draft_full_vocab": ((TARGET, 1, False), "self", STEPS, 4, 96, 0, 1,
                              True),
    "trunk_1": ((TARGET, 7, True), None, STEPS, 3, 0, 1, 7, False),
    "trunk_2": ((TARGET, 7, True), None, STEPS, 3, 0, 2, 7, False),
    "trunk_full": ((TARGET, 8, True), None, STEPS, 4, 0, 3, 8, True),
    "trunk_2_vocab_32": ((TARGET, 9, True), None, STEPS, 3, 32, 2, 9,
                         False),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_speculative_matches_jax_and_target_greedy(name):
    (tkw, tseed, stacked), draft, steps, k, dv, trunk, pseed, full = \
        VARIANTS[name]
    jcfg, jp, pcfg, pp = _carry(tkw, tseed, stacked=stacked)
    ids = _prompt(pseed)
    kw = dict(k=k, draft_vocab=dv, trunk_layers=trunk)
    if draft is None:
        want, jstats = J.make_speculative_generate(
            jcfg, None, steps, use_pallas=False, **kw)(jp, jnp.asarray(ids))
        got, stats = P.make_speculative_generate(pcfg, None, steps, **kw)(
            pp, torch.from_numpy(ids))
    else:
        if draft == "self":
            jdcfg, jd, pdcfg, pd = jcfg, jp, pcfg, pp
        else:
            dkw, dseed, quant = draft
            jdcfg, jd, pdcfg, pd = _carry(dkw, dseed, quant, stacked=quant)
        want, jstats = J.make_speculative_generate(
            jcfg, jdcfg, steps, use_pallas=False, **kw)(jp, jd,
                                                        jnp.asarray(ids))
        got, stats = P.make_speculative_generate(pcfg, pdcfg, steps, **kw)(
            pp, pd, torch.from_numpy(ids))
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, steps)
    assert np.array_equal(got.numpy(), np.asarray(want))
    greedy = P.make_generate(pcfg, steps)(pp, torch.from_numpy(ids))
    assert torch.equal(got, greedy)
    assert {n: int(v) for n, v in stats.items()} == \
        {n: int(v) for n, v in jstats.items()}
    assert int(stats["accepted"]) <= int(stats["drafted"])
    if full:
        assert int(stats["accepted"]) == int(stats["drafted"])


def test_speculative_prompt_budget_guard():
    """s0 + steps + k + 1 must fit max_seq (the verify pass writes k + 1
    rows past the frontier)."""
    _, _, pcfg, pp = _carry(TARGET, 4)
    _, _, dcfg, dp = _carry(DRAFT, 5)
    gen = P.make_speculative_generate(pcfg, dcfg, steps=40, k=4)
    with pytest.raises(ValueError, match="max_seq"):
        gen(pp, dp, torch.from_numpy(_prompt(4, t=8)))
    with pytest.raises(ValueError, match="B=1"):
        gen(pp, dp, torch.zeros(2, 2, dtype=torch.int32))


def test_speculative_refusals():
    pcfg = P.GptConfig(**TARGET)
    for bad in (dict(draft_cfg=pcfg, trunk_layers=1),
                dict(draft_cfg=None, trunk_layers=4),
                dict(draft_cfg=P.GptConfig(**dict(DRAFT, vocab=95))),
                dict(draft_cfg=P.GptConfig(**dict(DRAFT, max_seq=40))),
                dict(draft_cfg=pcfg, draft_vocab=97)):
        with pytest.raises(ValueError):
            P.make_speculative_generate(pcfg, steps=4, **bad)
    _, _, qcfg, qp = _carry(DRAFT, 3, quant=True)
    gen = P.make_speculative_generate(pcfg, qcfg, 4, draft_vocab=16)
    with pytest.raises(NotImplementedError, match="unquantized"):
        gen(_carry(TARGET, 0)[3], qp, torch.from_numpy(_prompt(0)))


def test_trunk_draft_keeps_its_own_position(monkeypatch):
    """The trunk draft steps its own copy of the target's first layers and
    its own position: each verify pass starts at the frontier the last
    round left, not k + 1 rows further on."""
    import tpp_mlir_tpu_torch.serving.speculative as S
    _, _, pcfg, pp = _carry(TARGET, 7, stacked=True)
    seen = []
    extend = S.make_extend

    def spy(cfg, use_kernels=None):
        fn = extend(cfg, use_kernels)

        def verify(params, cache, tokens):
            seen.append(int(cache["pos"]))
            return fn(params, cache, tokens)
        return verify
    monkeypatch.setattr(S, "make_extend", spy)
    _, stats = S.make_speculative_generate(pcfg, None, STEPS, k=3,
                                           trunk_layers=1)(
        pp, torch.from_numpy(_prompt(7)))
    # 6 (the prompt), then 6 + the tokens each round emitted
    assert seen[0] == 6 and all(b > a for a, b in zip(seen, seen[1:]))
    assert len(seen) == int(stats["macro_steps"])


# -- tools/tpp_serve --speculative -------------------------------------------

SERVE = ["--embed", "32", "--heads", "4", "--layers", "2", "--mlp-ratio",
         "2", "--vocab", "97", "--max-seq", "32", "--prompt-len", "6",
         "--steps", "8", "--batch", "1", "--dtype", "f32", "--device", "cpu",
         "--speculative", "3"]


@pytest.mark.parametrize("flags", [
    [], ["--trunk-draft", "1"], ["--trunk-draft", "2", "--draft-vocab", "32"],
    ["--draft-layers", "1", "--draft-vocab", "16"]])
def test_tpp_serve_speculative_cli(flags):
    """--speculative on the CPU prints the rounds and the acceptance, and
    the tokens of the target's greedy decode on the tool's weights."""
    from tpp_mlir_tpu_torch.tools import tpp_serve
    out = io.StringIO()
    assert tpp_serve.main(SERVE + flags, out=out) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("# speculative K=3: 8 tokens in ")
    assert "acceptance" in lines[0]
    cfg, params, ids = tpp_serve.setup(dict(
        vocab=97, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=32,
        dtype="f32", batch=1, prompt=6), "cpu")
    want = P.make_generate(cfg, 8)(params, ids)
    assert [list(map(int, lines[1].split()))] == want.tolist()


@pytest.mark.parametrize("flags", [
    ["--batch", "2"], ["--steps", "24"]])
def test_tpp_serve_speculative_refusals(flags):
    """Batch 1 only; the speculative slack (k + 1 rows) counts in the
    max_seq check: 6 + 24 fits 32, 6 + 24 + 4 does not."""
    from tpp_mlir_tpu_torch.tools import tpp_serve
    assert tpp_serve.main(SERVE + flags, out=io.StringIO()) == 2
