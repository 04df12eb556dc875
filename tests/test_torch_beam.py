"""Beam search in the port (`tpp_mlir_tpu_torch.serving.beam`) against the
JAX package's (`tpp_mlir_tpu.serving.beam`), on carried weights.

Mirrors tests/serving/test_beam.py at its sizes, in f32 on the CPU: beam 1
equals greedy decode, the reported score is the true teacher-forced
log-probability, W = V with 2 steps is the brute-force optimum, EOS freezes
a beam, the length penalty rescales without reordering. Every case also
runs the JAX beam search on the same weights (JAX `init_params` through
`params_from_numpy`): the tokens equal, the scores within 1e-4.
"""

import functools
import io
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P
from tpp_mlir_tpu.serving.beam import make_beam_generate as j_beam

BASE = dict(vocab=23, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=24,
            dtype="f32")


@functools.lru_cache(maxsize=None)
def model(vocab=23, max_seq=24, seed=0):
    kw = dict(BASE, vocab=vocab, max_seq=max_seq)
    jcfg, pcfg = J.GptConfig(**kw), P.GptConfig(**kw)
    jp = J.stack_params(J.init_params(jcfg, seed=seed))
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                             device="cpu")
    return jcfg, jp, pcfg, pp


def _ids(b=2, s=6, seed=0, vocab=23):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def both(ids, steps, beams, m=None, **kw):
    """(port tokens, port scores) after checking them against the JAX beam
    search on the same weights."""
    jcfg, jp, pcfg, pp = m or model()
    jt, js = j_beam(jcfg, steps, beams, use_pallas=False, **kw)(
        jp, jnp.asarray(ids))
    pt, ps = P.make_beam_generate(pcfg, steps, beams, **kw)(
        pp, torch.from_numpy(ids))
    assert pt.dtype == torch.int32 and tuple(pt.shape) == (len(ids), steps)
    assert np.array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-4,
                               rtol=1e-4)
    return pt, ps


def seq_logp(pcfg, pp, prompt, cont):
    """Teacher-forced log-prob of continuation tokens given the prompt,
    from the port's prefill."""
    full = torch.cat([prompt, cont], 1)
    logits, _ = P.make_prefill(pcfg)(pp, full)
    logp = torch.log_softmax(logits.float(), -1)
    s0 = prompt.shape[1]
    return sum(logp[:, s0 - 1 + t].gather(1, cont[:, t:t + 1].long())[:, 0]
               for t in range(cont.shape[1]))


def test_beam1_equals_greedy():
    _, _, pcfg, pp = model()
    ids = _ids()
    got, _ = both(ids, 6, 1)
    want = P.make_generate(pcfg, 6)(pp, torch.from_numpy(ids))
    assert torch.equal(got, want)


def test_reported_score_is_true_logp():
    _, _, pcfg, pp = model()
    ids = _ids(b=3, s=5, seed=1)
    toks, scores = both(ids, 4, 3)
    want = seq_logp(pcfg, pp, torch.from_numpy(ids), toks)
    torch.testing.assert_close(scores, want, atol=2e-4, rtol=0)


def test_beam_width_vocab_steps2_is_exhaustive():
    """W = V keeps every first token, so 2-step beam search scores all V*V
    continuations: it returns the brute-force optimum."""
    m = model(vocab=7, max_seq=16, seed=3)
    _, _, pcfg, pp = m
    ids = _ids(b=2, s=4, seed=2, vocab=7)
    toks, scores = both(ids, 2, 7, m=m)
    prompt = torch.from_numpy(ids)
    best = torch.full((2,), -float("inf"))
    arg = torch.zeros(2, 2, dtype=torch.int32)
    for c1, c2 in itertools.product(range(7), repeat=2):
        cont = torch.tensor([[c1, c2]] * 2, dtype=torch.int32)
        tot = seq_logp(pcfg, pp, prompt, cont)
        better = tot > best
        best = torch.where(better, tot, best)
        arg[better] = cont[better]
    torch.testing.assert_close(scores, best, atol=2e-4, rtol=0)
    assert torch.equal(toks, arg)


def test_eos_freezes_beam():
    """With eos_id = the greedy first token, the beam finishes at t=1:
    every later position on the best beam is EOS and the score is the
    single-token log-prob."""
    _, _, pcfg, pp = model()
    ids = _ids(b=1, s=5, seed=4)
    logits, _ = P.make_prefill(pcfg)(pp, torch.from_numpy(ids))
    eos = int(logits[0, -1].argmax())
    toks, scores = both(ids, 5, 2, eos_id=eos)
    assert (toks[0] == eos).all(), toks
    logp0 = float(torch.log_softmax(logits[0, -1].float(), -1)[eos])
    assert abs(float(scores[0]) - logp0) <= 2e-4


def test_length_penalty_changes_norm_not_tokens_without_eos():
    """Without EOS every beam has the same length: length_penalty rescales
    the scores but cannot reorder the beams."""
    ids = _ids(b=2, s=5, seed=6)
    t0, s0 = both(ids, 3, 3, length_penalty=0.0)
    t1, s1 = both(ids, 3, 3, length_penalty=1.0)
    assert torch.equal(t0, t1)
    torch.testing.assert_close(s1 * 3.0, s0, atol=1e-5, rtol=0)


def test_beam_quantized_kv_gqa_matches_jax():
    """The reorder is one rule over the cache leaves: GQA with an int8 KV
    cache (and its scales at axis 1) gives the JAX beam's tokens."""
    kw = dict(BASE, kv_heads=2, kv_quant="int8")
    jcfg, pcfg = J.GptConfig(**kw), P.GptConfig(**kw)
    jp = J.stack_params(J.init_params(jcfg, seed=5))
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                             device="cpu")
    both(_ids(b=2, s=5, seed=7), 5, 3, m=(jcfg, jp, pcfg, pp))


def test_refuses_more_beams_than_vocab():
    with pytest.raises(ValueError, match="exceeds vocab"):
        P.make_beam_generate(model()[2], 3, 24)


def test_tpp_serve_beams_cli():
    """--beams on the CPU: the best beams' tokens, one row per prompt, the
    port's beam search on the tool's own weights and prompts."""
    from tpp_mlir_tpu_torch.tools import tpp_serve
    flags = ["--embed", "32", "--heads", "4", "--layers", "2",
             "--mlp-ratio", "2", "--vocab", "97", "--max-seq", "32",
             "--prompt-len", "6", "--steps", "4", "--batch", "2", "--beams",
             "3", "--dtype", "f32", "--device", "cpu"]
    out = io.StringIO()
    assert tpp_serve.main(flags, out=out) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("# beam search: width 3, 4 steps x batch 2")
    rows = [list(map(int, ln.split())) for ln in lines[1:]]
    cfg, params, ids = tpp_serve.setup(dict(
        vocab=97, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=32,
        dtype="f32", batch=2, prompt=6), "cpu")
    want, _ = P.make_beam_generate(cfg, 4, 3)(params, ids)
    assert rows == want.tolist()
