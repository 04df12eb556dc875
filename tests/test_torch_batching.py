"""Continuous batching in the port (`tpp_mlir_tpu_torch.serving.batching`)
against the JAX package's (`tpp_mlir_tpu.serving.batching`), on carried
weights.

Mirrors tests/serving/test_batching.py (without its tensor-parallel case,
ROADMAP A11): the slotted decode step, prefill-to-slot insertion, and both
schedulers. Weights come from the JAX `init_params` through
`params_from_numpy`; every case runs the JAX engine (use_pallas=False, as
its own tests do) and the port's engine on the CPU in f32, and each greedy
token stream must equal the JAX engine's and the port's single-request
oracle (an unpadded batch-1 prefill and scalar-pos decode steps) exactly:
staggered admission, slot reuse, bucket padding, wave refills and garbage
slots must not change any request's tokens. Sampled runs are held only to
the port's own oracle (torch.Generator numbers are not jax.random's): the
same seed gives the same tokens, and top_k=1 equals greedy.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P

BASE = dict(vocab=97, embed=32, heads=4, layers=2, mlp_ratio=2,
            max_seq=48, dtype="f32")
QGQA = dict(BASE, max_seq=32, kv_heads=2, kv_quant="int8")
BUCKETS = (4, 8, 16)


@functools.lru_cache(maxsize=None)
def model(seed: int, quant: bool = False):
    """(JAX cfg, JAX params, port cfg, port params) for a seed; `quant`:
    int8 weights, int8 KV and GQA (test_batching_quantized_gqa's model)."""
    kw = QGQA if quant else BASE
    jcfg, pcfg = J.GptConfig(**kw), P.GptConfig(**kw)
    jp = J.init_params(jcfg, seed=seed)
    if quant:
        jp = J.quantize_params(jp)
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                             device="cpu")
    return jcfg, jp, pcfg, pp


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, BASE["vocab"], n).astype(np.int32)
            for n in lengths]


def port_oracle(params, cfg, prompt, max_new, eos_id=None):
    """The port's single-request greedy generation: unpadded batch-1
    prefill + scalar-pos decode steps."""
    logits, cache = P.make_prefill(cfg)(
        params, torch.from_numpy(np.asarray(prompt, np.int32))[None])
    step = P.make_decode_step(cfg)
    out = [int(logits[0, len(prompt) - 1].argmax())]
    cap = min(max_new, cfg.max_seq - len(prompt))
    while len(out) < cap and (eos_id is None or out[-1] != eos_id):
        logits, cache = step(params, cache,
                             torch.tensor([out[-1]], dtype=torch.int32))
        out.append(int(logits[0].argmax()))
    return out


def _serve(engine, prompts, max_new):
    rids = [engine.submit(p, max_new=max_new) for p in prompts]
    got = engine.run()
    assert sorted(got) == sorted(rids)
    return [got[r] for r in rids]


def check_engines(seed, prompts, max_new, device, quant=False, eos=None,
                  **kw):
    """The port's engine (device scheduler or host) against the JAX
    package's on the same weights, and both against the port's oracle."""
    jcfg, jp, pcfg, pp = model(seed, quant)
    jeng = (J.DeviceBatchingEngine if device else J.BatchingEngine)(
        jp, jcfg, eos_id=eos, use_pallas=False, **kw)
    peng = (P.DeviceBatchingEngine if device else P.BatchingEngine)(
        pp, pcfg, eos_id=eos, **kw)
    want = _serve(jeng, prompts, max_new)
    got = _serve(peng, prompts, max_new)
    assert got == want
    for prompt, toks in zip(prompts, got):
        assert toks == port_oracle(pp, pcfg, prompt, max_new, eos)
    return got


def test_slotted_decode_matches_scalar_pos_and_jax():
    """A (B,) position vector with equal entries reproduces the scalar-pos
    decode step (the cache bit for bit), and the JAX slotted step."""
    jcfg, jp, pcfg, pp = model(0)
    prompt = np.stack([np.arange(1, 9) % BASE["vocab"]] * 2).astype(np.int32)
    _, cache = P.make_prefill(pcfg)(pp, torch.from_numpy(prompt))
    step = P.make_decode_step(pcfg)
    tok = torch.tensor([5, 5], dtype=torch.int32)
    slot = {k: v.clone() for k, v in cache.items()}
    slot["pos"] = torch.full((2,), int(cache["pos"]), dtype=torch.int32)
    ref_logits, ref = step(pp, cache, tok)
    got_logits, got = step(pp, slot, tok)
    torch.testing.assert_close(got_logits, ref_logits, atol=1e-5, rtol=1e-5)
    assert torch.equal(got["k"], ref["k"])
    assert got["pos"].tolist() == [int(ref["pos"])] * 2
    _, jc = J.make_prefill(jcfg, use_pallas=False)(J.stack_params(jp),
                                                   jnp.asarray(prompt))
    jl, _ = J.make_decode_step(jcfg)(jp, dict(jc, pos=jnp.full(
        (2,), 8, jnp.int32)), jnp.asarray([5, 5], jnp.int32))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(jl),
                               atol=1e-4, rtol=1e-4)


def test_sentinel_slot_writes_drop():
    """A slot parked at pos == max_seq writes no KV anywhere."""
    _, _, pcfg, pp = model(1)
    cache = P.init_slot_cache(pcfg, slots=2, device="cpu")
    before = cache["k"].clone()
    P.make_decode_step(pcfg)(pp, cache, torch.tensor([1, 2],
                                                     dtype=torch.int32))
    assert torch.equal(cache["k"], before)


def test_insert_sets_slot_rows_and_pos_as_jax():
    jcfg, jp, pcfg, pp = model(2)
    prompt = ((np.arange(7) * 3 + 1) % BASE["vocab"]).astype(np.int32)
    _, pcache = P.make_prefill(pcfg)(pp, torch.from_numpy(prompt)[None])
    cache = P.make_insert(pcfg)(P.init_slot_cache(pcfg, 3, device="cpu"),
                                pcache, 1, len(prompt))
    assert cache["pos"].tolist() == [48, 7, 48]
    assert torch.equal(cache["k"][:, 1], pcache["k"][:, 0])
    assert not cache["k"][:, 0].any()
    _, jpc = J.make_prefill(jcfg, use_pallas=False)(
        J.stack_params(jp), jnp.asarray(prompt)[None])
    jc = J.make_insert(jcfg)(J.init_slot_cache(jcfg, 3), jpc, 1, 7)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, rtol=1e-5)


# (scheduler, engine kwargs): the JAX tests' (slots, sync_steps[, wave]),
# and a one-slot, one-step host run
SCHEDULES = [
    ("host", dict(slots=2, sync_steps=3)),
    ("host", dict(slots=3, sync_steps=1)),
    ("host", dict(slots=1, sync_steps=5)),
    ("device", dict(slots=2, sync_steps=3, wave=3)),
    ("device", dict(slots=3, sync_steps=5, wave=2)),
    ("device", dict(slots=4, sync_steps=8, wave=5)),
]


@pytest.mark.parametrize("sched,kw", SCHEDULES,
                         ids=[f"{s}-" + "-".join(map(str, kw.values()))
                              for s, kw in SCHEDULES])
def test_batching_matches_jax_and_sequential(sched, kw):
    """Five staggered requests through few slots (forced reuse) each get
    the JAX engine's tokens and the port oracle's."""
    check_engines(3, _prompts(0, (3, 9, 5, 14, 8)), 11, sched == "device",
                  buckets=BUCKETS, **kw)


@pytest.mark.parametrize("sched", ["host", "device"])
def test_batching_eos_frees_slot_early(sched):
    """EOS mid-stream finishes the request (the device scheduler zeroes the
    budget in the macro); the slot serves the queue; the EOS token is
    recorded."""
    _, _, pcfg, pp = model(4)
    prompts = _prompts(1, (6,) * 4)
    eos = port_oracle(pp, pcfg, prompts[0], 12)[2]
    kw = dict(slots=2, sync_steps=2, buckets=(8,))
    if sched == "device":
        kw["wave"] = 4
    got = check_engines(4, prompts, 12, sched == "device", eos=eos, **kw)
    assert got[0][-1] == eos and len(got[0]) <= 3


@pytest.mark.parametrize("sched", ["host", "device"])
def test_batching_quantized_gqa(sched):
    """int8 weights + int8 KV + GQA through the same scheduler: the slab
    copies and the admission are layout-generic."""
    kw = dict(slots=2, sync_steps=2, buckets=BUCKETS)
    if sched == "device":
        kw["wave"] = 2
    check_engines(5, _prompts(2, (4, 7, 11)), 6, sched == "device",
                  quant=True, **kw)


@pytest.mark.parametrize("sched", ["host", "device"])
def test_batching_cache_capacity_cap(sched):
    """A request whose prompt nearly fills max_seq is capped at max_seq -
    len(prompt) tokens, not written out of bounds."""
    prompt = (np.arange(BASE["max_seq"] - 3) % BASE["vocab"]).astype(
        np.int32)
    kw = dict(slots=1, sync_steps=4, buckets=(BASE["max_seq"],))
    if sched == "device":
        kw["wave"] = 1
    got = check_engines(6, [prompt], 50, sched == "device", **kw)
    assert len(got[0]) == 3


@pytest.mark.parametrize("sched", ["host", "device"])
def test_reset_replays_the_trace(sched):
    """reset() keeps the buffers and clears the state: a second run of the
    same trace gives the same tokens, and the host engine's buffers stay
    the tensors its decode loop was built on."""
    _, _, pcfg, pp = model(3)
    cls = P.DeviceBatchingEngine if sched == "device" else P.BatchingEngine
    kw = dict(wave=2) if sched == "device" else {}
    eng = cls(pp, pcfg, slots=2, sync_steps=3, buckets=BUCKETS, **kw)
    prompts = _prompts(0, (3, 9, 5))
    first = _serve(eng, prompts, 7)
    k = eng.cache["k"]
    eng.reset()
    assert _serve(eng, prompts, 7) == first
    assert eng.cache["k"] is k


@pytest.mark.parametrize("sched", ["host", "device"])
def test_sampling_repeats_and_top_k_1_is_greedy(sched):
    """Sampled runs against the port's own oracle: the same seed gives the
    same tokens, another seed other tokens, and top_k=1 the greedy ones."""
    _, _, pcfg, pp = model(3)
    cls = P.DeviceBatchingEngine if sched == "device" else P.BatchingEngine
    kw = dict(slots=2, sync_steps=3, buckets=BUCKETS)
    if sched == "device":
        kw["wave"] = 3
    prompts = _prompts(0, (3, 9, 5, 14))

    def run(**sampling):
        return _serve(cls(pp, pcfg, **kw, **sampling), prompts, 9)
    a = run(temperature=1.0, seed=1)
    assert a == run(temperature=1.0, seed=1)
    assert a != run(temperature=1.0, seed=2)
    assert run(temperature=0.7, top_k=1, seed=5) == run()
    assert all(0 <= t < BASE["vocab"] for toks in a for t in toks)


def test_refusals():
    """A tp mesh larger than the world (one process here: the tp engine
    runs in tests/test_torch_tp_serving.py's world), prompts outside the
    buckets and non-positive sizes are refused, as in the JAX engine (the
    mesh in make_mesh's words)."""
    _, _, pcfg, pp = model(3)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        P.BatchingEngine(pp, pcfg, tp_mesh={"tp": 2})
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        P.make_decode_loop(pcfg, 2, mesh={"tp": 2})
    eng = P.BatchingEngine(pp, pcfg, buckets=BUCKETS)
    for bad in ([], np.arange(17)):
        with pytest.raises(ValueError, match="prompt length"):
            eng.submit(bad)
    with pytest.raises(ValueError, match="bucket"):
        P.DeviceBatchingEngine(pp, pcfg, buckets=(64,))
    with pytest.raises(ValueError, match="positive"):
        P.DeviceBatchingEngine(pp, pcfg, wave=0)


# -- tools/tpp_serve --continuous --------------------------------------------

SERVE = ["--embed", "32", "--heads", "4", "--layers", "2", "--mlp-ratio",
         "2", "--vocab", "97", "--max-seq", "32", "--prompt-len", "6",
         "--steps", "4", "--batch", "2", "--dtype", "f32", "--device", "cpu",
         "--continuous", "3", "--sync-steps", "2"]


def test_continuous_prompts_are_the_jax_tools():
    """The port's --continuous trace is the JAX tool's draw
    (tpp_mlir_tpu/tools/tpp_serve.py: lengths, then each prompt's ids)."""
    from tpp_mlir_tpu_torch.tools.tpp_serve import continuous_prompts
    rng = np.random.default_rng(3)
    want = [rng.integers(0, 97, int(n)).astype(np.int32)
            for n in rng.integers(1, 7, 5)]
    got = continuous_prompts(97, 6, 5, 3)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("flags,sched", [
    ([], "host"), (["--device-scheduler", "--wave", "2"], "device")])
def test_tpp_serve_continuous_cli(flags, sched):
    """The CLI serves the trace through the scheduler on the CPU (plain
    versions) and prints each request's tokens, the port engine's own."""
    from tpp_mlir_tpu_torch.tools import tpp_serve
    out = io.StringIO()
    assert tpp_serve.main(SERVE + flags, out=out) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("# continuous: 3 requests through 2 slots, "
                               f"sync every 2 steps ({sched} scheduler): "
                               "12 tokens")
    reqs = [ln for ln in lines if ln.startswith("req ")]
    assert len(reqs) == 3
    args = tpp_serve.build_parser().parse_args(SERVE)
    cfg, params, _ = tpp_serve.setup(dict(
        vocab=97, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=32,
        dtype="f32", batch=2, prompt=6, seed=args.seed), "cpu")
    prompts = tpp_serve.continuous_prompts(97, 6, 3, args.seed)
    for line, prompt in zip(reqs, prompts):
        toks = [int(t) for t in line.split(": ")[1].split()]
        assert toks == port_oracle(params, cfg, prompt, 4)
