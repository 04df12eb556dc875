"""The serving slice against the JAX engine, on the same carried weights.

Each configuration runs the JAX package's `tpp_mlir_tpu.serving` (kernels in
interpret mode where it reaches one, as its own tests run) and the port's
`tpp_mlir_tpu_torch.serving` on the CPU, with the JAX `init_params` weights
carried into the port by `params_from_numpy` and the same numpy prompts:
prefill logits and cache, teacher-forced decode logits at every position,
extend, and greedy `make_generate` tokens (equal). Tolerances: 1e-4 (abs and
rel) in f32, where only summation orders differ; in bf16, where a sum-order
difference can flip an activation's rounding and the flip carries through
the layers, max|port - JAX| <= 3e-2 * max|JAX| (the chip smoke's model
tolerance), with the greedy tokens still equal at these sizes.
"""

import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P

BASE = dict(vocab=96, embed=64, heads=4, layers=2, mlp_ratio=4, max_seq=24)
B, S0, T = 2, 16, 4     # B*S0 = 32 rows: prefill reaches the int8 route

# name -> (config kwargs, llama preset, quantize_params weights)
CASES = {
    "gpt2_f32": (dict(dtype="f32"), False, False),
    "llama_gqa": (dict(dtype="f32", kv_heads=2), True, False),
    "kv_int8": (dict(dtype="f32", kv_quant="int8"), False, False),
    "int8_compute": (dict(dtype="f32", int8_compute=True), False, True),
    "kv_packed": (dict(dtype="f32", kv_packed=True, decode_attn="pallas"),
                  False, False),
    "bf16": (dict(dtype="bf16"), False, False),
    # prefill attention through B14's forward (its plain version here), the
    # JAX engine through the Pallas kernel in interpret mode
    "flash_attn": (dict(dtype="f32", flash_attn=True), False, False),
    "flash_attn_gqa": (dict(dtype="f32", kv_heads=2, flash_attn=True), True,
                       False),
}


class Case:
    """Both engines' configs, programs and weights for one configuration,
    built once (the JAX programs compile once per case)."""

    def __init__(self, name):
        kw, llama, quant = CASES[name]
        self.name, self.bf16 = name, kw["dtype"] == "bf16"
        self.jcfg = (J.GptConfig.llama if llama else J.GptConfig)(
            **BASE, **kw)
        self.pcfg = (P.GptConfig.llama if llama else P.GptConfig)(
            **BASE, **kw)
        jp = J.init_params(self.jcfg, seed=7)
        self.jp = J.quantize_params(jp) if quant else jp
        self.pp = P.params_from_numpy(jax.tree.map(np.asarray, self.jp),
                                      self.pcfg, device="cpu")
        self.ids = np.random.default_rng(7).integers(
            0, BASE["vocab"], (B, S0 + T)).astype(np.int32)
        self.j_prefill = J.make_prefill(self.jcfg, use_pallas=False)
        self.j_step = J.make_decode_step(self.jcfg)
        self.p_prefill = P.make_prefill(self.pcfg)
        self.p_step = P.make_decode_step(self.pcfg)

    def close(self, got, want, what):
        got = got.float().numpy() if isinstance(got, torch.Tensor) else got
        want = np.asarray(want, np.float32)
        if self.bf16:
            rel = np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want))
            assert rel <= 3e-2, f"{self.name} {what}: rel {rel}"
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                       equal_nan=True,
                                       err_msg=f"{self.name} {what}")

    def close_cache(self, pc, jc):
        assert pc.keys() == jc.keys()
        for name in pc:
            if name == "pos":
                assert np.array_equal(pc[name].numpy(), np.asarray(jc[name]))
            elif pc[name].dtype == torch.int8:
                assert np.array_equal(pc[name].numpy(), np.asarray(jc[name]))
            else:
                self.close(pc[name], jc[name], f"cache {name}")

    def prefill(self, n=S0):
        jl, jc = self.j_prefill(self.jp, jnp.asarray(self.ids[:, :n]))
        pl, pc = self.p_prefill(self.pp, torch.from_numpy(self.ids[:, :n]))
        return (jl, jc), (pl, pc)


@functools.lru_cache(maxsize=None)
def case(name):
    return Case(name)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(name):
    c = case(name)
    (jl, jc), (pl, pc) = c.prefill()
    assert tuple(pl.shape) == (B, S0, BASE["vocab"])
    c.close(pl, jl, "prefill logits")
    c.close_cache(pc, jc)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_teacher_forced_matches_jax(name):
    c = case(name)
    (_, jc), (_, pc) = c.prefill()
    for t in range(S0, S0 + T):
        jl, jc = c.j_step(c.jp, jc, jnp.asarray(c.ids[:, t]))
        pl, pc = c.p_step(c.pp, pc, torch.from_numpy(c.ids[:, t]))
        c.close(pl, jl, f"decode logits at {t}")
    c.close_cache(pc, jc)


@pytest.mark.parametrize("name", list(CASES))
def test_generate_greedy_tokens_equal_jax(name):
    c = case(name)
    prompt = c.ids[:, :S0]
    want = J.make_generate(c.jcfg, T, use_pallas=False)(
        c.jp, jnp.asarray(prompt), jax.random.PRNGKey(0))
    got = P.make_generate(c.pcfg, T)(c.pp, torch.from_numpy(prompt))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", [n for n in CASES if n != "kv_packed"])
def test_extend_matches_jax(name):
    c = case(name)
    (_, jc), (_, pc) = c.prefill(S0 - T)
    chunk = c.ids[:, S0 - T:S0]
    jl, jc = J.make_extend(c.jcfg)(c.jp, jc, jnp.asarray(chunk))
    pl, pc = P.make_extend(c.pcfg)(c.pp, pc, torch.from_numpy(chunk))
    c.close(pl, jl, "extend logits")
    c.close_cache(pc, jc)


def test_extend_refuses_a_packed_cache():
    with pytest.raises(ValueError, match="packed"):
        P.make_extend(case("kv_packed").pcfg)


@pytest.mark.parametrize("name,pos", [
    ("gpt2_f32", [S0, S0 - 3]), ("llama_gqa", [S0 - 5, BASE["max_seq"]]),
    ("kv_int8", [S0, BASE["max_seq"]]), ("kv_packed", [S0 - 1, S0]),
], ids=["gpt2", "llama-sentinel", "kv_int8-sentinel", "kv_packed"])
def test_slotted_decode_matches_jax(name, pos):
    """The same cache dict with a (B,) pos goes to both engines; a row at
    pos == max_seq is a free slot: its cache rows stay as they were."""
    c = case(name)
    (_, jc), _ = c.prefill()
    jc = dict(jc, pos=jnp.asarray(pos, jnp.int32))
    pc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    before = {k: v.clone() for k, v in pc.items()}
    for t in range(S0, S0 + 2):
        jl, jc = c.j_step(c.jp, jc, jnp.asarray(c.ids[:, t]))
        pl, pc = c.p_step(c.pp, pc, torch.from_numpy(c.ids[:, t]))
        c.close(pl, jl, f"slotted decode logits at {t}")
    c.close_cache(pc, jc)
    for b, p in enumerate(pos):
        if p == BASE["max_seq"]:
            assert torch.equal(pc["k"][:, b], before["k"][:, b])


def test_decode_kernel_and_einsum_paths_agree():
    """decode_attn "pallas" (the kernel's plain version on the CPU) and
    "xla" (the einsum path) give the same step, for GQA with int8 KV."""
    cfg = P.GptConfig.llama(**BASE, kv_heads=2, kv_quant="int8")
    params = P.init_params(cfg, seed=1, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, BASE["vocab"], (B, 8)).astype(np.int32))
    outs = []
    for mode in ("xla", "pallas"):
        mcfg = dataclasses.replace(cfg, decode_attn=mode)
        _, cache = P.make_prefill(mcfg)(params, ids)
        outs.append(P.make_decode_step(mcfg)(params, cache, ids[:, 0])[0])
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)


def test_config_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="A9"):
        P.GptConfig(n_experts=4)
    with pytest.raises(ValueError):
        P.GptConfig(**BASE, kv_packed=True, decode_attn="xla")


@pytest.mark.parametrize("field,value,item", [
    ("top_k", 1, "A9"), ("moe_decode_form", "gather", "A9"),
    ("moe_prefill_form", "sorted", "A9"), ("moe_capacity_factor", 2.0, "A9"),
    ("moe_group_bm", 64, "A9"), ("moe_group_stacked", False, "A9"),
    ("remat", True, "A10")])
def test_config_refuses_fields_nothing_reads_yet(field, value, item):
    """A field read only by code not ported yet takes only its default, so
    no setting silently does nothing."""
    with pytest.raises(NotImplementedError, match=f"{field}.*{item}"):
        P.GptConfig(**BASE, **{field: value})
    assert getattr(P.GptConfig(**BASE), field) == getattr(
        J.GptConfig(**BASE), field)


def test_decode_runner_reset_repeats_the_same_steps():
    """DecodeRunner (eager here): repeat() starts each time from the
    position the cache had, and its steps equal the decode step's."""
    c = case("gpt2_f32")
    _, (_, pc) = c.prefill()
    ref = {k: v.clone() for k, v in pc.items()}
    tok = torch.from_numpy(c.ids[:, S0])
    run = P.DecodeRunner(c.p_step, c.pp, pc, tok, graph=False)
    run.repeat(tok, 3)
    assert int(pc["pos"]) == S0 + 3
    first = run(tok)
    run.repeat(tok, 3)
    again = run(tok)
    for _ in range(4):
        want, ref = c.p_step(c.pp, ref, tok)
    torch.testing.assert_close(first, want, atol=0, rtol=0)
    torch.testing.assert_close(again, want, atol=0, rtol=0)


# -- sampler (mirrors tests/serving/test_serving.py:107-145) ---------------

def test_sampler_top_k_truncation():
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 64)).astype(np.float32))
    top8 = torch.topk(logits, 8, dim=-1).indices
    sample = P.make_sampler(temperature=1.0, top_k=8)
    g = torch.Generator().manual_seed(0)
    for _ in range(32):
        d = sample(logits, g)
        assert d.dtype == torch.int32 and d.shape == (4,)
        assert all(int(d[b]) in top8[b].tolist() for b in range(4))
    s1 = P.make_sampler(temperature=0.7, top_k=1)
    assert torch.equal(s1(logits, g), logits.argmax(-1).to(torch.int32))


def test_sampler_top_p_nucleus():
    logits = torch.zeros(2, 16)
    logits[:, 5] = 10.0
    s = P.make_sampler(temperature=1.0, top_p=0.5)
    g = torch.Generator().manual_seed(1)
    for _ in range(8):
        assert s(logits, g).tolist() == [5, 5]
    sall = P.make_sampler(temperature=1.0, top_p=1.0)
    seen = {int(sall(torch.zeros(1, 16), g)[0]) for _ in range(64)}
    assert len(seen) > 4


def test_generate_sampling_shape_and_range():
    c = case("llama_gqa")
    gen = P.make_generate(c.pcfg, 4, temperature=0.9, top_k=10, top_p=0.9)
    toks = gen(c.pp, torch.from_numpy(c.ids[:1, :4]),
               torch.Generator().manual_seed(11))
    assert toks.shape == (1, 4)
    assert 0 <= int(toks.min()) and int(toks.max()) < BASE["vocab"]


# -- tools/tpp_serve --------------------------------------------------------

SERVE = ["--vocab", "96", "--embed", "64", "--heads", "4", "--layers", "2",
         "--max-seq", "24", "--prompt-len", "6", "--steps", "5", "--batch",
         "2", "--dtype", "f32"]


def test_tpp_serve_matches_the_jax_tool_on_carried_weights():
    """The port's tpp_serve draws the JAX tool's prompts (default_rng(seed))
    and, given the JAX tool's weights, prints its greedy tokens. The random
    weights of the two tools differ (torch.Generator vs jax.random), so the
    tokens are pinned in process through params_from_numpy."""
    from tpp_mlir_tpu_torch.tools import tpp_serve

    args = tpp_serve.build_parser().parse_args(SERVE)
    jcfg = J.GptConfig(vocab=96, embed=64, heads=4, layers=2, max_seq=24,
                       dtype="f32")
    jp = J.stack_params(J.init_params(jcfg, seed=args.seed))
    ids = np.random.default_rng(args.seed).integers(
        0, jcfg.vocab, (args.batch, args.prompt_len))
    want = J.make_generate(jcfg, args.steps)(
        jp, jnp.asarray(ids, jnp.int32), jax.random.PRNGKey(args.seed))
    pcfg = P.GptConfig(vocab=96, embed=64, heads=4, layers=2, max_seq=24,
                       dtype="f32")
    res = tpp_serve.serve(pcfg, P.params_from_numpy(
        jax.tree.map(np.asarray, jp), pcfg, device="cpu"),
        torch.from_numpy(ids.astype(np.int32)), args.steps)
    assert np.array_equal(res["tokens"].numpy(), np.asarray(want))
    out = io.StringIO()
    assert tpp_serve.main(SERVE + ["--device", "cpu"], out=out) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("# prefill 2x6:") and "ms/step" in lines[0]
    rows = [list(map(int, line.split())) for line in lines[1:]]
    assert len(rows) == 2 and all(len(r) == 5 for r in rows)
    assert all(0 <= t < 96 for r in rows for t in r)


@pytest.mark.parametrize("flags", [
    ["--quant", "int4"], ["--tp", "2"], ["--speculative", "3"],
    ["--continuous", "4"], ["--beams", "2"], ["--experts", "4"],
    ["--prompt-len", "20"]])
def test_tpp_serve_refuses_with_exit_2(flags):
    from tpp_mlir_tpu_torch.tools import tpp_serve

    assert tpp_serve.main(SERVE + ["--device", "cpu"] + flags,
                          out=io.StringIO()) == 2


def test_tpp_serve_setup_draws_the_jax_tools_prompts():
    """setup (tpp_serve's, and the trace's and chip smoke's through it)
    draws the JAX tool's prompt ids for the seed."""
    from tpp_mlir_tpu_torch.tools.tpp_serve import setup
    _, _, ids = setup({"vocab": 96, "embed": 64, "heads": 4, "layers": 1,
                       "max_seq": 24, "batch": 3, "prompt": 5, "seed": 4},
                      device="cpu")
    want = np.random.default_rng(4).integers(0, 96, (3, 5))
    assert ids.dtype == torch.int32
    assert np.array_equal(ids.numpy(), want)


def test_serving_trace_reads_only_device_time():
    from tpp_mlir_tpu_torch.tools.tpp_serve import setup
    from tpp_mlir_tpu_torch.tools.trace import main, trace_serving
    cfg, params, ids = setup({"vocab": 96, "embed": 64, "heads": 4,
                              "layers": 1, "max_seq": 24, "batch": 1,
                              "prompt": 4}, device="cpu")
    assert tuple(ids.shape) == (1, 4) and len(params["blocks"]) == 1
    with pytest.raises(RuntimeError, match="needs CUDA"):
        trace_serving(cfg, params, ids)
    with pytest.raises(RuntimeError, match="needs --device cuda"):
        main(["--serve", '{"layers": 1}', "--device", "cpu"])
