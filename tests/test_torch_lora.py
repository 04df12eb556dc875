"""LoRA / QLoRA fine-tuning in the port against the JAX package, on the CPU.

`tpp_mlir_tpu_torch.serving.lora` (lora_init, merge_lora,
make_lora_train_step, adapters_from_numpy) against
`tpp_mlir_tpu.serving.lora`, with the JAX weights and adapters carried
across bit for bit (params_from_numpy, adapters_from_numpy) and the same
numpy token ids. The JAX prefill runs with use_pallas=False, as its own
LoRA tests do; the port's prefill with kernels off on CPU tensors (the
composed attention where a gradient is taken).

Tolerances (f32, where only summation orders differ): merged weights 1e-6
(abs and rel); losses 1e-5; adapters after three steps 1e-4 (through two
layers, the LM head and the optimizer's normalization of small gradients,
as the GPT steps in tests/test_torch_train.py); zero-delta adapters leave
the logits bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P
from tpp_mlir_tpu_torch.parallel import adamw, next_token_loss, sgd
from tpp_mlir_tpu_torch.parallel.optim import tree_leaves

CFG = dict(vocab=89, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=24,
           dtype="f32")
LLAMA = dict(vocab=67, embed=32, heads=4, layers=2, mlp_ratio=2,
             max_seq=16, dtype="f32", kv_heads=2)
MOE = dict(vocab=67, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=16,
           dtype="f32", n_experts=4, top_k=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ids(vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _configs(kw, llama=False):
    return ((J.GptConfig.llama if llama else J.GptConfig)(**kw),
            (P.GptConfig.llama if llama else P.GptConfig)(**kw))


def _carry(kw, bits=0, seed=0, llama=False):
    """Both packages' configs and stacked params (quantized at `bits`)."""
    jcfg, pcfg = _configs(kw, llama)
    jp = J.init_params(jcfg, seed=seed)
    if bits:
        jp = J.quantize_params(jp, bits=bits)
    jp = J.stack_params(jp)
    return jcfg, pcfg, jp, P.params_from_numpy(_np(jp), pcfg, device="cpu")


def _random_adapters(jad, seed):
    """JAX adapters with B drawn too, so the delta is not zero."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 0.1), jad)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_adapter_shapes_and_target_selection():
    params = P.init_params(P.GptConfig(**CFG), seed=0, device="cpu")
    ad = P.lora_init(params, rank=4, targets=("wq", "wv"), device="cpu")
    blk = ad["blocks"][0]
    E = CFG["embed"]
    assert set(blk) == {"wq", "wv"} and len(ad["blocks"]) == CFG["layers"]
    assert blk["wq"]["a"].shape == (E, 4) and blk["wq"]["b"].shape == (4, E)
    assert not blk["wq"]["b"].any() and blk["wq"]["a"].dtype == torch.float32
    assert set(P.lora_init(params, targets="all", device="cpu")["blocks"][0]) \
        == {"wq", "wk", "wv", "wo", "w1", "w2"}
    # the JAX package's stacked layout gets stacked adapters
    _, _, jp, _ = _carry(CFG)
    sad = P.lora_init({"blocks": {k: torch.from_numpy(np.asarray(v)) for k, v
                                  in jp["blocks"].items()}},
                      rank=4, targets=("wq",), device="cpu")
    assert sad["blocks"]["wq"]["a"].shape == (CFG["layers"], E, 4)
    # seeded: the same seed gives the same A
    again = P.lora_init(params, rank=4, targets=("wq", "wv"), device="cpu")
    assert torch.equal(again["blocks"][0]["wq"]["a"], blk["wq"]["a"])
    with pytest.raises(ValueError, match="no LoRA targets"):
        P.lora_init(params, targets=("w9",), device="cpu")


@pytest.mark.parametrize("name", ["gpt", "llama", "moe"])
def test_zero_delta_adapters_are_the_base_model(name):
    """lora_init's B = 0, so the merged model's logits are the base's, bit
    for bit (SwiGLU's w1/w3/w2 and the MoE expert stacks included)."""
    kw, llama, targets = {"gpt": (CFG, False, "all"),
                          "llama": (LLAMA, True, "all"),
                          "moe": (MOE, False, ("w1", "w2"))}[name]
    _, pcfg = _configs(kw, llama)
    params = P.init_params(pcfg, seed=1, device="cpu")
    ad = P.lora_init(params, rank=4, targets=targets, seed=1, device="cpu")
    if name == "moe":
        a = ad["blocks"][0]["w1"]["a"]
        assert a.shape == (kw["n_experts"], kw["embed"], 4)
    ids = torch.from_numpy(_ids(kw["vocab"], seed=7))
    prefill = P.make_prefill(pcfg)
    base, _ = prefill(params, ids)
    got, _ = prefill(P.merge_lora(params, ad), ids)
    assert torch.equal(got, base)


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["float", "int8", "int4"])
def test_merge_matches_jax(bits):
    """merge_lora on carried params and adapters equals the JAX merge leaf
    by leaf (a QTensor base dequantized to f32, as JAX leaves it), and the
    merged models' prefill logits agree."""
    jcfg, pcfg, jp, pp = _carry(CFG, bits, seed=2)
    jad = _random_adapters(J.lora_init(jp, rank=4, targets=("wq", "wv",
                                                            "w2")), 3)
    pad = P.adapters_from_numpy(_np(jad), device="cpu")
    jm = J.merge_lora(jp, jad)
    pm = P.merge_lora(pp, pad)
    for name in ("wq", "wv", "w2"):
        got = torch.stack([b[name] for b in pm["blocks"]])
        assert got.dtype == torch.float32
        _close(got, jm["blocks"][name], 1e-6)
    kept = pm["blocks"][0]["wk"]
    assert isinstance(kept, P.QTensor) == bool(bits)
    ids = _ids(CFG["vocab"], seed=4)
    want, _ = J.make_prefill(jcfg, use_pallas=False)(jm, jnp.asarray(ids))
    got, _ = P.make_prefill(pcfg)(pm, torch.from_numpy(ids))
    _close(got, want, 1e-4)


def test_adapters_carry_across_bit_for_bit():
    _, _, jp, _ = _carry(CFG)
    jad = _random_adapters(J.lora_init(jp, rank=4), 5)
    pad = P.adapters_from_numpy(_np(jad), device="cpu")
    for name in ("wq", "wv"):
        for k in ("a", "b"):
            assert np.array_equal(pad["blocks"][name][k].numpy(),
                                  np.asarray(jad["blocks"][name][k]))
    per_layer = P.adapters_from_numpy(
        {"blocks": [{"wq": {"a": np.ones((2, 3), np.float32),
                            "b": np.zeros((3, 2), np.float32)}}]},
        device="cpu")
    assert per_layer["blocks"][0]["wq"]["a"].shape == (2, 3)


STEP_CASES = {
    "float-adamw": (CFG, 0, False, ("wq", "wv", "w2"), "adamw"),
    "float-sgd": (CFG, 0, False, ("wq", "wv"), "sgd"),
    "qlora-int8-adamw": (CFG, 8, False, ("wq", "wv"), "adamw"),
    "qlora-int4-sgd": (CFG, 4, False, ("wq", "wv", "wo"), "sgd"),
    "llama-adamw": (LLAMA, 0, True, "all", "adamw"),
    "moe-sgd": (MOE, 0, False, ("wq", "w1", "w2"), "sgd"),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_steps_match_jax(name):
    """Three adapter-only steps from carried params and adapters: the
    losses and the adapters equal the JAX step's (optax.sgd / optax.adamw
    against the port's sgd / adamw), and the frozen base, quantized or
    not, is left as it was."""
    kw, bits, llama, targets, opt = STEP_CASES[name]
    jcfg, pcfg, jp, pp = _carry(kw, bits, seed=6, llama=llama)
    jad = _random_adapters(J.lora_init(jp, rank=4, targets=targets), 8)
    pad = P.adapters_from_numpy(_np(jad), device="cpu")
    lr = 3e-2
    jstep, jinit = J.make_lora_train_step(
        jcfg, optax.sgd(lr) if opt == "sgd" else optax.adamw(lr),
        use_pallas=False)
    pstep, pinit = P.make_lora_train_step(
        pcfg, sgd(lr) if opt == "sgd" else adamw(lr))
    frozen = [t for t in tree_leaves(pp) if isinstance(t, torch.Tensor)]
    base = [t.clone() for t in frozen]
    js, ps = jinit(jad), pinit(pad)
    ids = _ids(kw["vocab"], b=4, s=12, seed=9)
    for _ in range(3):
        jad, js, jloss = jstep(jp, jad, js, jnp.asarray(ids))
        pad, ps, ploss = pstep(pp, pad, ps, torch.from_numpy(ids))
        _close(ploss, jloss, 1e-5)
    for leaf, want in zip(tree_leaves(pad), jax.tree.leaves(jad)):
        _close(leaf, want, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(frozen, base))


def test_loss_drops_and_the_merged_model_serves():
    """The JAX package's LoRA checks in the port: the step-0 loss is the
    base prefill's cross-entropy, the loss falls, the eager merge equals
    the in-step merge's logits, and the merged tree decodes."""
    _, pcfg, _, pp = _carry(CFG, seed=0)
    ad = P.lora_init(pp, rank=8, targets=("wq", "wv", "w2"), device="cpu")
    step, init = P.make_lora_train_step(pcfg, adamw(3e-2))
    st = init(ad)
    ids = torch.from_numpy(_ids(CFG["vocab"], b=4, s=16))
    prefill = P.make_prefill(pcfg)
    with torch.no_grad():
        loss0 = next_token_loss(prefill(pp, ids)[0], ids)
    losses = [step(pp, ad, st, ids)[2].item() for _ in range(8)]
    assert abs(losses[0] - loss0.item()) < 1e-5
    assert losses[-1] < 0.7 * loss0.item()
    with torch.no_grad():
        want, _ = prefill(P.merge_lora(pp, ad, train=True), ids)
        merged = P.merge_lora(pp, ad)
        got, cache = prefill(merged, ids)
        assert torch.equal(got, want)
        logits, _ = P.make_decode_step(pcfg)(merged, cache,
                                            torch.full((4,), 5))
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", ["dense", "moe-grouped", "qlora-int4"])
def test_remat_step_gives_the_same_loss_and_adapters(name):
    """GptConfig(remat=True): the same losses, bit for bit, and adapters
    within 1e-6 (the recomputed forward is the same arithmetic)."""
    kw = {"dense": CFG, "qlora-int4": CFG,
          "moe-grouped": dict(MOE, moe_prefill_form="grouped",
                              moe_group_bm=8)}[name]
    bits = 4 if name == "qlora-int4" else 0
    ids = torch.from_numpy(_ids(kw["vocab"], b=2, s=12, seed=3))
    runs = []
    for remat in (False, True):
        pcfg = P.GptConfig(**kw, remat=remat)
        pp = P.init_params(pcfg, seed=3, device="cpu")
        if bits:
            pp = P.quantize_params(pp, bits=bits)
        ad = P.lora_init(pp, rank=4, targets=("wq", "wv", "w1"), seed=4,
                         device="cpu")
        step, init = P.make_lora_train_step(pcfg, sgd(0.1))
        st = init(ad)
        losses = [step(pp, ad, st, ids)[2] for _ in range(2)]
        runs.append((losses, tree_leaves(ad)))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-6)


def test_int8_compute_has_no_gradient():
    """B15 has no backward in either package: a LoRA step through an
    int8-compute prefill raises instead of training on a wrong gradient."""
    pcfg = P.GptConfig(**CFG, int8_compute=True)
    pp = P.quantize_params(P.init_params(pcfg, seed=0, device="cpu"))
    ad = P.lora_init(pp, rank=4, device="cpu")
    step, init = P.make_lora_train_step(pcfg, sgd(0.1))
    with pytest.raises(NotImplementedError, match="int8_compute"):
        step(pp, ad, init(ad), torch.from_numpy(_ids(CFG["vocab"], b=2,
                                                     s=16)))


def test_lora_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = P.init_params(P.GptConfig(**CFG), seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        P.lora_init(params)
    with pytest.raises(RuntimeError):
        P.adapters_from_numpy({"blocks": []})
