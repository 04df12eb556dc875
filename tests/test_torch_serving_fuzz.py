"""ROADMAP A7: the JAX package's serving config-space fuzzer
(tests/serving/test_fuzz_configs.py) on the port's engine, on the CPU with
its kernels off (use_kernels=False: the composed and plain paths).

The fuzzer's ten architectures (`ARCHES` there, :51-80) on its `_BASE`, its
S0, STEPS and K and its seed schedule (range(arch, N_SEEDS, len(ARCHES)),
N_SEEDS 100) drive torch_parity_cases.FuzzHarness, which runs each path the
architecture supports (chunked: make_extend in 4-token chunks; slotted:
BatchingEngine with a decoy; device: DeviceBatchingEngine with wave=1 and
a decoy; spec: make_speculative_generate with trunk_layers=1; forms: the
other MoE prefill form) and the greedy oracle make_generate on the same
params; torch_parity_cases.fuzz_compare holds every path to the oracle
token for token (no near-tie exemption here), with logits within
chip_smoke's TOL_MODEL of the oracle's max |logit|. Across backends, the
first two seeds of each architecture run on the JAX init_params weights
carried by params_from_numpy, and the JAX oracle (make_generate(cfg,
STEPS, use_pallas=False)) must give the port's oracle tokens.

The meta-test seeds the JAX one's bug, a silent top-1 combine in the
grouped MoE form (the port's serving/engine.py _grouped_combine), and the
forms check must fail.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parity_cases as cases
import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu_torch.serving as P
from chip_smoke import TOL_MODEL
from torch_parity_cases import FUZZ_S0, FUZZ_STEPS, FuzzHarness
from tpp_mlir_tpu_torch.serving import engine

N_SEEDS = 100
CROSS_SEEDS = 2     # per architecture, also against the JAX oracle
_BASE = dict(vocab=97, embed=32, heads=4, layers=2, mlp_ratio=2,
             max_seq=32, dtype="f32")
ARCHES = cases.fuzz_arches(_BASE, kv_heads=2)


def test_the_fuzzers_constants():
    assert (FUZZ_S0, FUZZ_STEPS, cases.FUZZ_K) == (8, 6, 3)
    assert [a[1].moe_group_bm for a in ARCHES if a[1].n_experts] == [8, 8]
    assert [a[0] for a in ARCHES] == [
        "dense", "llama_gqa", "moe_scan", "moe_grouped", "quant_int8",
        "kv_int8", "kv_packed", "kv_packed_rope", "flash_prefill",
        "flash_gqa"]


@functools.lru_cache(maxsize=None)
def _jax_generate(idx):
    """The JAX oracle of ARCHES[idx], compiled once."""
    return J.make_generate(J.GptConfig(**dataclasses.asdict(ARCHES[idx][1])),
                           FUZZ_STEPS, use_pallas=False)


def _carried(idx, seed):
    """The JAX fuzzer's params for `seed` (stacked, quantized where the
    architecture is), and the same weights as the port's params."""
    _, cfg, bits, _ = ARCHES[idx]
    jp = J.stack_params(J.init_params(
        J.GptConfig(**dataclasses.asdict(cfg)), seed=seed))
    if bits:
        jp = J.quantize_params(jp, bits=bits)
    return jp, P.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")


@pytest.mark.parametrize("idx", range(len(ARCHES)),
                         ids=[a[0] for a in ARCHES])
def test_fuzz_serving_paths(idx):
    _, cfg, bits, paths = ARCHES[idx]
    harness = FuzzHarness(cfg, bits, paths, "cpu", use_kernels=False)
    for i, seed in enumerate(range(idx, N_SEEDS, len(ARCHES))):
        jp, params = _carried(idx, seed) if i < CROSS_SEEDS else (None, None)
        runs = harness.run(seed, params)
        cases.fuzz_compare(runs, seed, exempt=False, tol=TOL_MODEL)
        if jp is not None:
            prompt = np.random.default_rng(seed).integers(
                0, cfg.vocab, (1, FUZZ_S0)).astype(np.int32)
            want = _jax_generate(idx)(jp, jnp.asarray(prompt),
                                      jax.random.PRNGKey(0))
            assert runs["oracle"][0] == np.asarray(want)[0].tolist(), \
                f"the port's oracle is not the JAX oracle (seed {seed})"


def test_fuzzer_catches_seeded_form_routing_bug(monkeypatch):
    """A silent top-1-instead-of-top-k combine in the grouped form (the
    second expert's contribution dropped, no crash, plausible outputs):
    the scan-against-grouped forms check must fail."""
    real = engine._grouped_combine
    monkeypatch.setattr(engine, "_grouped_combine",
                        lambda gates, ys, rows, top_k: real(gates, ys, rows,
                                                            1))
    idx = next(i for i, a in enumerate(ARCHES) if a[0] == "moe_grouped")
    harness = FuzzHarness(ARCHES[idx][1], 0, ("forms",), "cpu",
                          use_kernels=False)
    with pytest.raises(AssertionError, match="^forms "):
        for seed in range(idx, N_SEEDS, len(ARCHES)):
            cases.fuzz_compare(harness.run(seed), seed, exempt=False,
                               tol=TOL_MODEL)
