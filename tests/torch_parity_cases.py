"""Cases shared by the port's parity tests and chip_smoke.py's parity phases.

A6: FUSION_CASES, the programs of the JAX package's transformer-fusion and
returned-value tests (tests/passes/test_transformer_fusion.py and
tests/passes/test_returned_values.py), which tests/
test_torch_transformer_fusion.py holds against the JAX package on the CPU
and chip_smoke.phase_fusion_parity runs on the card.

A7: the JAX serving fuzzer (tests/serving/test_fuzz_configs.py) as a
harness of the port's engine: its ten architectures (:51-80) on a base of
GptConfig fields, its prompt of S0 tokens, STEPS greedy tokens and K
drafts, and its paths (_check_seed, :122-185), each held against the
greedy oracle (make_generate) on the same params. tests/
test_torch_serving_fuzz.py runs it on the CPU on the fuzzer's own base
(token-exact, and against the JAX oracle); chip_smoke.phase_serving_fuzz
on the card at GPT-2 small's widths, kernels on.

Imports numpy, torch and the port only, and those inside the functions,
so that importing it loads none of them; never JAX (chip_smoke.py imports
it, tests/test_torch_imports.py holds both to that).
"""

from __future__ import annotations

# each case: IR text, or the arguments of
# models.transformer_block.build_transformer_block, and each input as
# (shape, seed, scale):
# tensor_init("rand", shape, "f32", seed) * scale
RESIDUAL_GEMM = """func @entry(%x: tensor<64x128xf32>, %w: tensor<128x128xf32>, %b: tensor<128xf32>) {
  %0 = tl.constant {init = "zero", seed = 0} : tensor<64x128xf32>
  %1 = tl.matmul %x, %w, %0 : tensor<64x128xf32>
  %2 = tl.add %1, %b : tensor<64x128xf32>
  %3 = tl.add %2, %x : tensor<64x128xf32>
  %4 = tl.relu %3 : tensor<64x128xf32>
  return %4 : tensor<64x128xf32>
}
"""
_FC_INPUTS = (((64, 128), 0, 1.0), ((128, 128), 1, 0.05), ((128,), 2, 1.0))
_BLOCK = dict(batch=2, seq=128, embed=256, heads=4)
FUSION_CASES = {
    "fold_residual_acc_gemm": (RESIDUAL_GEMM, _FC_INPUTS),
    "fold_residual_acc_keeps_unary_barrier": (RESIDUAL_GEMM.replace(
        """  %3 = tl.add %2, %x : tensor<64x128xf32>
  %4 = tl.relu %3 : tensor<64x128xf32>""",
        """  %3 = tl.relu %2 : tensor<64x128xf32>
  %4 = tl.add %3, %x : tensor<64x128xf32>"""), _FC_INPUTS),
    "fold_residual_acc_plain_brgemm_keeps_unary": ("""func @entry(%a: tensor<4x64x32xf32>, %b: tensor<4x32x128xf32>, %r: tensor<2x32x128xf32>) {
  %z = tl.constant {init = "zero"} : tensor<64x128xf32>
  %0 = tl.brgemm %a, %b, %z : tensor<64x128xf32>
  %1 = tl.reshape %0 : tensor<2x32x128xf32>
  %2 = tl.add %1, %r : tensor<2x32x128xf32>
  %3 = tl.relu %2 : tensor<2x32x128xf32>
  return %3 : tensor<2x32x128xf32>
}
""", (((4, 64, 32), 0, 1.0), ((4, 32, 128), 1, 0.05),
      ((2, 32, 128), 2, 1.0))),
    "transformer_block_fuses_completely": (_BLOCK,
                                           (((2, 128, 256), 0, 1.0),)),
    "multilayer_encoder_fuses_per_layer": (dict(_BLOCK, layers=2),
                                           (((2, 128, 256), 0, 1.0),)),
    "qkv_merge_requires_constant_weights": ("""func @entry(%x: tensor<2x128x64xf32>, %wq: tensor<64x64xf32>, %wk: tensor<64x64xf32>, %wv: tensor<64x64xf32>, %b: tensor<64xf32>) {
  %f = tl.reshape %x : tensor<256x64xf32>
  %z = tl.constant {init = "zero"} : tensor<256x64xf32>
  %q0 = tl.matmul %f, %wq, %z : tensor<256x64xf32>
  %q1 = tl.add %q0, %b : tensor<256x64xf32>
  %q = tl.reshape %q1 : tensor<2x128x64xf32>
  %k0 = tl.matmul %f, %wk, %z : tensor<256x64xf32>
  %k1 = tl.add %k0, %b : tensor<256x64xf32>
  %k = tl.reshape %k1 : tensor<2x128x64xf32>
  %v0 = tl.matmul %f, %wv, %z : tensor<256x64xf32>
  %v1 = tl.add %v0, %b : tensor<256x64xf32>
  %v = tl.reshape %v1 : tensor<2x128x64xf32>
  %a = tl.attention %q, %k, %v {scale = 0.125, heads = 1} : tensor<2x128x64xf32>
  return %a : tensor<2x128x64xf32>
}
""", (((2, 128, 64), 0, 1.0), ((64, 64), 1, 0.05), ((64, 64), 2, 0.05),
      ((64, 64), 3, 0.05), ((64,), 4, 0.1))),
    "xla_delegated_attention_causal": ("""func @entry(%q: tensor<2x128x128xf32>, %k: tensor<2x128x128xf32>, %v: tensor<2x128x128xf32>) {
  %a = tl.attention %q, %k, %v {scale = 0.0883883, heads = 2, causal = true} : tensor<2x128x128xf32>
  return %a : tensor<2x128x128xf32>
}
""", (((2, 128, 128), 0, 1.0), ((2, 128, 128), 1, 1.0),
      ((2, 128, 128), 2, 1.0))),
    "fold_residual_keeps_returned_intermediate": ("""func @entry(%x: tensor<64x128xf32>, %w: tensor<128x128xf32>, %b: tensor<128xf32>) {
  %0 = tl.constant {init = "zero", seed = 0} : tensor<64x128xf32>
  %1 = tl.matmul %x, %w, %0 : tensor<64x128xf32>
  %2 = tl.add %1, %b : tensor<64x128xf32>
  %3 = tl.add %2, %x : tensor<64x128xf32>
  return %2, %3 : tensor<64x128xf32>, tensor<64x128xf32>
}
""", _FC_INPUTS),
    "combine_keeps_returned_contraction": ("""func @entry(%x: tensor<64x128xf32>, %w: tensor<128x128xf32>, %b: tensor<128xf32>) {
  %0 = tl.constant {init = "zero", seed = 0} : tensor<64x128xf32>
  %1 = tl.matmul %x, %w, %0 : tensor<64x128xf32>
  %2 = tl.add %1, %b : tensor<64x128xf32>
  %3 = tl.relu %2 : tensor<64x128xf32>
  return %1, %3 : tensor<64x128xf32>, tensor<64x128xf32>
}
""", _FC_INPUTS),
    "combine_rejects_broadcast_up_binary": ("""func @entry(%x: tensor<1x64xf32>, %w: tensor<64x64xf32>, %r: tensor<32x64xf32>) {
  %0 = tl.constant {init = "zero", seed = 0} : tensor<1x64xf32>
  %1 = tl.matmul %x, %w, %0 : tensor<1x64xf32>
  %2 = tl.add %1, %r : tensor<32x64xf32>
  return %2 : tensor<32x64xf32>
}
""", (((1, 64), 0, 1.0), ((64, 64), 1, 0.05), ((32, 64), 2, 1.0))),
    "spatial_addend_not_classified_channel_bias": ("""func @entry(%x: tensor<2x14x14x64xf32>, %w: tensor<3x3x64x64xf32>, %r: tensor<12x64xf32>) {
  %0 = tl.constant {init = "zero", seed = 0} : tensor<2x12x12x64xf32>
  %1 = tl.conv2d_nhwc_hwcf %x, %w, %0 : tensor<2x12x12x64xf32>
  %2 = tl.add %1, %r : tensor<2x12x12x64xf32>
  return %2 : tensor<2x12x12x64xf32>
}
""", (((2, 14, 14, 64), 0, 1.0), ((3, 3, 64, 64), 1, 0.1),
      ((12, 64), 2, 1.0))),
    "attention_fusion_keeps_returned_softmax": ("""func @entry(%s: tensor<4x16x16xf32>, %v: tensor<4x16x32xf32>) {
  %0 = tl.softmax %s : tensor<4x16x16xf32>
  %1 = tl.constant {init = "zero", seed = 0} : tensor<4x16x32xf32>
  %2 = tl.batch_matmul %0, %v, %1 : tensor<4x16x32xf32>
  return %0, %2 : tensor<4x16x16xf32>, tensor<4x16x32xf32>
}
""", (((4, 16, 16), 0, 1.0), ((4, 16, 32), 1, 1.0))),
}


def fusion_module(name: str):
    """The port's module of FUSION_CASES[name], not yet lowered."""
    src, _ = FUSION_CASES[name]
    if isinstance(src, dict):
        from tpp_mlir_tpu_torch.models.transformer_block import \
            build_transformer_block
        return build_transformer_block(**src)
    from tpp_mlir_tpu_torch.ir import parse_module
    return parse_module(src)


def fusion_inputs(name: str, device="cuda") -> list:
    """FUSION_CASES[name]'s inputs, the JAX tests' `_rng` values."""
    from tpp_mlir_tpu_torch.runtime import tensor_init
    return [(tensor_init("rand", shape, "f32", seed=seed) * scale)
            .to(device) for shape, seed, scale in FUSION_CASES[name][1]]


FUZZ_S0, FUZZ_STEPS, FUZZ_K = 8, 6, 3


def fuzz_arches(base: dict, kv_heads: int) -> list:
    """(name, GptConfig, int8 weight bits or 0, paths) of each of the
    fuzzer's architectures on `base`, GQA with `kv_heads`, MoE with 4
    experts, top-2 and the grouped form's row block 8; paths are those the
    architecture supports (kv_packed has no extend; spec needs the stacked
    trunk)."""
    from tpp_mlir_tpu_torch.serving import GptConfig
    llama = GptConfig.llama
    moe = dict(n_experts=4, top_k=2, moe_group_bm=8)
    most = ("chunked", "slotted", "device")
    return [
        ("dense", GptConfig(**base), 0, (*most, "spec")),
        ("llama_gqa", llama(kv_heads=kv_heads, **base), 0, (*most, "spec")),
        ("moe_scan", GptConfig(**moe, **base), 0, (*most, "forms")),
        ("moe_grouped", GptConfig(**moe, moe_prefill_form="grouped",
                                  **base), 0,
         (*most, "forms")),
        ("quant_int8", GptConfig(**base), 8, (*most, "spec")),
        ("kv_int8", GptConfig(kv_quant="int8", **base), 0, most),
        ("kv_packed", GptConfig(kv_packed=True, decode_attn="pallas",
                                **base), 0, ("slotted", "device")),
        ("kv_packed_rope", llama(kv_packed=True, decode_attn="pallas",
                                 **base), 0, ("slotted", "device")),
        ("flash_prefill", GptConfig(flash_attn=True, **base), 0, most),
        ("flash_gqa", llama(kv_heads=kv_heads, flash_attn=True, **base), 0,
         most),
    ]


class _Tape:
    """Records the logits each greedy token of a path was taken from: the
    rows given to the engines' samplers, and the speculative prefill's and
    verify passes' logits. Patch the factories while a path is built and
    run (`with tape:`)."""

    def __init__(self):
        self.rows: list = []

    def __enter__(self):
        from tpp_mlir_tpu_torch.serving import (batching, engine,
                                                speculative)
        self._saved = [(m, n, getattr(m, n)) for m, n in (
            (engine, "make_sampler"), (batching, "make_sampler"),
            (speculative, "make_prefill"), (speculative, "make_extend"))]
        for m, n, real in self._saved:
            setattr(m, n, self._sampler(real) if n == "make_sampler"
                    else self._model(real, n))
        self.rows = []
        return self

    def __exit__(self, *exc):
        for m, n, real in self._saved:
            setattr(m, n, real)

    def _sampler(self, real):
        def factory(*a, **kw):
            sample = real(*a, **kw)

            def taped(logits, *args, **kwargs):
                self.rows.append(logits.detach().float().cpu())
                return sample(logits, *args, **kwargs)
            return taped
        return factory

    def _model(self, real, name):
        def factory(*a, **kw):
            fn = real(*a, **kw)

            def taped(*args):
                out = fn(*args)
                self.rows.append((name, args[-1].detach().cpu(),
                                  out[0].detach().float().cpu()))
                return out
            return taped
        return factory


def _slot0_rows(rows) -> list:
    """Our request's rows from an engine's sampler calls: its first token
    is the first one-row call (it is admitted or staged first), then slot
    0's row of each decode step over the two slots."""
    first = next(r for r in rows if r.shape[0] == 1)
    return [first[0]] + [r[0] for r in rows if r.shape[0] == 2]


def _spec_rows(rows) -> list:
    """The speculative path's rows: the prefill's last, then per round the
    verify pass's rows of the tokens it emitted (the accepted drafts, which
    equal its argmax, and its own token after them)."""
    out = []
    for name, tokens, logits in rows:
        if name == "make_prefill":
            out.append(logits[0, -1])
            continue
        tt = logits[0].argmax(-1)
        d = tokens[0, 1:].long()
        n = int((d == tt[:len(d)]).long().cumprod(0).sum())
        out.extend(logits[0, :n + 1])
    return out


class FuzzHarness:
    """One architecture's serving paths on the port's engine. `run(seed,
    params)` returns {path: (tokens, rows)}: each path's STEPS greedy tokens
    of the seed's prompt and the logits row each was taken from (host f32),
    the oracle (make_generate) included. `use_kernels` as the engine takes
    it; the paths other than the oracle run eagerly (graph=False), so their
    launches count and their samplers can be taped."""

    def __init__(self, cfg, bits: int, paths, device, use_kernels=None):
        import dataclasses as dc
        from tpp_mlir_tpu_torch.serving import (make_decode_step,
                                                make_extend, make_prefill)
        self.cfg, self.bits, self.paths = cfg, bits, paths
        self.device, self.kernels = device, use_kernels
        self.prefill = make_prefill(cfg, use_kernels)
        self.step = make_decode_step(cfg, use_kernels)
        self.extend = make_extend(cfg, use_kernels) \
            if "chunked" in paths else None
        self.alt = dc.replace(cfg, moe_prefill_form=(
            "scan" if cfg.moe_prefill_form == "grouped" else "grouped")) \
            if "forms" in paths else None

    def params(self, seed: int) -> dict:
        from tpp_mlir_tpu_torch.serving import (init_params, quantize_params,
                                                stack_params)
        p = stack_params(init_params(self.cfg, seed=seed,
                                     device=self.device))
        return quantize_params(p, bits=self.bits) if self.bits else p

    def _generate(self, cfg, params, ids):
        from tpp_mlir_tpu_torch.serving import make_generate
        with _Tape() as tape:
            toks = make_generate(cfg, FUZZ_STEPS, use_kernels=self.kernels)(
                params, ids)
        return toks[0].tolist(), [r[0] for r in tape.rows]

    def run(self, seed: int, params=None) -> dict:
        import numpy as np
        import torch

        from tpp_mlir_tpu_torch.serving import (BatchingEngine,
                                                DeviceBatchingEngine,
                                                make_speculative_generate)
        params = self.params(seed) if params is None else params
        cfg, S0, dev = self.cfg, FUZZ_S0, self.device
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, cfg.vocab, (1, S0)).astype(np.int32)
        ids = torch.from_numpy(prompt).to(dev)
        out = {"oracle": self._generate(cfg, params, ids)}
        if "chunked" in self.paths:
            # 4-token chunks: prefill, then extend, then decode steps
            _, cache = self.prefill(params, ids[:, :4])
            logits, cache = self.extend(params, cache, ids[:, 4:])
            rows = [logits[0, -1]]
            for _ in range(FUZZ_STEPS - 1):
                tok = rows[-1].argmax(-1).to(torch.int32).reshape(1)
                logits, cache = self.step(params, cache, tok)
                rows.append(logits[0])
            rows = [r.detach().float().cpu() for r in rows]
            out["chunked"] = ([int(r.argmax()) for r in rows], rows)
        for path, engine, decoy_len, kw in (
                ("slotted", BatchingEngine, S0, dict(sync_steps=2)),
                ("device", DeviceBatchingEngine, S0 + 2,
                 dict(sync_steps=3, wave=1))):
            if path not in self.paths:
                continue
            # a decoy request shares the batch
            decoy = rng.integers(0, cfg.vocab, (decoy_len,)).astype(np.int32)
            with _Tape() as tape:
                eng = engine(params, cfg, slots=2, buckets=(S0, 2 * S0),
                             use_kernels=self.kernels, graph=False, **kw)
                rid = eng.submit(prompt[0], max_new=FUZZ_STEPS)
                eng.submit(decoy, max_new=FUZZ_STEPS)
                toks = eng.run()[rid]
            out[path] = (toks, _slot0_rows(tape.rows)[:FUZZ_STEPS])
        if "spec" in self.paths:
            with _Tape() as tape:
                spec = make_speculative_generate(
                    cfg, None, steps=FUZZ_STEPS, k=FUZZ_K,
                    use_kernels=self.kernels, trunk_layers=1, graph=False)
                toks, _ = spec(params, ids)
            out["spec"] = (toks[0].tolist(),
                           _spec_rows(tape.rows)[:FUZZ_STEPS])
        if self.alt is not None:
            out["forms"] = self._generate(self.alt, params, ids)
        return out


def fuzz_compare(runs: dict, seed: int, exempt: bool, tol: float) -> dict:
    """Each path of `runs` (FuzzHarness.run) against the oracle, step by
    step: its logits within `tol` of the oracle's max |logit|, and the same
    token; or,
    where `exempt`, a near tie: the oracle's top-2 logit gap at that step
    below the path's max |delta logits| against the oracle there. After an
    exempted step the streams follow different tokens: the rest is not
    compared. Raises AssertionError naming the path and seed; returns
    {path: (steps compared, exemptions, worst |delta logits|, notes)}."""
    btoks, brows = runs["oracle"]
    out = {}
    for path, (toks, rows) in runs.items():
        if len(toks) != FUZZ_STEPS or len(rows) != FUZZ_STEPS or \
                toks != [int(r.argmax()) for r in rows]:
            raise AssertionError(f"{path}: {len(toks)} tokens, {len(rows)} "
                                 f"rows, not the tape's argmax (seed {seed})")
        if path == "oracle":
            continue
        steps, exempted, worst, notes = 0, 0, 0.0, []
        for t in range(FUZZ_STEPS):
            d = float((rows[t] - brows[t]).abs().max())
            limit = tol * float(brows[t].abs().max())
            worst = max(worst, d)
            steps += 1
            if d > limit:
                raise AssertionError(f"{path} logits moved (seed {seed}), "
                                     f"step {t}: max|dlogits| {d:.3e} > "
                                     f"{limit:.3e}")
            if toks[t] == btoks[t]:
                continue
            top = brows[t].topk(2).values
            gap = float(top[0] - top[1])
            note = f"step {t}: top-2 gap {gap:.3e}, max|dlogits| {d:.3e}"
            if not (exempt and gap < d):
                raise AssertionError(f"{path} diverged (seed {seed}), "
                                     f"{note}")
            exempted += 1
            notes.append(note)
            break
        out[path] = (steps, exempted, worst, notes)
    return out
