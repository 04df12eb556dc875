#!/usr/bin/env python
"""tpp-serve on the port: autoregressive generation over the serving engine.

Runs prefill + KV-cache decode for a GPT-family model, random-initialized
at the requested size from --seed, on one NVIDIA card (or the CPU with
--device cpu, where the kernels' plain versions run), and prints the
prefill time, the decode time per step, tokens/s, then the tokens. The
counterpart of `tpp_mlir_tpu/tools/tpp_serve.py` with its modes: greedy or
sampled generation, `--beams` (beam search), `--speculative K` (a draft
model, or with `--trunk-draft N` the target's first N blocks, proposes K
tokens a round) and `--continuous N` (N requests through --batch slots,
host scheduler, or `--device-scheduler`) and `--tp N` (the
tensor-parallel decode, run under torchrun with N ranks: the prefill
unsharded, then the decode on each rank's shards, greedy; rank 0 prints).
The prompt ids are drawn exactly as there, so the prompts are the same.

  python -m tpp_mlir_tpu_torch.tools.tpp_serve --steps 32      # GPT-2 small
  python -m tpp_mlir_tpu_torch.tools.tpp_serve --vocab 96 --embed 64 \\
      --heads 4 --layers 2 --max-seq 24 --prompt-len 6 --steps 5 \\
      --dtype f32 --device cpu
  python -m tpp_mlir_tpu_torch.tools.tpp_serve --experts 8 \\
      --moe-prefill sorted --batch 8 --prompt-len 512 --max-seq 640 \\
      --steps 32                                     # GPT-2 small MoE-8
  python -m tpp_mlir_tpu_torch.tools.tpp_serve --continuous 24 --batch 8 \\
      --prompt-len 512 --steps 64 --max-seq 1024 --device-scheduler \\
      --sync-steps 64                                # device scheduler
  python -m tpp_mlir_tpu_torch.tools.tpp_serve --speculative 4 \\
      --trunk-draft 2 --prompt-len 512 --steps 64 --max-seq 1024
  python -m torch.distributed.run --nproc-per-node 2 \\
      -m tpp_mlir_tpu_torch.tools.tpp_serve --tp 2 --vocab 96 --embed 64 \\
      --heads 4 --layers 2 --max-seq 24 --prompt-len 6 --steps 5 \\
      --dtype f32 --device cpu                      # a gloo world of 2

Times are host clocks around work that ends in a device synchronize; the
prefill (with the first sample), the decode time per step and tokens/s
exclude the kernel build and the CUDA-graph capture, which a first pass and
the capture pay (`serve`). Beam search, speculative decoding and continuous
batching run twice too and time the second pass whole (beam and speculative
recapture their loop's graph each call; a continuous engine keeps its
graphs across runs).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=(
        argparse.RawDescriptionHelpFormatter))
    p.add_argument("--vocab", type=int, default=50304)
    p.add_argument("--embed", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="GQA: KV heads < query heads (0 = MHA)")
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--mlp-ratio", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--dtype", default="bf16", choices=("f32", "bf16"))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quant", choices=["int8", "int4"], default="",
                   help="weight-only quantization of the matmul weights and "
                        "LM head, per-output-channel scales (int4: two "
                        "values a byte)")
    p.add_argument("--kv-quant", choices=["int8"], default="")
    p.add_argument("--llama", action="store_true",
                   help="RoPE + RMSNorm + SwiGLU (with --kv-heads for GQA)")
    p.add_argument("--experts", type=int, default=0,
                   help="MoE: experts per block (0 = dense)")
    p.add_argument("--top-k-experts", type=int, default=2,
                   help="experts per token (with --experts)")
    p.add_argument("--moe-prefill", choices=["scan", "sorted"],
                   default="scan",
                   help="MoE prefill FFN form: exact scan over the experts "
                        "or GShard sorted dispatch (capacity-bounded); the "
                        "grouped form is GptConfig(moe_prefill_form="
                        "'grouped')")
    p.add_argument("--beams", type=int, default=1,
                   help="beam-search width (>1 enables beam decoding; "
                        "deterministic, ignores sampling flags)")
    p.add_argument("--length-penalty", type=float, default=0.0,
                   help="GNMT length norm exponent for beam search")
    p.add_argument("--eos", type=int, default=-1,
                   help="EOS token id for beam search (-1 = none)")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="speculative decoding: draft K tokens a round, "
                        "verify them in one target pass (greedy, batch 1)")
    p.add_argument("--draft-layers", type=int, default=2,
                   help="layer count of the random draft model (with "
                        "--speculative)")
    p.add_argument("--trunk-draft", type=int, default=0, metavar="N",
                   help="with --speculative: the draft is the target's "
                        "first N blocks + its head (no draft params, no "
                        "draft prefill); overrides --draft-layers")
    p.add_argument("--draft-vocab", type=int, default=0,
                   help="truncate the draft lm_head to this vocab prefix "
                        "(0 = full)")
    p.add_argument("--continuous", type=int, default=0, metavar="N",
                   help="continuous batching: serve N queued requests "
                        "(random prompt lengths <= --prompt-len) through "
                        "--batch slots")
    p.add_argument("--sync-steps", type=int, default=8,
                   help="decode steps per host read in --continuous mode")
    p.add_argument("--device-scheduler", action="store_true",
                   help="with --continuous: admission on the device "
                        "(staged batched prefill, retire/admit/decode in "
                        "one replayed macro)")
    p.add_argument("--wave", type=int, default=16,
                   help="device-scheduler staging rows (KV memory knob)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel decode over N ranks (run under "
                        "torchrun; nccl on CUDA, gloo on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no CPU fallback) or cpu")
    return p


def main(argv=None, out=sys.stdout) -> int:
    args = build_parser().parse_args(argv)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is false); "
              "pass --device cpu to run the plain versions",
              file=sys.stderr)
        return 1
    slack = args.speculative + 1 if args.speculative else 0
    if args.prompt_len + args.steps + slack > args.max_seq:
        print(f"prompt+steps ({args.prompt_len}+{args.steps}"
              f"{f'+{slack} speculative slack' if slack else ''}) exceeds "
              f"--max-seq {args.max_seq}", file=sys.stderr)
        return 2
    if args.speculative and args.batch != 1:
        print("--speculative serves the batch-1 latency path",
              file=sys.stderr)
        return 2
    if args.tp:
        from tpp_mlir_tpu_torch.parallel.mesh import join_world
        try:
            dev, out = join_world(dev, {"tp": args.tp})
        except ValueError as e:     # more ranks than torchrun started
            print(e, file=sys.stderr)
            return 2
    try:
        cfg, params, ids = setup(dict(
            vocab=args.vocab, embed=args.embed, heads=args.heads,
            layers=args.layers, mlp_ratio=args.mlp_ratio,
            max_seq=args.max_seq, dtype=args.dtype,
            kv_heads=args.kv_heads or None, kv_quant=args.kv_quant or None,
            n_experts=args.experts, top_k=args.top_k_experts,
            moe_prefill_form=args.moe_prefill, batch=args.batch,
            prompt=args.prompt_len, seed=args.seed, llama=args.llama,
            quant=int(args.quant[3:]) if args.quant else 0), dev)
    except ValueError as e:         # a configuration GptConfig refuses
        print(e, file=sys.stderr)
        return 2
    try:
        if args.speculative:
            return _speculative(args, cfg, params, ids, out)
        if args.continuous:
            return _continuous(args, cfg, params, ids.device, out)
        if args.tp:
            return _tp(args, cfg, params, ids, out)
        if args.beams > 1:
            return _beams(args, cfg, params, ids, out)
    except ValueError as e:         # a mode's own refusal (sizes, vocab)
        print(e, file=sys.stderr)
        return 2
    res = serve(cfg, params, ids, args.steps, args.temperature, args.top_k,
                args.top_p, args.seed)
    B, steps = args.batch, args.steps
    print(f"# prefill {B}x{args.prompt_len}: {res['prefill_ms']:.4f} ms; "
          f"decode {res['decode_ms']:.4f} ms/step; "
          f"{B * steps / res['seconds']:,.1f} tok/s over {steps} steps x "
          f"batch {B} ({dev}, capture and build excluded)", file=out)
    for row in res["tokens"].tolist():
        print(" ".join(str(t) for t in row), file=out)
    return 0


def _timed(fn, dev):
    """fn() twice (the first builds the kernels); (the second's result,
    its seconds)."""
    import torch
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def _speculative(args, cfg, params, ids, out) -> int:
    from tpp_mlir_tpu_torch.serving import (GptConfig, init_params,
                                            make_speculative_generate)
    k = args.speculative
    if args.trunk_draft:
        gen = make_speculative_generate(cfg, None, args.steps, k=k,
                                        draft_vocab=args.draft_vocab,
                                        trunk_layers=args.trunk_draft)
        run = lambda: gen(params, ids)      # noqa: E731
    else:
        # the JAX tool's draft: a GPT-2-style model of --draft-layers
        dcfg = GptConfig(vocab=cfg.vocab, embed=cfg.embed, heads=cfg.heads,
                         layers=args.draft_layers, mlp_ratio=cfg.mlp_ratio,
                         max_seq=cfg.max_seq, dtype=cfg.dtype,
                         kv_heads=cfg.kv_heads, kv_quant=cfg.kv_quant)
        draft = init_params(dcfg, seed=args.seed + 1, device=ids.device)
        gen = make_speculative_generate(cfg, dcfg, args.steps, k=k,
                                        draft_vocab=args.draft_vocab)
        run = lambda: gen(params, draft, ids)   # noqa: E731
    (toks, stats), dt = _timed(run, ids.device)
    acc, drafted = int(stats["accepted"]), int(stats["drafted"])
    print(f"# speculative K={k}: {args.steps} tokens in {dt:.4f} s "
          f"({args.steps / dt:,.1f} tok/s, second pass); "
          f"{int(stats['macro_steps'])} rounds, acceptance {acc}/{drafted} "
          f"({100 * acc / max(drafted, 1):.0f}%) ({ids.device})", file=out)
    for row in toks.tolist():
        print(" ".join(str(t) for t in row), file=out)
    return 0


def continuous_prompts(vocab: int, prompt_len: int, n: int, seed: int):
    """The JAX tool's --continuous trace: n prompts of lengths drawn from
    [1, prompt_len], ids from [0, vocab), by default_rng(seed)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(m)).astype(np.int32)
            for m in rng.integers(1, prompt_len + 1, n)]


def _continuous(args, cfg, params, dev, out) -> int:
    from tpp_mlir_tpu_torch.serving import (BatchingEngine,
                                            DeviceBatchingEngine)
    prompts = continuous_prompts(cfg.vocab, args.prompt_len,
                                 args.continuous, args.seed)
    kw = dict(slots=args.batch, sync_steps=args.sync_steps,
              temperature=args.temperature, top_k=args.top_k,
              top_p=args.top_p, seed=args.seed)
    if args.device_scheduler:
        eng = DeviceBatchingEngine(params, cfg, wave=args.wave, **kw)
    else:
        eng = BatchingEngine(params, cfg, **kw)

    def run():
        eng.reset()
        rids = [eng.submit(p, max_new=args.steps) for p in prompts]
        return rids, eng.run()
    (rids, done), dt = _timed(run, dev)
    total = sum(len(v) for v in done.values())
    sched = "device" if args.device_scheduler else "host"
    print(f"# continuous: {args.continuous} requests through {args.batch} "
          f"slots, sync every {args.sync_steps} steps ({sched} scheduler):"
          f" {total} tokens in {dt:.4f} s ({total / dt:,.1f} tok/s, second "
          f"pass) ({dev})", file=out)
    for i, rid in enumerate(rids):
        print(f"req {rid} ({len(prompts[i])}-token prompt): "
              + " ".join(str(t) for t in done[rid]), file=out)
    return 0


def _tp(args, cfg, params, ids, out) -> int:
    """The JAX tool's --tp: the unsharded prefill, then steps - 1 greedy
    tensor-parallel decode steps on this rank's shards, timed (a CUDA graph
    over an NCCL group, eager over a gloo one)."""
    import torch
    import torch.distributed as dist

    from tpp_mlir_tpu_torch.parallel.mesh import make_mesh, shard_tree
    from tpp_mlir_tpu_torch.serving import DecodeRunner, make_prefill
    from tpp_mlir_tpu_torch.serving.batching import tp_graph_default
    from tpp_mlir_tpu_torch.serving.engine import (decode_cache_specs,
                                                   decode_param_specs,
                                                   make_tp_decode_step)
    mesh = make_mesh({"tp": args.tp})
    quant = bool(args.quant)
    step = make_tp_decode_step(mesh, cfg)
    logits, cache = make_prefill(cfg)(params, ids)
    # the model's own continuation, comparable token for token with the
    # single-device modes
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    local = shard_tree(params, decode_param_specs(cfg, quantized=quant),
                       mesh)
    lcache = shard_tree(cache, decode_cache_specs(cfg), mesh)
    dev = ids.device
    graph = tp_graph_default(mesh.group("tp"), dev)
    run = DecodeRunner(step, local, lcache, tok, graph)
    toks = [tok]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        tok = run(tok).argmax(-1).to(torch.int32)
        toks.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"# tp={args.tp} decode ({dist.get_backend()}, "
          f"{'graph' if graph else 'eager'}): {args.steps - 1} steps in "
          f"{dt:.4f} s ({dt * 1e3 / max(args.steps - 1, 1):.4f} ms/step, "
          f"{dev})", file=out)
    for row in torch.stack(toks, 1).tolist():
        print(" ".join(str(t) for t in row), file=out)
    dist.destroy_process_group()
    return 0


def _beams(args, cfg, params, ids, out) -> int:
    from tpp_mlir_tpu_torch.serving import make_beam_generate
    gen = make_beam_generate(cfg, args.steps, beams=args.beams,
                             length_penalty=args.length_penalty,
                             eos_id=args.eos if args.eos >= 0 else None)
    (toks, scores), dt = _timed(lambda: gen(params, ids), ids.device)
    print(f"# beam search: width {args.beams}, {args.steps} steps x batch "
          f"{args.batch} in {dt:.4f} s (second pass); best scores "
          + " ".join(f"{float(s):.3f}" for s in scores.tolist())
          + f" ({ids.device})", file=out)
    for row in toks.tolist():
        print(" ".join(str(t) for t in row), file=out)
    return 0


def setup(spec: dict, device="cuda"):
    """(cfg, params, ids) on `device` from GptConfig fields plus batch,
    prompt, seed, llama (the LLaMA preset) and quant (the weights' bits,
    8 or 4; True is 8; 0 or False leaves them unquantized): the
    port's random weights from the seed, and the prompt ids drawn as the
    JAX tool draws them, default_rng(seed).integers(0, vocab, (B, P))."""
    import numpy as np
    import torch

    from tpp_mlir_tpu_torch.serving import (GptConfig, init_params,
                                            quantize_params, with_kmajor)

    spec = dict(spec)
    batch, prompt = spec.pop("batch", 8), spec.pop("prompt", 512)
    seed, quant = spec.pop("seed", 0), spec.pop("quant", False)
    cfg = (GptConfig.llama if spec.pop("llama", False) else GptConfig)(**spec)
    params = init_params(cfg, seed=seed, device=device)
    if quant:
        params = quantize_params(params, bits=8 if quant is True else quant)
    if cfg.int8_compute:
        params = with_kmajor(params)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt)).astype(np.int32)).to(device)
    return cfg, params, ids


def serve(cfg, params, ids, steps: int, temperature: float = 0.0,
          top_k: int = 0, top_p: float = 0.0, seed: int = 0) -> dict:
    """Generate `steps` tokens with `make_generate` (prefill, sample, then
    steps - 1 decode steps, replayed from one CUDA graph on the card)
    twice: the first pass builds the kernels, the second is timed at
    make_generate's phase marks, so its capture is left out. Returns tokens
    (B, steps), prefill_ms, decode_ms (per step) and seconds (prefill +
    decode)."""
    import torch

    from tpp_mlir_tpu_torch.serving import make_generate

    dev = ids.device
    generate = make_generate(cfg, steps, temperature, top_k=top_k,
                             top_p=top_p)
    gen = torch.Generator(device=dev)
    generate(params, ids, gen.manual_seed(seed))    # builds the kernels
    stamps = {}

    def mark(phase):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps[phase] = time.perf_counter()
    toks = generate(params, ids, gen.manual_seed(seed), mark)
    prefill_s = stamps["prefill"] - stamps["start"]
    decode_s = stamps["decode"] - stamps["capture"]
    return {"tokens": toks.cpu(), "prefill_ms": prefill_s * 1e3,
            "decode_ms": decode_s * 1e3 / max(steps - 1, 1),
            "seconds": prefill_s + decode_s}


if __name__ == "__main__":
    sys.exit(main())
