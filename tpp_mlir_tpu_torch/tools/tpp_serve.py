#!/usr/bin/env python
"""tpp-serve on the port: autoregressive generation over the serving engine.

Runs prefill + KV-cache decode for a GPT-family model, random-initialized
at the requested size from --seed, on one NVIDIA card (or the CPU with
--device cpu, where the kernels' plain versions run), and prints the
prefill time, the decode time per step, tokens/s, then the tokens. The
counterpart of `tpp_mlir_tpu/tools/tpp_serve.py`'s generate path; the
prompt ids are drawn exactly as there, so the prompts are the same.

  python -m tpp_mlir_tpu_torch.tools.tpp_serve --steps 32      # GPT-2 small
  python -m tpp_mlir_tpu_torch.tools.tpp_serve --vocab 96 --embed 64 \\
      --heads 4 --layers 2 --max-seq 24 --prompt-len 6 --steps 5 \\
      --dtype f32 --device cpu
  python -m tpp_mlir_tpu_torch.tools.tpp_serve --experts 8 \\
      --moe-prefill sorted --batch 8 --prompt-len 512 --max-seq 640 \\
      --steps 32                                     # GPT-2 small MoE-8

Times are host clocks around work that ends in a device synchronize; the
prefill (with the first sample), the decode time per step and tokens/s
exclude the kernel build and the CUDA-graph capture, which a first pass and
the capture pay (`serve`).
"""

from __future__ import annotations

import argparse
import sys
import time

# modes of the JAX tool that are not ported yet, and their ROADMAP items
_LATER = {"speculative": "A8", "continuous": "A8", "beams": "A8",
          "tp": "A11"}


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
                   help="weight quantization (int4: not ported, ROADMAP A7)")
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no CPU fallback) or cpu")
    for flag, item in _LATER.items():
        p.add_argument(f"--{flag}", type=int, default=0,
                       help=f"not ported yet (ROADMAP {item})")
    return p


def main(argv=None, out=sys.stdout) -> int:
    args = build_parser().parse_args(argv)
    for flag, item in _LATER.items():
        if getattr(args, flag) > (1 if flag == "beams" else 0):
            print(f"--{flag} is not ported yet: ROADMAP {item}",
                  file=sys.stderr)
            return 2
    import torch

    from tpp_mlir_tpu_torch.serving.quant import INT4_TODO

    if args.quant == "int4":
        print(INT4_TODO, file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is false); "
              "pass --device cpu to run the plain versions",
              file=sys.stderr)
        return 1
    if args.prompt_len + args.steps > args.max_seq:
        print(f"prompt+steps ({args.prompt_len}+{args.steps}) exceeds "
              f"--max-seq {args.max_seq}", file=sys.stderr)
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
            quant=bool(args.quant)), dev)
    except ValueError as e:         # a configuration GptConfig refuses
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


def setup(spec: dict, device="cuda"):
    """(cfg, params, ids) on `device` from GptConfig fields plus batch,
    prompt, seed, llama (the LLaMA preset) and quant (int8 weights): the
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
        params = quantize_params(params)
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
