"""Run one benchmark entry through the port: the tpp-run of builder models.

  python -m tpp_mlir_tpu_torch.tools.bench_driver \\
      --model 'gpt:{"batch": 2, "seq": 1024, "dtype": "bf16"}' -n 10
  python -m tpp_mlir_tpu_torch.tools.bench_driver \\
      --model 'transformer_block:{"heads": 8}' --device cpu
  python -m tpp_mlir_tpu_torch.tools.bench_driver --device cpu \\
      --model 'mha_full:{"batch": 1, "heads": 2, "seq": 128, "head_dim": 32}'
  python -m tpp_mlir_tpu_torch.tools.bench_driver --device cpu -n 1 \\
      --model 'convnet:{"batch": 2, "channels": 32, "filters": 32,
                        "height": 10, "width": 10, "layout": "nhwc"}'
  python -m tpp_mlir_tpu_torch.tools.bench_driver --device cpu -n 1 \\
      --pipeline default-tpp-passes-packed \\
      --model 'convnet:{"batch": 2, "channels": 16, "filters": 16,
                        "height": 8, "width": 8}'
  python -m tpp_mlir_tpu_torch.tools.bench_driver --device cpu -n 2 \\
      --file benchmarks/mlir/fp32-pack-gemm-operand-b-512x1024.mlir

An imported model (the torch-defined GPT, transformer block, ResNet block
and ViT of `models/`) keeps its weights in `module.literals`, which the IR
printer does not print, so it cannot go through IR text and tpp_run; this
driver builds it in process, and the MHA and conv suites' nets
(`benchmarks/configs/mha.json`, `conv.json`, `vit.json`) the same way.
`build_module(entry)` mirrors the reference's
`tpp_mlir_tpu/tools/bench_driver.py:29-71`: a `file` entry is an IR file
(the MHA suite's pack/unpack micro-kernels), its path relative to the
config's directory (`_dir`, which load_config sets, as the reference's
driver does at :262); a `gen` entry is tpp-gen's flags; a `model` entry
names one of the slice's builders, `"gpt:{json kwargs}"`,
`"transformer_block:{...}"`, `"mha_qk"`, `"mha_softmax_v"`,
`"mha_projection"`, `"mha_full"`, `"mha_block"`, `"convnet"`,
`"resnet_block"` and `"vit"`; each with an optional `precision`. An
entry's `iters` is its `-n`, its `pipeline` the pass pipeline that lowers
it (default-tpp-passes, or default-tpp-passes-packed for packed parity
mode; reference :112), and `bench_mode: "scan"` times the loop lowering, as
the reference's driver does (:131).

`main` lowers the module with the entry's pipeline, runs it once on
`--device` and, with `-n`, times `n` forwards by CUDA events. Its baseline is the same
module un-lowered (--linalg-to-loops: f32 cuBLAS GEMMs and attention
composed of PyTorch ops), in the role of the reference driver's XLA
baseline (:103-110).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .tpp_run import load_module, run_module


def _builders():
    from ..models import convnet, mha
    from ..models.gpt import build_gpt
    from ..models.resnet_block import build_resnet_block
    from ..models.transformer_block import build_transformer_block
    from ..models.vit import build_vit_block
    return {"gpt": build_gpt, "transformer_block": build_transformer_block,
            "mha_qk": mha.build_qk, "mha_softmax_v": mha.build_softmax_v,
            "mha_projection": mha.build_projection, "mha_full": mha.build_mha,
            "mha_block": mha.build_mha_block,
            "convnet": lambda **kw: convnet.build_convnet(
                convnet.ConvConfig(**kw)),
            "resnet_block": build_resnet_block,
            "vit": lambda **kw: build_vit_block(**kw)[0]}


def load_config(path: str) -> list[dict]:
    """A benchmark config's entries, each with `_dir`, the config's
    directory, against which a `file` entry's path resolves."""
    with open(path) as f:
        entries = json.load(f)["benchmarks"]
    base = os.path.dirname(os.path.abspath(path))
    return [{**e, "_dir": e.get("_dir", base)} for e in entries]


def build_module(entry: dict):
    """The Module of one benchmark entry: its `file`, `gen` or `model`."""
    if "file" in entry:
        path = os.path.join(entry.get("_dir", ""), entry["file"])
        with open(path) as f:
            module = load_module(f.read())
    elif "gen" in entry:
        from .mlir_gen import build_parser, config_from_args, generate_text
        module = load_module(generate_text(config_from_args(
            build_parser().parse_args(entry["gen"].split()))))
    elif "model" in entry:
        module = _build_model(entry["model"])
    else:
        raise ValueError(f"a benchmark entry needs 'file', 'gen' or "
                         f"'model': {entry}")
    if entry.get("precision"):
        module.attrs["precision"] = entry["precision"]
    return module


def _build_model(model: str):
    name, *rest = model.split(":", 1)
    builders = _builders()
    if name not in builders:
        raise NotImplementedError(
            f"model {name!r} is outside the port's slice (ROADMAP queue "
            f"A); the slice has {sorted(builders)}")
    return builders[name](**(json.loads(rest[0]) if rest else {}))


def tokens(module, func_name: str = "entry") -> int | None:
    """Tokens per forward of a token-id model (batch * seq), else None."""
    args = module[func_name].args
    if args and args[0].type.dtype == "i32":
        b, s = args[0].type.shape
        return b * s
    return None


def run_entry(entry: dict, n: int | None = None, device: str = "cuda",
              out_stream=None) -> dict:
    """Run the entry un-lowered (the baseline), then lowered with its
    `pipeline`, on one module; each run is tpp_run.run_module's result
    (outputs, and with n > 0 the mean and the bench lowering). n defaults
    to the entry's `iters` (0 without one)."""
    if n is None:
        n = entry.get("iters", 0)
    module = build_module(entry)
    out = {"tokens": tokens(module), "flops": module.attrs.get("flops")}
    for name, l2l in (("baseline", True), ("lowered", False)):
        out[name] = run_module(module, n=n, device=device,
                               pipeline=entry.get("pipeline",
                                                  "default-tpp-passes"),
                               linalg_to_loops=l2l, out_stream=out_stream,
                               bench_mode=entry.get("bench_mode", "auto"))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_driver (torch)",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--model",
                      help="'gpt:{json}', 'transformer_block:{json}', "
                           "'mha_{qk,softmax_v,projection,full,block}:"
                           "{json}', 'convnet:{json}', 'resnet_block:{json}' "
                           "or 'vit:{json}'")
    what.add_argument("--file", help="an IR file (e.g. benchmarks/mlir/"
                                     "*.mlir)")
    p.add_argument("--pipeline", default="default-tpp-passes",
                   help="default-tpp-passes, or default-tpp-passes-packed "
                        "(packed parity mode)")
    p.add_argument("-n", type=int, default=0, help="timed forwards")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no CPU fallback)")
    p.add_argument("--bench-mode", choices=["auto", "scan"], default="auto",
                   help="scan: time the loop lowering, never an in-kernel "
                        "bench")
    args = p.parse_args(argv)
    entry = {k: getattr(args, k) for k in ("model", "file")
             if getattr(args, k)}
    entry.update(pipeline=args.pipeline, bench_mode=args.bench_mode)
    res = run_entry(entry, n=args.n, device=args.device,
                    out_stream=sys.stderr)
    low = res["lowered"]
    got = low["outputs"][0]
    want = res["baseline"]["outputs"][0].float()
    rel = float((got.float() - want).abs().max()
                / want.abs().max().clamp_min(1e-30))
    line = (f"{next(iter(entry.values()))}: output {tuple(got.shape)} "
            f"{str(got.dtype).replace('torch.', '')} finite "
            f"{bool(torch.isfinite(got.float()).all())}, max rel err vs "
            f"--linalg-to-loops {rel:.3e}")
    if args.n:
        ms = low["mean_seconds"] * 1e3
        base = res["baseline"]["mean_seconds"] * 1e3
        line += f"; forward {ms:.4f} ms"
        if res["tokens"]:
            line += f", {res['tokens'] / low['mean_seconds']:.1f} tokens/s"
        line += (f" ({low['bench']}); --linalg-to-loops {base:.4f} ms "
                 f"({base / ms:.3f}x)")
    print(f"{line} on {low['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
