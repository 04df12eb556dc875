"""Run one benchmark entry through the port: the tpp-run of builder models.

  python -m tpp_mlir_tpu_torch.tools.bench_driver \\
      --model 'gpt:{"batch": 2, "seq": 1024, "dtype": "bf16"}' -n 10
  python -m tpp_mlir_tpu_torch.tools.bench_driver \\
      --model 'transformer_block:{"heads": 8}' --device cpu
  python -m tpp_mlir_tpu_torch.tools.bench_driver --device cpu \\
      --model 'mha_full:{"batch": 1, "heads": 2, "seq": 128, "head_dim": 32}'

An imported model (the torch-defined GPT and transformer block of
`models/`) keeps its weights in `module.literals`, which the IR
printer does not print, so it cannot go through IR text and tpp_run; this
driver builds it in process, and the MHA suite's pieces
(`benchmarks/configs/mha.json`) the same way. `build_module(entry)` mirrors
the reference's `tpp_mlir_tpu/tools/bench_driver.py:29-71` for the `model`
entries of the slice, `"gpt:{json kwargs}"`, `"transformer_block:{...}"`
and `"mha_qk"`, `"mha_softmax_v"`, `"mha_projection"`, `"mha_full"`,
`"mha_block"`, with an optional `precision`; tpp-gen modules go through
tools/tpp_run. An entry's `bench_mode: "scan"` times the loop lowering, as
the reference's driver does (:131).

`main` lowers the module with default-tpp-passes, runs it once on `--device`
and, with `-n`, times `n` forwards by CUDA events. Its baseline is the same
module un-lowered (--linalg-to-loops: f32 cuBLAS GEMMs and attention
composed of PyTorch ops), in the role of the reference driver's XLA
baseline (:103-110).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .tpp_run import run_module


def _builders():
    from ..models import mha
    from ..models.gpt import build_gpt
    from ..models.transformer_block import build_transformer_block
    return {"gpt": build_gpt, "transformer_block": build_transformer_block,
            "mha_qk": mha.build_qk, "mha_softmax_v": mha.build_softmax_v,
            "mha_projection": mha.build_projection, "mha_full": mha.build_mha,
            "mha_block": mha.build_mha_block}


def build_module(entry: dict):
    """The Module of one benchmark entry's `model`."""
    name, *rest = entry["model"].split(":", 1)
    builders = _builders()
    if name not in builders:
        raise NotImplementedError(
            f"model {name!r} is outside the port's slice (ROADMAP queue A6, "
            f"A13); the slice has {sorted(builders)}")
    module = builders[name](**(json.loads(rest[0]) if rest else {}))
    if entry.get("precision"):
        module.attrs["precision"] = entry["precision"]
    return module


def tokens(module, func_name: str = "entry") -> int | None:
    """Tokens per forward of a token-id model (batch * seq), else None."""
    args = module[func_name].args
    if args and args[0].type.dtype == "i32":
        b, s = args[0].type.shape
        return b * s
    return None


def run_entry(entry: dict, n: int = 0, device: str = "cuda",
              out_stream=None) -> dict:
    """Run the entry un-lowered (the baseline), then lowered, on one
    module; each run is tpp_run.run_module's result (outputs, and with
    n > 0 the mean and the bench lowering)."""
    module = build_module(entry)
    out = {"tokens": tokens(module), "flops": module.attrs.get("flops")}
    for name, l2l in (("baseline", True), ("lowered", False)):
        out[name] = run_module(module, n=n, device=device,
                               linalg_to_loops=l2l, out_stream=out_stream,
                               bench_mode=entry.get("bench_mode", "auto"))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_driver (torch)",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", required=True,
                   help="'gpt:{json}', 'transformer_block:{json}' or "
                        "'mha_{qk,softmax_v,projection,full,block}:{json}'")
    p.add_argument("-n", type=int, default=0, help="timed forwards")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no CPU fallback)")
    p.add_argument("--bench-mode", choices=["auto", "scan"], default="auto",
                   help="scan: time the loop lowering, never an in-kernel "
                        "bench")
    args = p.parse_args(argv)
    res = run_entry({"model": args.model, "bench_mode": args.bench_mode},
                    n=args.n, device=args.device, out_stream=sys.stderr)
    low = res["lowered"]
    got = low["outputs"][0]
    want = res["baseline"]["outputs"][0].float()
    rel = float((got.float() - want).abs().max()
                / want.abs().max().clamp_min(1e-30))
    line = (f"{args.model}: output {tuple(got.shape)} "
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
