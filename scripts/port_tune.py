#!/usr/bin/env python3
"""Record the port's tuning table on one NVIDIA card and print what it
measured: tpp-tune (tpp_mlir_tpu_torch/tools/tpp_tune.py) over
  * the flagship (tpp-gen --batch=256 --layers=1024,1024,1024,1024 --bias
    --relu, bf16): its B3/B4 chain's panel rows x clusters;
  * fc 256x1024x1024 (+bias, relu) in f32 "default" and bf16: its GEMM
    key's tiles x k splits (B1);
  * GPT-2 small at B 2 x S 1024, bf16: its GEMM keys (QKV and fc1 with the
    LayerNorm prologue, out-projection and fc2 with the residual, the LM
    head). One layer is built: every layer has the same keys.
Each key's heuristic plan is re-timed beside the candidates in the same
process, from CUDA graphs; a winner above --min-gain is recorded with its
sweep and the card's name. The table is TPP_TUNING_PATH, or --table.

    python scripts/port_tune.py --table tpp_mlir_tpu_torch/utils/tuning.json \
        --out port_tune.json

The last line of stdout is the summary as JSON (the card's nvidia-smi name
and power limit, and each key's heuristic and best plan with their times).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ("--batch=256 --layers=1024,1024,1024,1024 --bias --relu "
            "--float-type=bf16")
FC = "--batch=256 --layers=1024,1024 --bias --relu"
GPT2 = ('gpt:{"batch": 2, "seq": 1024, "vocab": 50304, "embed": 768, '
        '"heads": 12, "layers": 1, "dtype": "bf16"}')


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--table", default="",
                   help="the tuning table to write (default: "
                        "TPP_TUNING_PATH or the package's)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--min-gain", type=float, default=3.0)
    p.add_argument("--out", default="", help="also write the summary here")
    args = p.parse_args(argv)
    if args.table:
        os.environ["TPP_TUNING_PATH"] = os.path.abspath(args.table)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("port_tune.py measures on an NVIDIA card")
    from tpp_mlir_tpu_torch.tools import tpp_tune

    card = _card()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as d:
        cfg = os.path.join(d, "gpt2.json")
        with open(cfg, "w") as f:
            json.dump({"benchmarks": [{"name": "gpt2_small_b2_s1024_bf16",
                                       "model": GPT2}]}, f)
        runs = [("flagship bf16", ["--gen", FLAGSHIP]),
                ("fc f32 default", ["--gen", FC, "--key", "BrgemmKey"]),
                ("fc bf16", ["--gen", FC + " --float-type=bf16", "--key",
                             "BrgemmKey"]),
                ("gpt2 small b2 s1024 bf16", ["-c", cfg])]
        keys = []
        for label, argv_ in runs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                tpp_tune.main([*argv_, "--iters", str(args.iters),
                               "--min-gain", str(args.min_gain)])
            out = json.loads(buf.getvalue().strip().splitlines()[-1])
            for k in out["keys"]:
                keys.append({"program": label, **k})
                print(f"{label}: {k['tag']}\n  heuristic {k['heuristic']} "
                      f"{k['heuristic_ms']:.5f} ms; best {k['best']} "
                      f"{k['best_ms']:.5f} ms "
                      f"({k['heuristic_ms'] / k['best_ms']:.3f}x); "
                      f"{'recorded' if k['recorded'] else 'not recorded'} "
                      f"[{card}]", flush=True)
    summary = {"card": card, "device_kind": torch.cuda.get_device_name(),
               "min_gain": args.min_gain, "iters": args.iters,
               "table": os.environ.get("TPP_TUNING_PATH", ""), "keys": keys}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
