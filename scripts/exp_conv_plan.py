"""Sweep csrc/conv.cu's tile and k split at the conv suite's keys.

Times the wgmma routes of B24 (conv3x3 c128/30 f32 "default" and bf16,
c256/16 f32) and B23 (c256/16 Cb 2, packed) under each (tile rows, tile
columns, k split) of 64 x 64, 64 x 128 and 128 x 128 with splits 1 and 2
(the tma route takes 64-row tiles only), from a CUDA graph, each held
against its plain version; reference.conv_plan's choice is named last
(scripts/port_decode_conv_times.py's keys and inputs).

    python scripts/exp_conv_plan.py

Needs an NVIDIA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import port_decode_conv_times as times  # noqa: E402

PLANS = ((64, 64, 1), (64, 64, 2), (64, 128, 1), (64, 128, 2),
         (128, 128, 1), (128, 128, 2))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    from tpp_mlir_tpu_torch.xsmm import (build_kernel, reference,
                                         reference_kernel)
    chosen = reference.conv_plan
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = times.conv_cases()
    for label, key in [cases[i] for i in (0, 2, 3, 7)]:
        args = times.conv_args(key, g)
        want = reference_kernel(key)(*args)
        tma = reference.conv_kernel_route(key) == "tma"
        res = []
        for plan in PLANS:
            if tma and plan[0] == 128:
                continue
            reference.conv_plan = lambda k_, p=plan: p
            kern = build_kernel(key)
            err = times.rel(kern(*args), want)
            res.append(f"{plan} {times.graph_ms(lambda: kern(*args)):.4f} "
                       f"(rel {err:.1e})")
        reference.conv_plan = chosen
        print(f"conv plan {label}: {'; '.join(res)}; conv_plan "
              f"{chosen(key)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
