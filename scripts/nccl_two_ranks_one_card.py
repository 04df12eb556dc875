#!/usr/bin/env python3
"""Whether NCCL takes a world of two ranks on one CUDA device.

    python scripts/nccl_two_ranks_one_card.py

Starts two processes on cuda:0 joined over NCCL and all-reduces one tensor;
prints each rank's outcome (the sum, or the error NCCL raised) and the
card's name and power limit. chip_smoke.py's world of two ranks on one card
runs over gloo because of what this prints. Exits 0 whatever NCCL does;
a rank that hangs is stopped by the process-group timeout.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from datetime import timedelta


def _rank(rank: int, init_file: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"file://{init_file}",
                                rank=rank, world_size=2,
                                timeout=timedelta(seconds=60))
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        msg = f"ok: sum {x.tolist()}"
    except Exception as e:      # the outcome is the report, not a failure
        msg = f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write(msg)


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{torch.cuda.nccl.version()}, {torch.cuda.device_count()} card")
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_rank, args=(os.path.join(d, "rdzv"), d),
                                 nprocs=2, join=False, start_method="spawn")
        try:
            ctx.join(timeout=180)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        for r in range(2):
            path = os.path.join(d, f"rank{r}.txt")
            got = open(path).read() if os.path.exists(path) else \
                "no outcome (stopped)"
            print(f"nccl world of 2 on cuda:0, rank {r}: {got[:600]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
