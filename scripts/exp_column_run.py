#!/usr/bin/env python3
"""The epilogue's column run that starts at n (ROADMAP queue C).

csrc/gemm_sm90.cuh `epilogue_rows` gives each thread one four-column run of
a tile's rows; where n is no multiple of the tile, the runs past n have no
column (n = clamp_run(nb - t, 4) is 0). Without ln_stats_out such a thread
returns at once; with it, it stays for the row's shuffles, and both row
loops skip its I/O (`|| n == 0`). This experiment asks whether that skip is
what keeps the ragged widths right: it runs the same checks on two builds,
  committed  the package as it is (its build directory), and
  noskip     a copy in a temporary directory with the `|| n == 0` of both
             loops removed, built there with nvcc,
each in a process of its own: the ragged widths of the LN-stats cases (n
136, 200, 3000) as a fused GEMM (+C, a full-width residual D, gelu) under
every tile and the splits 1, 2 and the most, and as an ln_stats_out
producer under every tile, each output against its plain version (max rel
of the whole output, and of each row's first four columns, where a run
that stored past n would land), and the producer's statistics against
those of its own output. Prints one JSON line per build.

    python scripts/exp_column_run.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SKIPS = ("if (!epi || p >= g.mb || n == 0) continue;",
         "if (p >= g.mb || n == 0) continue;")

CHECK = r"""
import json, sys
import torch
from tpp_mlir_tpu_torch.xsmm import BrgemmKey, build_kernel, reference, tune
from tpp_mlir_tpu_torch.xsmm.reference import ln_stats_out
g = torch.Generator(device="cuda").manual_seed(7)
DT = {"f32": torch.float32, "bf16": torch.bfloat16}

def rnd(shape, dt, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(DT[dt])

def rel(got, want):
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30)

out = {"build": sys.argv[1], "rows": []}
for dt, p in (("bf16", "default"), ("f32", "default"), ("f32", "highest")):
    for m, n, k in ((100, 136, 512), (200, 200, 256), (256, 3000, 768)):
        for stats in (False, True):
            key = BrgemmKey(1, m, n, k, dt, precision=p, beta0=stats,
                            binary_kind="add",
                            binary_bcast="bcast_col" if stats else "none",
                            unary_kind="gelu", ln_stats_out=stats)
            args = (rnd((1, m, k), dt), rnd((1, k, n), dt, k ** -0.5),
                    None if stats else rnd((m, n), dt),
                    rnd((n,) if stats else (m, n), dt, 0.1))
            want = reference.reference_kernel(key)(*args)
            want = want[0] if stats else want
            tiles, most = reference.legal_gemm_plans(key)
            worst = first = st = 0.0
            for bm, bn in tiles:
                for split in sorted({1, 2, most} & set(range(1, most + 1))):
                    with tune.trial(key, {"bm": bm, "bn": bn,
                                          "split": split}):
                        kern = build_kernel(key)
                    got = kern(*args)
                    if stats:
                        got, mu, var = got
                        own_mu, own_var = ln_stats_out(got)
                        st = max(st, rel(mu, own_mu), rel(var, own_var))
                    torch.cuda.synchronize()
                    worst = max(worst, rel(got, want))
                    first = max(first, rel(got[:, :4], want[:, :4]))
            out["rows"].append({"key": f"{m}x{n}x{k} {dt} {p}"
                                       f"{' ln_stats_out' if stats else ''}",
                                "max_rel": worst, "first_cols_rel": first,
                                "stats_rel": st})
print(json.dumps(out))
"""


def _run(build: str, pythonpath: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(pythonpath))
    proc = subprocess.run([sys.executable, "-c", CHECK, build],
                          cwd=pythonpath, env=env, capture_output=True,
                          text=True, timeout=1500)
    if proc.returncode:
        return {"build": build, "error": proc.stderr[-3000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    results = [_run("committed", ROOT)]
    with tempfile.TemporaryDirectory() as d:
        pkg = Path(d) / "tpp_mlir_tpu_torch"
        shutil.copytree(ROOT / "tpp_mlir_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        src = pkg / "csrc" / "gemm_sm90.cuh"
        text = src.read_text()
        for skip in SKIPS:
            if skip not in text:
                raise SystemExit(f"the skip {skip!r} is not in {src}")
            text = text.replace(skip, skip.replace(" || n == 0", ""))
        src.write_text(text)
        results.append(_run("noskip", Path(d)))
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if all("error" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
