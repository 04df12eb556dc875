"""Where csrc/warm_panel.cuh's time goes, and which plan it should take.

1. The plan sweep: the flagship chain (B4, 256 x 1024x4 f32, -n 100), B5
   (fc_128x768x2304, -n 100) and a resident one-layer chain shaped as B20's
   fc key (256 x 1024 -> 1024, -n 200) under forced (rows, cluster,
   resident) plans, each timed from a CUDA graph and held against its plain
   version; the card's cudaOccupancyMaxActiveClusters for each plan
   beside it (a plan with more clusters than that runs in waves).
2. A "timeline" build of the committed engine (csrc/chain.cu and an
   edited copy of csrc/warm_panel.cuh, built with nvcc into the
   git-ignored build directory) at each key's own plan: clock64 stamps of
   block 0's consumer thread 0 (the start, the products with the panel
   chunks' waits, products + epilogue, handing the staging to the sender
   warp), summed over the steps and written over the output's first
   elements (the output is then wrong). Its ptxas report is printed.

    python scripts/exp_warm_plan.py

Needs an NVIDIA card and nvcc; prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import port_warm_times as times  # noqa: E402

CSRC = ROOT / "tpp_mlir_tpu_torch" / "csrc"
OUT = ROOT / "tpp_mlir_tpu_torch" / "build" / "exp_warm_plan"

# (marker in csrc/warm_panel.cuh, what replaces it): clock64 stamps of
# block 0's consumer thread 0, summed over the steps and written over the
# output's first elements (an f32 output), in kilocycles: the start
# (barriers, weights, panel), products + epilogue, handing the staging to
# the sender, the whole kernel, the products alone
TIMELINE = [
    ("  const int grp = q / ppg, r0 = (q % ppg) * P;\n",
     "  const int grp = q / ppg, r0 = (q % ppg) * P;\n"
     "  const long long t_start = clock64();\n"),
    ("    uint64_t ph = 0;   // each panel chunk's barrier parity\n",
     "    uint64_t ph = 0;   // each panel chunk's barrier parity\n"
     "    long long tp = 0, tb = 0, tq = 0;\n"
     "    const long long t0s = clock64();\n"),
    ("      const bool last = g == p.total - 1;\n      unsigned char* staging",
     "      const bool last = g == p.total - 1;\n"
     "      const long long ta = clock64();\n      unsigned char* staging"),
    ("        float acc[P / 2];\n        uint64_t* lw",
     "        float acc[P / 2];\n        const long long tq0 = clock64();\n"
     "        uint64_t* lw"),
    ("        __syncwarp();\n        // the block's last products",
     "        __syncwarp();\n        tq += clock64() - tq0;\n"
     "        // the block's last products"),
    ("      if (nt == 0 && !last) {\n",
     "      const long long tb_ = clock64();\n      tp += tb_ - ta;\n"
     "      if (nt == 0 && !last) {\n"),
    ("      hw::bar_sync(2, WG + 32);\n    }\n  }\n",
     "      hw::bar_sync(2, WG + 32);\n      tb += clock64() - tb_;\n    }\n"
     "    if (blockIdx.x == 0 && tid == 0) {\n"
     "      float* o = static_cast<float*>(p.out);\n"
     "      o[0] = (t0s - t_start) * 1e-3f; o[1] = 0.f; o[2] = tp * 1e-3f;\n"
     "      o[3] = tb * 1e-3f; o[4] = 0.f;\n"
     "      o[5] = (clock64() - t_start) * 1e-3f; o[6] = tq * 1e-3f;\n"
     "    }\n  }\n"),
]
def timeline_library():
    """The committed chain.cu with TIMELINE's edits to warm_panel.cuh,
    compiled by nvcc into the build directory, without GNU unique symbols
    (so its once-only launch attributes are its own, not the package
    library's), and loaded: (library, ptxas lines of the engine's
    kernels)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from tpp_mlir_tpu_torch.xsmm.build import _SIGNATURES
    src = (CSRC / "warm_panel.cuh").read_text()
    for marker, text in TIMELINE:
        if src.count(marker) != 1:
            raise RuntimeError(f"marker not found once: {marker!r}")
        src = src.replace(marker, text)
    OUT.mkdir(parents=True, exist_ok=True)
    for f in ("chain.cu", "epilogue.cuh", "hopper.cuh"):
        shutil.copy(CSRC / f, OUT / f)
    (OUT / "warm_panel.cuh").write_text(src)
    (OUT / "error.cu").write_text(
        "#include <cuda_runtime.h>\n"
        "extern \"C\" const char* tpp_error_string(int err) {\n"
        "  return cudaGetErrorString(static_cast<cudaError_t>(err));\n}\n")
    so = OUT / "libchain.so"
    proc = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "nvcc"), "-gencode",
         "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-Xcompiler", "-fno-gnu-unique", "-Xptxas", "-v",
         "-shared", "-o", str(so), str(OUT / "chain.cu"),
         str(OUT / "error.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("tpp_chain", "tpp_warm_max_clusters", "tpp_error_string"):
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = \
            _SIGNATURES[fn]
    lines, fn = [], ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        if "warm_panel" in fn and ("registers" in line or "spill" in line):
            lines.append(f"{fn[-30:]}: {line.strip()}")
        elif "erialized" in line:
            lines.append(line.strip())
    return lib, lines


def keys():
    from tpp_mlir_tpu_torch.xsmm import ChainKey
    return [
        ("B4 flagship f32 -n 100",
         ChainKey(m=256, dims=(1024,) * 4, repeats=100),
         [(40, 16, False), (24, 8, False)]),
        ("B5 fc_128x768x2304 -n 100",
         ChainKey(m=128, dims=(768, 2304), repeats=100, pingpong=True),
         [(24, 12, False)]),
        ("B20-shaped 256 x 1024 -> 1024 resident -n 200",
         ChainKey(m=256, dims=(1024, 1024), repeats=200),
         [(40, 16, True), (40, 16, False)]),
    ]


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
    from tpp_mlir_tpu_torch.xsmm import build as xbuild
    from tpp_mlir_tpu_torch.xsmm import kernels, reference, reference_kernel
    xbuild.build()
    for smem in (60_000, 100_000, 140_000, 220_000):
        row = [f"C{c} {kernels.warm_max_clusters(32, c, smem)}"
               for c in range(1, 17)]
        print(f"occupancy at {smem} B: {', '.join(row)}", flush=True)
    timeline, lines = timeline_library()
    for line in lines:
        print(f"ptxas: {line}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    for label, key, plans in keys():
        args = times.chain_args(key, g)
        want = reference_kernel(key)(*args)
        res = []
        for rows, cluster, resident in plans:
            plan = reference.warm_plan(key, rows=rows, cluster=cluster,
                                       resident=resident)
            if plan is None:
                res.append(f"{(rows, cluster, resident)} does not fit")
                continue
            kern = kernels.build_warm(key, "panel", plan)
            err = times.rel(kern(*args), want)
            held = kernels.warm_max_clusters(rows, cluster, plan.smem)
            res.append(f"rows {rows} cluster {cluster} "
                       f"{'resident' if resident else 'streamed'}: "
                       f"{times.graph_ms(lambda: kern(*args), iters=3):.4f} "
                       f"ms ({plan.clusters} clusters, {held} at once; rel "
                       f"{err:.1e})")
        print(f"warm plan {label}: {'; '.join(res)}; warm_plan "
              f"{tuple(reference.warm_plan(key))[:4]}", flush=True)
        # the wrapper binds the library when it is built
        saved = xbuild.library
        xbuild.library = lambda: timeline
        try:
            plan = reference.warm_plan(key)
            kern = kernels.build_warm(key, "panel", plan)
            ms = times.graph_ms(lambda: kern(*args), iters=3)
            t = kern(*args).reshape(-1)[:7].tolist()
        finally:
            xbuild.library = saved
        steps = key.repeats * (1 if key.pingpong else len(key.dims) - 1)
        print(f"warm timeline {label} {tuple(plan)[:4]}: {ms:.4f} ms; "
              f"kilocycles: start {t[0]:.1f}, per step: products (the "
              f"chunks' waits in) {t[6] / steps:.2f}, products + epilogue "
              f"{t[2] / steps:.2f}, handing the staging to the sender "
              f"{t[3] / steps:.2f}; whole kernel {t[5]:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
