"""Time the training attention (B14: attention.cu's training mode; B18:
flash_train.cu's two wgmma passes) in f16 and bf16 at GPT-2 small's
training key, this checkout's sources beside other checkouts', and count
each training kernel's SASS instructions by opcode.

    python scripts/exp_train_f16.py --repo NAME=PATH [--repo ...]

Compiles attention.cu and flash_train.cu of each checkout with nvcc (one
process a checkout, all in parallel) into libraries of their own under
tpp_mlir_tpu_torch/build/, loads them with ctypes and calls
tpp_flash_train_fwd and tpp_flash_train_bwd directly at b8 s512 h12 d64
causal (scale 1/8) on seeded inputs, each checkout and dtype from a CUDA
graph of 20 launches, in turns (other, this, this, other); each other
checkout's outputs are compared with this one's (bit-equal, or the max
abs difference). A source that refuses a dtype (cudaErrorInvalidValue)
is reported as such. Needs an NVIDIA card and nvcc; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

B, S, H, D, ITERS = 8, 512, 12, 64, 20
SCALE, LOG2E = 0.125, 1.4426950408889634
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the training kernels' mangled names: attention.cu's TRAIN instantiations
# and flash_train.cu's two passes
TRAINING = re.compile(r"attention_kernel\w*Lb1E|bwd_(kv|q)_wgmma_kernel")


def build(repo: Path, name: str) -> subprocess.Popen:
    from tpp_mlir_tpu_torch.xsmm.build import BUILD_DIR, NVCC_FLAGS, _nvcc
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    csrc = repo / "tpp_mlir_tpu_torch" / "csrc"
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o",
         str(BUILD_DIR / f"{name}.so"), str(csrc / "attention.cu"),
         str(csrc / "flash_train.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.tpp_flash_train_fwd.restype = _I
    lib.tpp_flash_train_fwd.argtypes = [_P] * 5 + [_I] * 6 + [_F, _I, _P]
    lib.tpp_flash_train_bwd.restype = _I
    lib.tpp_flash_train_bwd.argtypes = [_P] * 9 + [_I] * 6 + [_F, _F, _I,
                                                              _P]
    return lib


def sass_counts(path: Path) -> dict:
    """{kernel: Counter of opcodes} of the training kernels."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                          "-sass", str(path)], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1) if TRAINING.search(head.group(1)) else None
            if name:
                counts[name] = collections.Counter()
            continue
        op = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if name and op:
            counts[name][op.group(1).split(".")[0]] += 1
    return counts


def graph_ms(fn) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * ITERS)


def calls(lib, dt, g):
    """(B14 launch, B18 launch, outputs) on seeded (B, S, H, D) operands of
    dtype dt; B18 reads lse2 and delta = rowsum(dO O) from a B14 run."""
    import torch
    code = {torch.bfloat16: 1, torch.float16: 2}[dt]
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .to(dt) for _ in range(4))
    o = torch.empty(B, S, H, D, dtype=torch.bfloat16, device="cuda")
    lse2 = torch.empty(B, H, S, device="cuda")
    grads = [torch.empty_like(o) for _ in range(3)]
    stream = lambda: ctypes.c_void_p(  # noqa: E731
        torch.cuda.current_stream().cuda_stream)

    def b14():
        return lib.tpp_flash_train_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse2.data_ptr(), B, S, H, D, code, 1, SCALE * LOG2E, 1,
            stream())
    rc = b14()
    torch.cuda.synchronize()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()

    def b18():
        return lib.tpp_flash_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in grads), B, S, H, D, code, 1,
            SCALE * LOG2E, SCALE, 1, stream())
    return rc, b14, b18, [o, lse2, *grads]


def main() -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", action="append", default=[], required=True,
                   help="NAME=PATH of another checkout (repeatable)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    from tpp_mlir_tpu_torch.xsmm.build import BUILD_DIR
    repos = {"this": ROOT}
    for spec in args.repo:
        name, _, path = spec.partition("=")
        repos[name] = Path(path).resolve()
    procs = {name: build(repo, f"exp_train_{name}")
             for name, repo in repos.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"nvcc {name} failed:\n{log}", flush=True)
            return 1
        path = BUILD_DIR / f"exp_train_{name}.so"
        libs[name] = load(path)
        for fn, ops in sass_counts(path).items():
            top = ", ".join(f"{o} {c}" for o, c in ops.most_common(16))
            print(f"{name} sass {fn}: {sum(ops.values())} instructions; "
                  f"{top}", flush=True)
    for dt in (torch.bfloat16, torch.float16):
        runs, outs = {}, {}
        for name, lib in libs.items():
            rc, b14, b18, res = calls(lib, dt, torch.Generator(
                device="cuda").manual_seed(7))
            rc = (rc, b18())
            torch.cuda.synchronize()
            if any(rc):
                print(f"{name} {str(dt)[6:]}: refused (rc {rc})", flush=True)
                continue
            runs[name], outs[name] = (b14, b18), res
        for other in (n for n in runs if n != "this" and "this" in runs):
            ts = {n: [] for n in ("this", other)}
            for name in (other, "this", "this", other):
                ts[name].append([graph_ms(f) for f in runs[name]])
            for name, t in ts.items():
                print(f"{name} {str(dt)[6:]}: B14 "
                      f"{sum(x[0] for x in t) / 2:.4f} ms, B18 "
                      f"{sum(x[1] for x in t) / 2:.4f} ms at b{B} s{S} "
                      f"h{H} d{D} causal (from CUDA graphs of {ITERS}, in "
                      f"turns with {other}: "
                      f"{[[round(x, 4) for x in r] for r in t]})",
                      flush=True)
            diff = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip(outs["this"], outs[other])]
            print(f"{str(dt)[6:]}: {other} against this, max |difference| "
                  f"of O, lse2, dQ, dK, dV: {diff}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
