"""Time csrc/grouped_gemm.cu's WMMA tiles (B16 and B17 at bm 16) in f16 and
bf16, this checkout's source beside another checkout's, and count each
bm-16 kernel's SASS instructions by opcode.

    python scripts/exp_grouped_wmma.py --repo PATH [--sass-dir DIR]

Compiles grouped_gemm.cu of both checkouts with nvcc (one process each, in
parallel) into libraries of their own under tpp_mlir_tpu_torch/build/,
loads them with ctypes and calls their C entries directly at the MoE
slice's bm 16 shapes (8 experts, 2,128 rows sorted by expert, k 256, n
768: B16 A @ B[ge], B17 x^T dY), each checkout and dtype from a CUDA
graph of 20 launches, in turns (other, this, this, other), the outputs of
the two checkouts compared bit for bit; then B16's WMMA tile of this
checkout at bm 16, 32 and 64 over 2,048 rows (its rows BM follow bm) in
both dtypes.
--sass-dir writes each WMMA kernel's SASS there, one file a kernel. A
source that refuses a dtype (cudaErrorInvalidValue) is reported as such.
Needs an NVIDIA card and nvcc; prints the card's name and power limit
first.
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

M, K, N, BM, GROUPS, ITERS = 2128, 256, 768, 16, 8, 20
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(repo: Path, name: str) -> subprocess.Popen:
    from tpp_mlir_tpu_torch.xsmm.build import BUILD_DIR, NVCC_FLAGS, _nvcc
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = repo / "tpp_mlir_tpu_torch" / "csrc" / "grouped_gemm.cu"
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o",
         str(BUILD_DIR / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.tpp_grouped_gemm.restype = _I
    lib.tpp_grouped_gemm.argtypes = [_P] * 5 + [_I] * 12 + [_P]
    lib.tpp_grouped_wgrad.restype = _I
    lib.tpp_grouped_wgrad.argtypes = [_P] * 4 + [_I] * 5 + [_L, _L] + \
        [_I] * 3 + [_P]
    return lib


def sass_counts(path: Path, sass_dir: Path | None, tag: str) -> dict:
    """{kernel: Counter of opcodes} of the bm-16 WMMA kernels; with
    sass_dir, every WMMA kernel's SASS written to a file of its own."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                          "-sass", str(path)], capture_output=True,
                         text=True).stdout
    counts, name, dump = {}, None, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            if dump:
                dump.close()
            dump = open(sass_dir / f"{tag}_{fn[-60:]}.sass", "w") \
                if sass_dir and ("grouped_gemm_kernel" in fn or
                                 "grouped_wgrad_kernel" in fn) else None
            name = fn if ("grouped_gemm_kernelILi16E" in fn or
                          "grouped_wgrad_kernel" in fn) else None
            if name:
                counts[name] = collections.Counter()
            continue
        if dump:
            dump.write(line + "\n")
        op = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if name and op:
            counts[name][op.group(1).split(".")[0]] += 1
    if dump:
        dump.close()
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


def calls(lib, dt, g, bm=BM, m=M):
    """(B16 launch, B17 launch, outputs) on seeded inputs of dtype dt."""
    import torch
    code = {torch.bfloat16: 1, torch.float16: 2}[dt]
    ge = torch.sort(torch.randint(0, GROUPS, (m // bm,), generator=g,
                                  device="cuda"))[0].to(torch.int32)
    a = torch.randn(m, K, generator=g, device="cuda").to(dt)
    b = (torch.randn(GROUPS, K, N, generator=g, device="cuda")
         * K ** -0.5).to(dt)
    dy = torch.randn(m, N, generator=g, device="cuda").to(dt)
    out = torch.empty(m, N, dtype=dt, device="cuda")
    dw = torch.empty(GROUPS, K, N, device="cuda")
    stream = lambda: ctypes.c_void_p(  # noqa: E731
        torch.cuda.current_stream().cuda_stream)
    xt = a.t()

    def b16():
        return lib.tpp_grouped_gemm(a.data_ptr(), b.data_ptr(),
                                    ge.data_ptr(), None, out.data_ptr(),
                                    GROUPS, 0, m, N, K, bm, code, code, code,
                                    0, 0, 0, stream())

    def b17():
        return lib.tpp_grouped_wgrad(xt.data_ptr(), dy.data_ptr(),
                                     ge.data_ptr(), dw.data_ptr(), GROUPS, m,
                                     K, N, bm, *xt.stride(), code, code, 0,
                                     stream())
    return b16, b17, (out, dw)


def main() -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", required=True, help="the other checkout")
    p.add_argument("--sass-dir", type=Path, help="write SASS files here")
    args = p.parse_args()
    if args.sass_dir:
        args.sass_dir.mkdir(parents=True, exist_ok=True)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    from tpp_mlir_tpu_torch.xsmm.build import BUILD_DIR
    repos = {"other": Path(args.repo).resolve(), "this": ROOT}
    procs = {name: build(repo, f"exp_grouped_{name}")
             for name, repo in repos.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"nvcc {name} failed:\n{log}", flush=True)
            return 1
        fn = ""
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                fn = entry.group(1)
            elif "Used" in line and ("grouped_gemm_kernelILi16E" in fn or
                                     "grouped_wgrad_kernel" in fn):
                print(f"{name} ptxas {fn}: {line.strip()}", flush=True)
        path = BUILD_DIR / f"exp_grouped_{name}.so"
        libs[name] = load(path)
        for fn, ops in sass_counts(path, args.sass_dir, name).items():
            top = ", ".join(f"{o} {c}" for o, c in ops.most_common(14))
            print(f"{name} sass {fn}: {sum(ops.values())} instructions; "
                  f"{top}", flush=True)
    for dt in (torch.bfloat16, torch.float16):
        runs, outs = {}, {}
        for name, lib in libs.items():
            b16, b17, res = calls(lib, dt, torch.Generator(
                device="cuda").manual_seed(7))
            rc = (b16(), b17())
            torch.cuda.synchronize()
            if any(rc):
                print(f"{name} {dt}: refused (rc {rc})", flush=True)
                continue
            runs[name], outs[name] = (b16, b17), res
        times = collections.defaultdict(list)
        for order in (("other", "this"), ("this", "other")):
            for name in order:
                if name in runs:
                    times[name].append([graph_ms(f) for f in runs[name]])
        for name, ts in times.items():
            b16 = sum(t[0] for t in ts) / len(ts)
            b17 = sum(t[1] for t in ts) / len(ts)
            print(f"{name} {str(dt)[6:]}: B16 bm {BM} {M}x{N}x{K} "
                  f"{b16:.4f} ms, B17 {K}x{N} over {M} {b17:.4f} ms "
                  f"(from CUDA graphs of {ITERS}, in turns: "
                  f"{[[round(x, 4) for x in t] for t in ts]})", flush=True)
        if len(outs) == 2:
            same = all(torch.equal(x, y) for x, y in zip(outs["this"],
                                                         outs["other"]))
            print(f"{str(dt)[6:]}: outputs of the two checkouts bit-equal "
                  f"{same}", flush=True)
    # B16's WMMA tile at each row count (BM is the largest of 64, 32, 16
    # that divides bm) over 2,048 rows, a multiple of all three
    for bm in (16, 32, 64):
        res = []
        for dt in (torch.bfloat16, torch.float16, torch.float16,
                   torch.bfloat16):
            b16, _, _ = calls(libs["this"], dt, torch.Generator(
                device="cuda").manual_seed(7), bm, 2048)
            res.append((str(dt)[6:], graph_ms(b16)))
        print(f"this B16 WMMA tile bm {bm}, in turns: {res}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
