"""Time the port's GEMM kernels on the card, against their plain versions.

B1/B2 (tpp_mlir_tpu_torch/csrc/brgemm.cu) and B19 (csrc/blocked_matmul.cu)
at the main paths' keys, each timed from a CUDA graph of 20 calls (the
device's own time) and eagerly (CUDA events over 20 launches, host time
included), beside torch.addmm / torch.mm on the same operands (B19's
unpacked), with the error against the plain version. Then sha256 digests
of B16's and B17's outputs (csrc/grouped_gemm.cu) on numpy-seeded inputs:
two checkouts whose digests agree give bit-identical outputs.

    python scripts/port_gemm_times.py [--repo PATH]

--repo imports tpp_mlir_tpu_torch from another checkout (for example the
parent commit, unpacked with git archive) instead of this one; its kernels
are built there. Run both in one command, in turns, to compare them on one
card. Needs an NVIDIA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

TOL_F32, TOL_BF16 = 1e-4, 1e-2


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device ms of fn() from one CUDA graph of `iters` calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=3, warmup=1) / iters


def brgemm_keys():
    from tpp_mlir_tpu_torch.xsmm import BrgemmKey
    fc = dict(beta0=True, binary_kind="add", unary_kind="relu")
    return [
        ("B1 fc 256x1024x1024 f32 +bias+relu",
         BrgemmKey(1, 256, 1024, 1024, "f32", **fc)),
        ("B1 fc 256x1024x1024 bf16 +bias+relu",
         BrgemmKey(1, 256, 1024, 1024, "bf16", **fc)),
        ("B1 train fc 2048x1024x1024 bf16 +bias+relu",
         BrgemmKey(1, 2048, 1024, 1024, "bf16", **fc)),
        ("B1 ragged 1024x352x512 f32 +bias+relu",
         BrgemmKey(1, 1024, 352, 512, "f32", **fc)),
        ("B1 gpt2 fc2 2048x768x3072 bf16 +C +bias",
         BrgemmKey(1, 2048, 768, 3072, "bf16", binary_kind="add")),
        ("B1 gpt2 lm head 2048x50304x768 bf16",
         BrgemmKey(1, 2048, 50304, 768, "bf16", beta0=True)),
        ("B2 ln qkv 2048x2304x768 bf16 +bias",
         BrgemmKey(1, 2048, 2304, 768, "bf16", beta0=True,
                   binary_kind="add", prologue="layer_norm")),
        ("B2 ln fc1 2048x3072x768 bf16 +bias+gelu",
         BrgemmKey(1, 2048, 3072, 768, "bf16", beta0=True,
                   binary_kind="add", unary_kind="gelu",
                   prologue="layer_norm")),
    ]


def blocked_keys():
    from tpp_mlir_tpu_torch.xsmm import BlockedMatmulKey
    fc = dict(beta0=True, binary_kind="add", unary_kind="relu")
    return [
        ("B19 fc packed Mb1 Nb2 Kb2 256/512/512 f32 +bias+relu",
         BlockedMatmulKey(1, 2, 2, 256, 512, 512, "f32", **fc)),
        ("B19 fc packed Mb1 Nb2 Kb2 256/512/512 bf16 VNNI +bias+relu",
         BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16", vnni=2, **fc)),
    ]


def brgemm_args(key, g):
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]

    def rnd(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                + shift).to(dt)
    a = rnd((key.batch, key.m, key.k), 2.0 if key.prologue else 1.0,
            0.5 if key.prologue else 0.0)
    b = rnd((key.batch, key.k, key.n), key.k ** -0.5)
    c = None if key.beta0 else rnd((key.m, key.n))
    d = rnd((key.n,)) if key.binary_kind else None
    if key.prologue:
        gamma = torch.randn(key.k, generator=g, device="cuda")
        beta = torch.randn(key.k, generator=g, device="cuda")
        return a, b, c, d, gamma, beta
    return a, b, c, d


def brgemm_library(key, args):
    """torch.addmm (bias, +C folded in as the plain C + bias where both) or
    torch.mm on the same operands; None under the LayerNorm prologue (two
    calls)."""
    import torch
    if key.prologue:
        return None
    a, b, c, d = args[:4]
    if d is not None:
        bias = d if c is None else c + d
        return lambda: torch.addmm(bias, a[0], b[0])
    return lambda: torch.mm(a[0], b[0])


def blocked_args(key, g):
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]

    def rnd(*shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)
    b = rnd(key.Nb, key.Kb, key.kb, key.nb, scale=(key.Kb * key.kb) ** -0.5)
    if key.vnni:
        b = b.reshape(key.Nb, key.Kb, key.kb // 2, 2, key.nb) \
            .movedim(-2, -1).contiguous()
    d = rnd(key.Nb, key.nb, dtype=torch.float32)
    return rnd(key.Mb, key.Kb, key.mb, key.kb), b, None, d


def blocked_library(key, args):
    import torch
    a, b, _, d = args
    if key.vnni:
        b = b.movedim(-1, -2).reshape(key.Nb, key.Kb, key.kb, key.nb)
    a2 = a.permute(0, 2, 1, 3).reshape(key.Mb * key.mb, -1)
    b2 = b.permute(1, 2, 0, 3).reshape(key.Kb * key.kb, -1)
    bias = d.reshape(-1).to(a.dtype)
    return lambda: torch.addmm(bias, a2, b2)


def plan_note(key) -> str:
    from tpp_mlir_tpu_torch.xsmm import kernels, reference
    route = getattr(reference, "brgemm_route", None)
    if route is None:
        return "parent kernel"
    from tpp_mlir_tpu_torch.xsmm import BrgemmKey
    name = reference.brgemm_route(key) if isinstance(key, BrgemmKey) \
        else reference.blocked_matmul_route(key)
    if name == "fma":
        return "route fma"
    bm, bn, split, work = kernels.gemm_plan(key)
    return f"route {name}, tile {bm}x{bn}, split {split}, workspace {work} B"


def time_gemms() -> None:
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [(label, key, brgemm_args(key, g), brgemm_library)
             for label, key in brgemm_keys()]
    cases += [(label, key, blocked_args(key, g), blocked_library)
              for label, key in blocked_keys()]
    for label, key, args, library in cases:
        kern, plain = build_kernel(key), reference_kernel(key)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item() / \
            max(want.float().abs().max().item(), 1e-30)
        tol = TOL_F32 if (key.out_dtype or key.dtype) == "f32" and \
            not getattr(key, "prologue", None) else TOL_BF16
        lib = library(key, args)
        k_graph = graph_ms(lambda: kern(*args))
        k_eager = cuda_ms(lambda: kern(*args))
        lib_note = "library call none"
        if lib is not None:
            lib_note = f"library call graph {graph_ms(lib):.4f} ms, " \
                f"eager {cuda_ms(lib):.4f} ms"
        print(f"gemm {label}: kernel graph {k_graph:.4f} ms, eager "
              f"{k_eager:.4f} ms; {lib_note}; rel {err:.3e} tol {tol:.0e} "
              f"{'ok' if err <= tol else 'FAIL'}; {plan_note(key)}",
              flush=True)


def grouped_digests() -> dict[str, str]:
    """{run: sha256 of its output} of B16 and B17 (the wgmma tiles) on
    inputs made from numpy seeds: a fixed, sorted routing of 8 row blocks
    over 4 experts (expert 2 owns none)."""
    import numpy as np
    import torch

    from tpp_mlir_tpu_torch.xsmm import (GroupedGemmKey, GroupedWgradKey,
                                         build_kernel)
    rs = np.random.RandomState(0)

    def bf16(*shape, scale=1.0):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)
                                * scale).to("cuda").to(torch.bfloat16)
    ge = torch.tensor([0, 0, 1, 1, 1, 3, 3, 3], dtype=torch.int32,
                      device="cuda")
    m, bm = 8 * 128, 128
    x = bf16(m, 768)
    w1 = bf16(4, 768, 512, scale=768 ** -0.5)
    w2t = bf16(4, 768, 512, scale=512 ** -0.5)
    dy = bf16(m, 512)
    runs = [
        ("B16 gelu", GroupedGemmKey(n_groups=4, m=m, n=512, k=768, bm=bm,
                                     dtype="bf16", unary_kind="gelu"),
         (ge, x, w1)),
        ("B16 transpose_b", GroupedGemmKey(n_groups=4, m=m, n=768, k=512,
                                           bm=bm, dtype="bf16",
                                           transpose_b=True),
         (ge, dy, w2t)),
        ("B17 dw", GroupedWgradKey(n_groups=4, m=m, k=768, n=512, bm=bm,
                                   dtype="bf16"), (ge, x.t(), dy)),
    ]
    digests = {}
    for label, key, args in runs:
        out = build_kernel(key)(*args)
        torch.cuda.synchronize()
        digests[label] = hashlib.sha256(
            out.float().cpu().numpy().tobytes()).hexdigest()
    return digests


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", type=Path, default=None,
                        help="import tpp_mlir_tpu_torch from this checkout")
    parser.add_argument("--log", type=Path, default=None,
                        help="write nvcc's output (ptxas report) here")
    args = parser.parse_args()
    root = args.repo or Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("port_gemm_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    import tpp_mlir_tpu_torch
    print(f"package {Path(tpp_mlir_tpu_torch.__file__).parent}", flush=True)
    from tpp_mlir_tpu_torch.xsmm import build
    info = build.build()
    print(f"build {info.seconds:.1f} s", flush=True)
    fn = ""
    for line in info.log.splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        if "spill" in line and " 0 bytes spill stores" not in line:
            print(f"  ptxas: spills in {fn}: {line.strip()}", flush=True)
    if args.log:
        args.log.parent.mkdir(parents=True, exist_ok=True)
        args.log.write_text(info.log)
    time_gemms()
    for label, digest in grouped_digests().items():
        print(f"digest {label}: {digest}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
