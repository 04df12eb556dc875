"""Time the port's warm kernels on the card, against their plain versions.

csrc/chain.cu (B3 at repeats 1, B4 at repeats 100, B5's ping-pong at
fc_128x768x2304 with -n 100) and B20 (csrc/blocked_matmul.cu, base.json's
fc rows with -n 200) at the main paths' keys, each held against its plain
version and launched twice (bit-equal), timed eagerly (CUDA events over
launches) and from a CUDA graph, beside the composed PyTorch chain on the
same inputs replayed from one CUDA graph: torch.addmm + torch.relu per
layer and repeat on bf16 copies (B5: addmm + relu, then h @ W^T). No single
PyTorch call computes these functions; the composed chain is the
yardstick, not a library call. Where the checkout has the warm-panel
engine, its plan and route per key and the card's
cudaOccupancyMaxActiveClusters for each plan are printed first.

    python scripts/port_warm_times.py [--repo PATH]

--repo imports tpp_mlir_tpu_torch from another checkout (for example the
parent commit, unpacked with git archive) instead of this one; its kernels
are built there. Run both in one command, in turns, to compare them on one
card. Needs an NVIDIA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

TOL_BF16 = 1e-2
N_CHAIN, N_PINGPONG, N_BLOCKED = 100, 100, 200


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def graph_ms(fn, iters: int = 10) -> float:
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


def rel(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30)


def keys():
    """(label, key, repeats the line is read per): the flagship MLP
    (256 x 1024x4 +bias+relu) as B3 and B4 in bf16 and f32 "default", B5
    at fc_128x768x2304, B20 at base.json's fc rows (f32 "default", bf16
    VNNI)."""
    from tpp_mlir_tpu_torch.xsmm import BlockedMatmulKey, ChainKey
    flag = (1024,) * 4
    fc = dict(beta0=True, binary_kind="add", unary_kind="relu")
    return [
        ("B3 flagship bf16", ChainKey(m=256, dims=flag, dtype="bf16"), 1),
        ("B3 flagship f32", ChainKey(m=256, dims=flag, dtype="f32"), 1),
        ("B4 flagship bf16 -n 100",
         ChainKey(m=256, dims=flag, dtype="bf16", repeats=N_CHAIN), N_CHAIN),
        ("B4 flagship f32 -n 100",
         ChainKey(m=256, dims=flag, dtype="f32", repeats=N_CHAIN), N_CHAIN),
        ("B5 fc_128x768x2304 f32 -n 100",
         ChainKey(m=128, dims=(768, 2304), repeats=N_PINGPONG,
                  pingpong=True), N_PINGPONG),
        ("B20 fc f32 Mb1 Nb2 Kb2 256/512/512 -n 200",
         BlockedMatmulKey(1, 2, 2, 256, 512, 512, "f32", repeats=N_BLOCKED,
                          **fc), N_BLOCKED),
        ("B20 fc bf16 VNNI -n 200",
         BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16", vnni=2,
                          repeats=N_BLOCKED, **fc), N_BLOCKED),
    ]


def chain_args(key, g):
    """x ~ N(0,1), W ~ N(0,1/k), bias ~ N(0, 0.1^2) (chip_smoke's)."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    out = [torch.randn(key.m, key.dims[0], generator=g, device="cuda").to(dt)]
    for k, n in zip(key.dims[:-1], key.dims[1:]):
        out.append((torch.randn(k, n, generator=g, device="cuda")
                    / k ** 0.5).to(dt))
        out.append((torch.randn(n, generator=g, device="cuda") * 0.1).to(dt))
    return tuple(out)


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
    return rnd(key.Mb, key.Kb, key.mb, key.kb), b, None, \
        rnd(key.Nb, key.nb, dtype=torch.float32)


def composed(key, args):
    """The composed PyTorch chain on bf16 copies of the same inputs (the
    key's products are bf16): a callable, its operands prepared once."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import ChainKey
    bf = torch.bfloat16
    if isinstance(key, ChainKey):
        x = args[0].to(bf)
        ws = [w.to(bf) for w in args[1::2]]
        bs = [b.to(bf) for b in args[2::2]]
        if key.pingpong:
            w, b = ws[0], bs[0]
            wt = w.t()

            def run():
                h = x
                for r in range(key.repeats):
                    h = torch.relu(torch.addmm(b, h, w)) if r % 2 == 0 \
                        else h @ wt
                return h
            return run

        def run():
            h = x
            for _ in range(key.repeats):
                for w, b in zip(ws, bs):
                    h = torch.relu(torch.addmm(b, h, w))
            return h
        return run
    a, b, _, d = args
    if key.vnni:
        b = b.movedim(-1, -2).reshape(key.Nb, key.Kb, key.kb, key.nb)
    a2 = a.permute(0, 2, 1, 3).reshape(key.Mb * key.mb, -1).to(bf)
    b2 = b.permute(1, 2, 0, 3).reshape(key.Kb * key.kb, -1).to(bf)
    bias = d.reshape(-1).to(bf)

    def run():
        h = a2
        for _ in range(key.repeats):
            h = torch.relu(torch.addmm(bias, h, b2))
        return h
    return run


def plan_note(key) -> str:
    from tpp_mlir_tpu_torch.xsmm import ChainKey, kernels, reference
    if not hasattr(reference, "warm_plan"):
        return "parent kernel"
    route = reference.chain_route(key) if isinstance(key, ChainKey) \
        else reference.warm_route(key)
    plan = reference.warm_plan(key)
    if route != "panel":
        return f"route {route}"
    card = kernels.warm_max_clusters(plan.rows, plan.cluster, plan.smem)
    return (f"route panel, rows {plan.rows}, cluster {plan.cluster}, tiles "
            f"{plan.tiles}, {'resident' if plan.resident else 'streamed'}, "
            f"{plan.smem} B, {plan.clusters} clusters (the card holds "
            f"{card} at once)")


def occupancy() -> None:
    """cudaOccupancyMaxActiveClusters for the engine at each (rows, cluster)
    of the plan table and a few shared-memory sizes."""
    from tpp_mlir_tpu_torch.xsmm import kernels
    for smem in (60_000, 120_000, 140_000, 200_000, 225_000):
        row = []
        for cluster in (1, 2, 4, 8, 12, 16):
            n = kernels.warm_max_clusters(32, cluster, smem)
            row.append(f"C{cluster} {n}")
        print(f"occupancy: {smem} B a block: {', '.join(row)} clusters",
              flush=True)


def time_warm() -> None:
    import torch

    from tpp_mlir_tpu_torch.xsmm import (ChainKey, build_kernel,
                                         reference_kernel)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    for label, key, per in keys():
        args = chain_args(key, g) if isinstance(key, ChainKey) \
            else blocked_args(key, g)
        kern, plain = build_kernel(key), reference_kernel(key)
        got, again, want = kern(*args), kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = rel(got, want)
        same = torch.equal(got, again)
        lib = composed(key, args)
        k_eager = cuda_ms(lambda: kern(*args))
        k_graph = graph_ms(lambda: kern(*args))
        c_graph = graph_ms(lib)
        print(f"warm {label}: kernel eager {k_eager:.4f} ms, graph "
              f"{k_graph:.4f} ms ({k_graph / per:.5f} ms per repeat of "
              f"{per}); composed chain (addmm + relu, bf16) graph "
              f"{c_graph:.4f} ms; rel {err:.3e} tol {TOL_BF16:.0e} "
              f"{'ok' if err <= TOL_BF16 else 'FAIL'}; second launch "
              f"bit-equal {same}; {plan_note(key)}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", type=Path, default=None,
                        help="import tpp_mlir_tpu_torch from this checkout")
    args = parser.parse_args()
    root = args.repo or Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("port_warm_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    import tpp_mlir_tpu_torch
    print(f"package {Path(tpp_mlir_tpu_torch.__file__).parent}", flush=True)
    from tpp_mlir_tpu_torch.xsmm import build, reference
    info = build.build()
    print(f"build {info.seconds:.1f} s", flush=True)
    fn = ""
    for line in info.log.splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        if "warm_panel" in fn and ("registers" in line or "spill" in line):
            print(f"  ptxas {fn}: {line.strip()}", flush=True)
    if hasattr(reference, "warm_plan"):
        occupancy()
    time_warm()
    return 0


if __name__ == "__main__":
    sys.exit(main())
