"""Where the device time of one module goes, by torch.profiler.

  tpp-gen --batch=256 --layers=1024,1024,1024,1024 --bias --relu \\
      | python -m tpp_mlir_tpu_torch.tools.trace - --iters 20 -n 100
  python -m tpp_mlir_tpu_torch.tools.trace --model 'gpt:{"batch": 2, \\
      "seq": 1024, "dtype": "bf16"}' --iters 5

`--model` takes the bench driver's `model:` entry (an imported model,
which cannot go through IR text). `--serve` traces the serving engine
instead: one prefill, `--iters` eager decode steps and the same steps
replayed from a CUDA graph, each with its kernels' device ms
(`trace_serving`):

  python -m tpp_mlir_tpu_torch.tools.trace --serve '{"batch": 8,
      "prompt": 512, "max_seq": 1024, "dtype": "bf16"}' --iters 8

`trace_steps(step)` traces a few calls of any warm step function the same
way (chip_smoke.py uses it on GPT-2 small's training step).

Lowers the module with default-tpp-passes, warms it up, then traces two
regions on the card and prints one line each:
  eager  `--iters` forwards of the entry through the executor;
  bench  the `-n` perf.bench wrapper (one chain launch with in-kernel
         repeats when the body is one chain), as `tpp_run -n` runs it.
For each region: the device span (first kernel start to last kernel end),
the busy time (union of device activity), the idle share 1 - busy/span,
and each device activity's share of the busy time, largest first.
Then one line per kernel key of the module ("invoke"): its launches and
device ms per forward, by CUDA events around each launch of `--iters`
forwards, which the profiler's per-name sums cannot tell apart (one
brgemm kernel serves every GEMM shape).
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

import torch

from ..passes import PassManager
from ..runtime import compile as tpp_compile
from ..utils.target import resolve_device
from ..xsmm import (BatchMatmulKey, BlockedMatmulKey, BrgemmKey, ChainKey,
                    ConvBrgemmKey, ConvNhwcKey, DecodeAttnKey, FlashMhaKey,
                    FlashTrainBwdKey, FlashTrainKey, GroupedGemmKey,
                    GroupedWgradKey, Int8GemmKey, LayerNormKey, global_cache)
from .bench_driver import build_module
from .tpp_run import init_args, load_module, wrap_bench_main


def device_breakdown(fn) -> dict:
    """Run fn() under torch.profiler and summarise its device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # a user annotation (torch.optim's "Optimizer.step#...") is mirrored on
    # the device timeline as a span around its kernels: not an activity
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    per_name = defaultdict(float)
    for s, e, name in spans:
        per_name[name] += e - s
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in spans) - spans[0][0]
    total = sum(per_name.values())
    shares = sorted(((t / total, n) for n, t in per_name.items()),
                    reverse=True)
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span if span else 0.0,
            "kernels": len(spans), "shares": shares,
            "ms": {n: t / 1e3 for n, t in per_name.items()}}


TOP = 8     # device activities listed per region


def describe(key) -> str:
    """A short label of a kernel key: kind, shape, dtype, fusions."""
    if isinstance(key, BrgemmKey):
        extra = "".join(f" +{x}" for x, on in (
            ("ln", key.prologue == "layer_norm"),
            ("ln_stats", key.prologue == "ln_stats"),
            ("stats_out", key.ln_stats_out), ("C", not key.beta0),
            (key.binary_kind, key.binary_kind),
            (key.unary_kind, key.unary_kind)) if on)
        return f"brgemm {key.m}x{key.n}x{key.k} {key.dtype}{extra}"
    if isinstance(key, ChainKey):
        kind = "chain_pingpong" if key.pingpong and key.repeats > 1 \
            else "chain"
        reps = f" r{key.repeats}" if key.repeats > 1 else ""
        return (f"{kind} {key.m}x{'x'.join(map(str, key.dims))} "
                f"{key.dtype}{reps}")
    if isinstance(key, FlashMhaKey):
        kind = "attention_bench" if key.repeats else \
            "attention" if key.heads else "attention_flat"
        extra = "".join(f" {x}" for x, on in (
            ("causal", key.causal), (key.strategy, key.strategy != "auto"),
            (f"r{key.repeats}", key.repeats)) if on)
        return (f"{kind} b{key.batch} s{key.seq} h{key.heads} "
                f"d{key.head_dim} {key.dtype}{extra}")
    if isinstance(key, BatchMatmulKey):
        extra = "".join(f" {x}" for x, on in (
            ("softmax_lhs", key.softmax_lhs), ("lhs_shared", key.lhs_shared),
            ("+C", not key.beta0)) if on)
        return (f"batch_matmul {key.batch}x{key.m}x{key.n}x{key.k} "
                f"{key.dtype}{extra}")
    if isinstance(key, LayerNormKey):
        return f"layer_norm {key.m}x{key.n} {key.dtype}"
    if isinstance(key, DecodeAttnKey):
        extra = "".join(f" {x}" for x, on in (
            (f"g{key.groups}", key.groups > 1), ("int8kv", key.kv_quant),
            ("pack2", key.pack2), ("slotted", key.slotted)) if on)
        return (f"decode_attn b{key.batch} kvh{key.heads} s{key.seq} "
                f"d{key.head_dim} {key.dtype}{extra}")
    if isinstance(key, Int8GemmKey):
        extra = "".join(f" +{x}" for x, on in (
            ("bias", key.has_bias), (key.unary_kind, key.unary_kind)) if on)
        return f"int8_gemm {key.m}x{key.n}x{key.k} {key.out_dtype}{extra}"
    if isinstance(key, FlashTrainKey):
        kind = "flash_train_bwd" if isinstance(key, FlashTrainBwdKey) \
            else "flash_train_fwd"
        return (f"{kind} b{key.batch} s{key.seq} h{key.heads} "
                f"d{key.head_dim} {key.dtype}"
                f"{' causal' if key.causal else ''}")
    if isinstance(key, GroupedGemmKey):
        extra = "".join(f" {x}" for x, on in (
            ("transpose_b", key.transpose_b), (key.unary_kind, key.unary_kind),
            (f"layers {key.layers}", key.layers),
            (f"-> {key.out_dtype}", key.out_dtype)) if on)
        return (f"grouped_gemm {key.m}x{key.n}x{key.k} g{key.n_groups} "
                f"bm{key.bm} {key.dtype}{extra}")
    if isinstance(key, GroupedWgradKey):
        return (f"grouped_wgrad {key.k}x{key.n} over m{key.m} "
                f"g{key.n_groups} bm{key.bm} {key.dtype}")
    if isinstance(key, ConvNhwcKey):
        extra = "".join(f" {x}" for x, on in (
            (f"pad {key.pad}", any(key.pad)), ("+C", not key.beta0),
            (f"+{key.binary_kind} {key.binary_bcast}", key.binary_kind),
            (f"+{key.unary_kind}", key.unary_kind),
            (key.precision, key.precision != "default"),
            (key.strategy, key.strategy != "auto")) if on)
        return (f"conv_nhwc n{key.N} {key.H}x{key.W}x{key.C}->{key.P}x"
                f"{key.Q}x{key.K} r{key.R}s{key.S} {key.dtype}{extra}")
    if isinstance(key, (BlockedMatmulKey, ConvBrgemmKey)):
        extra = "".join(f" {x}" for x, on in (
            ("+C", not key.beta0), (f"+{key.binary_kind}", key.binary_kind),
            (f"+{key.unary_kind}", key.unary_kind),
            (key.precision, key.precision != "default"),
            (f"vnni{getattr(key, 'vnni', 0)}", getattr(key, "vnni", 0)),
            (f"r{getattr(key, 'repeats', 0)}", getattr(key, "repeats", 0)))
            if on)
        if isinstance(key, ConvBrgemmKey):
            return (f"conv_blocked n{key.N} {key.H}x{key.W}x{key.Cb}x{key.c}"
                    f"->{key.P}x{key.Q}x{key.Kb}x{key.k} r{key.R}s{key.S} "
                    f"{key.dtype}{extra}")
        kind = "blocked_matmul_warm" if key.repeats else "blocked_matmul"
        return (f"{kind} {key.Mb}x{key.Nb}x{key.Kb} {key.mb}/{key.nb}/"
                f"{key.kb} {key.dtype}{extra}")
    return type(key).__name__


def invoke_times(fn, args, iters: int) -> list[tuple[str, int, float]]:
    """(label, launches per call, device ms per call) of each kernel key
    that `fn(*args)` launches, largest first: CUDA events recorded around
    each launch of `iters` calls (the kernels must be built already)."""
    records = []
    kernels = global_cache().kernels()
    # a key with no kernel (strategy xla) runs its plain version: untimed
    saved = [(k, k._launch) for k in kernels if k._launch is not None]

    def timed(launch, key):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(*a, **kw)
            stop.record()
            records.append((key, start, stop))
            return out
        return run
    try:
        for k, launch in saved:
            k._launch = timed(launch, k.key)
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    finally:
        for k, launch in saved:
            k._launch = launch
    per: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for key, start, stop in records:
        per[describe(key)][0] += 1
        per[describe(key)][1] += start.elapsed_time(stop)
    return sorted(((name, n // iters, ms / iters)
                   for name, (n, ms) in per.items()), key=lambda r: -r[2])


def trace_module(module, func_name: str = "entry", iters: int = 20,
                 n: int = 100, device: str = "cuda",
                 pipeline: str = "default-tpp-passes") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("trace reads device time: it needs --device cuda")
    PassManager([pipeline]).run(module)
    args = init_args(module, func_name, "normal", 0, dev)
    fn = tpp_compile(module, func_name, dev)
    fn(*args)       # warm-up: builds the library and the kernels
    out = {"eager": device_breakdown(
        lambda: [fn(*args) for _ in range(iters)])}
    wrapper = wrap_bench_main(module, func_name, n) if n > 0 else None
    if wrapper is not None:
        bench = tpp_compile(module, wrapper, dev)
        bench(*args)
        out["bench"] = device_breakdown(lambda: bench(*args))
    out["invokes"] = invoke_times(fn, args, iters)
    return out


def trace_serving(cfg, params, ids, steps: int = 8) -> dict:
    """The serving engine on the card: device breakdowns of one prefill, of
    `steps` eager decode steps and of the same steps replayed from a CUDA
    graph (from the prompt's end each time). Each region's device ms per
    kernel name come from the profiler's spans: the eager regions are
    host-bound, so CUDA events around launches would time the host's gaps
    too."""
    from ..serving import DecodeRunner, make_decode_step, make_prefill

    if not ids.is_cuda:
        raise RuntimeError("trace reads device time: it needs CUDA tensors")
    prefill, step = make_prefill(cfg), make_decode_step(cfg)
    logits, cache = prefill(params, ids)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    eager = DecodeRunner(step, params, cache, tok, graph=False)
    eager(tok)          # warm-up: builds the decode kernels
    out = {"prefill": device_breakdown(lambda: prefill(params, ids)),
           "decode eager": device_breakdown(lambda: eager.repeat(tok, steps))}
    eager.reset()
    graphed = DecodeRunner(step, params, cache, tok, graph=True)
    out["decode graph"] = device_breakdown(
        lambda: graphed.repeat(tok, steps))
    return {f"{region} ({steps} steps)" if "decode" in region else region: r
            for region, r in out.items()}


def trace_steps(step, steps: int = 2) -> dict:
    """The device breakdown of `steps` calls of step() (a warm training
    step: its kernels built, its optimizer state made)."""
    def run():
        for _ in range(steps):
            step()
    return {f"train step ({steps} steps)": device_breakdown(run)}


def print_trace(res: dict, label: str = "") -> None:
    """One line per profiled region (its largest device activities: share
    of the busy time and device ms), then one per kernel key."""
    for region, r in res.items():
        if region == "invokes":
            continue
        top = ", ".join(f"{name[:48]} {share:.3f} ({r['ms'][name]:.3f} ms)"
                        for share, name in r["shares"][:TOP])
        print(f"{label}{region}: span {r['span_ms']:.3f} ms, busy "
              f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['kernels']} device activities; {top}")
    rows = res.get("invokes", [])
    total = sum(ms for _, _, ms in rows) or 1.0
    for name, n, ms in rows:
        print(f"{label}invoke {name:44s} {n:3d} launches "
              f"{ms:9.4f} ms share {ms / total:.3f} (per forward)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace (torch)", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("input", nargs="?", default="-")
    p.add_argument("--model", help="a bench_driver model entry, in place "
                                   "of IR text")
    p.add_argument("-e", "--entry", default="entry")
    p.add_argument("--iters", type=int, default=20,
                   help="eager forwards in the eager region")
    p.add_argument("-n", type=int, default=100,
                   help="perf.bench iterations in the bench region")
    p.add_argument("--pipeline", default="default-tpp-passes")
    p.add_argument("--device", default="cuda")
    p.add_argument("--label", default="", help="prefix of each line")
    p.add_argument("--serve", help="a JSON object of GptConfig fields (and "
                                   "batch, prompt, seed, llama, quant): "
                                   "trace the serving engine")
    args = p.parse_args(argv)
    if args.serve:
        import json
        if resolve_device(args.device).type != "cuda":
            raise RuntimeError("trace reads device time: it needs --device "
                               "cuda")
        from .tpp_serve import setup
        cfg, params, ids = setup(json.loads(args.serve))
        print_trace(trace_serving(cfg, params, ids, args.iters), args.label)
        return 0
    if args.model:
        module = build_module({"model": args.model})
    else:
        module = load_module(sys.stdin.read() if args.input == "-"
                             else open(args.input).read())
    res = trace_module(module, args.entry, args.iters, args.n, args.device,
                       args.pipeline)
    print_trace(res, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
