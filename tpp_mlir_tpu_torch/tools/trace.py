"""Where the device time of one module goes, by torch.profiler.

  tpp-gen --batch=256 --layers=1024,1024,1024,1024 --bias --relu \\
      | python -m tpp_mlir_tpu_torch.tools.trace - --iters 20 -n 100

Lowers the module with default-tpp-passes, warms it up, then traces two
regions on the card and prints one line each:
  eager  `--iters` forwards of the entry through the executor;
  bench  the `-n` perf.bench wrapper (one chain launch with in-kernel
         repeats when the body is one chain), as `tpp_run -n` runs it.
For each region: the device span (first kernel start to last kernel end),
the busy time (union of device activity), the idle share 1 - busy/span,
and each device activity's share of the busy time, largest first.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

import torch

from ..passes import PassManager
from ..runtime import compile as tpp_compile
from .tpp_run import init_args, load_module, resolve_device, wrap_bench_main


def device_breakdown(fn) -> dict:
    """Run fn() under torch.profiler and summarise its device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
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
            "shares": shares}


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
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace (torch)", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("input", nargs="?", default="-")
    p.add_argument("-e", "--entry", default="entry")
    p.add_argument("--iters", type=int, default=20,
                   help="eager forwards in the eager region")
    p.add_argument("-n", type=int, default=100,
                   help="perf.bench iterations in the bench region")
    p.add_argument("--pipeline", default="default-tpp-passes")
    p.add_argument("--device", default="cuda")
    p.add_argument("--label", default="", help="prefix of each line")
    args = p.parse_args(argv)
    text = sys.stdin.read() if args.input == "-" else open(args.input).read()
    res = trace_module(load_module(text), args.entry, args.iters, args.n,
                       args.device, args.pipeline)
    for region, r in res.items():
        top = ", ".join(f"{name[:48]} {share:.3f}" for share, name in
                        r["shares"][:4])
        print(f"{args.label}{region}: span {r['span_ms']:.3f} ms, busy "
              f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}; "
              f"{top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
