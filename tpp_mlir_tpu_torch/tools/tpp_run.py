"""tpp-run on PyTorch/CUDA: lower, execute, time and print IR programs.

The port's counterpart of `tpp_mlir_tpu/tools/tpp_run.py` (the reference
tpp-run: deterministic arg init, a perf.bench timing loop, result printing):

  tpp-gen --batch=256 --layers=1024,1024,1024,1024 --bias --relu \\
      | python -m tpp_mlir_tpu_torch.tools.tpp_run - -n 100
  python -m tpp_mlir_tpu_torch.tools.tpp_run model.ir --print -seed 3
  python -m tpp_mlir_tpu_torch.tools.tpp_run model.ir --linalg-to-loops

`--device` defaults to cuda; with no CUDA device it raises rather than
running on the CPU. `--device cpu` runs the kernels' plain versions.

The reference's debugging flags: `--print-mlir early|mid|late` prints the
module (to stderr) before or after lowering, `--print-mlir kernel` each
dispatched kernel key with the route and csrc/ source that runs it on the
card; `-v` prints the kernel cache's builds and each kernel's launches;
`--splat-to-random` makes splat weights and inputs random (accumulator
zeros stay); `--profile DIR` writes a torch.profiler trace of the run to
DIR/trace.json; `--sanitize nan` raises at the first op whose output holds
a NaN or an Inf (a host sync an op, only under the flag). The differential
recipe, as the reference's (f32 "highest": true f32 on both sides; f32
"default" rounds the kernels' operands to bf16, so compare it by -a):

  python -m tpp_mlir_tpu_torch.tools.mlir_gen --batch=8 \
      --layers=16,16,16 --bias --relu --output=generic > g.ir
  python -m tpp_mlir_tpu_torch.tools.tpp_run g.ir --print -seed 3 \
      -init-type rand --precision highest --device cpu > low.txt
  python -m tpp_mlir_tpu_torch.tools.tpp_run g.ir --print -seed 3 \
      -init-type rand --precision highest --device cpu \
      --linalg-to-loops > ref.txt
  python -m tpp_mlir_tpu_torch.tools.fpcmp low.txt ref.txt -r 1e-4

`--task-grid DPxTP` (the reference's --parallel-task-grid) splits the
batch over a (dp, tp) mesh of torch.distributed ranks: run it under
torchrun, one rank a device; each rank runs the program at its share of
the batch and rank 0 prints (backend nccl on CUDA, gloo on the CPU):

  tpp-gen --batch=512 --layers=256,256,256 --bias --relu > mlp.ir
  python -m torch.distributed.run --nproc-per-node 2 \
      -m tpp_mlir_tpu_torch.tools.tpp_run mlp.ir --task-grid 2x1 \
      --device cpu --print
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ir import Function, Module, parse_module
from ..ir.ops import TppBuilder
from ..passes import PassManager
from ..runtime import bench, tensor_init
from ..runtime import compile as tpp_compile
from ..runtime.executor import (bench_label, in_kernel_bench, module_keys,
                                time_in_kernel)
from ..runtime.perf import device_name, model_flops
from ..utils.target import resolve_device


def wrap_bench_main(module: Module, func_name: str, n: int) -> str | None:
    """Synthesize the timing wrapper in IR: a main that runs the kernel
    through a perf.bench op. Returns the wrapper name, or None when the
    entry's results cannot chain into its leading args."""
    entry = module[func_name]
    rets = [v.type for v in entry.returns]
    args_t = [a.type for a in entry.args]
    if not rets or rets != args_t[:len(rets)]:
        return None
    name = f"{func_name}_bench_main"
    if name in module.funcs:
        return name
    wrapper = module.add(Function(name, args_t,
                                  [a.name for a in entry.args]))
    b = TppBuilder(wrapper)
    results = b.perf_bench(func_name, list(wrapper.args), n,
                           num_chained=len(rets))
    wrapper.returns = list(results)
    module.verify()
    return name


def print_tensor(t, file=None):
    """Row-wise printing in the MLIRBench style ('( v, v, ... )' rows, bf16
    extended to f32)."""
    file = file or sys.stdout
    a = t.detach().float().cpu().numpy()
    if a.ndim == 0:
        print(f"{float(a):g}", file=file)
        return
    for row in a.reshape(-1, a.shape[-1]):
        print("( " + ", ".join(f"{v:g}" for v in row) + " )", file=file)


def init_args(module: Module, func_name: str, init_type: str, seed: int,
              device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """Deterministic args, the reference's rule (tpp_run.py:68-92): a float
    arg i is tensor_init(init_type, seed + i); an i32/i8 arg holds token
    ids, int32 uniform in [0, rows of the tl.gather table it feeds) (256
    when it feeds none) from numpy's default_rng(seed + i)."""
    device = resolve_device(device)
    func = module[func_name]
    out = []
    for i, a in enumerate(func.args):
        if a.type.dtype in ("i32", "i8"):
            bound = next((op.operands[0].type.shape[0] for op in func.ops
                          if op.opname == "tl.gather"
                          and op.operands[1] is a), 256)
            t = torch.from_numpy(np.random.default_rng(seed + i).integers(
                0, bound, size=a.type.shape, dtype=np.int32))
        else:
            t = tensor_init(init_type, a.type.shape, a.type.dtype,
                            seed=seed + i)
        out.append(t.to(device))
    return out


def load_module(text: str) -> Module:
    """IR text (tpp-gen's output, a .mlir file) as a verified Module."""
    module = parse_module(text)
    module.verify()
    return module


# contractions whose C operand (index 2) is the accumulator
_CONTRACTIONS = ("tl.matmul", "tl.brgemm", "tl.vnni_brgemm",
                 "tl.batch_matmul", "tl.blocked_matmul",
                 "tl.conv2d_nhwc_hwcf", "tl.conv2d_nchw_fchw")


def splat_to_random(module: Module, seed: int = 0) -> None:
    """The reference's -splat-to-random (tpp_run.py:234-260 there,
    MLIRBench.cpp:111-164): every splat constant ("const" or "zero" init)
    becomes a random one, so a benchmark does not time splat arithmetic;
    a zero that only feeds contractions as their accumulator keeps its
    meaning (BETA_0) and stays."""
    def only_accumulator(op):
        return op.results and op.result.uses and all(
            u.opname in _CONTRACTIONS and i == 2 for u, i in op.result.uses)

    for f in module.funcs.values():
        for op in f.ops:
            init = op.attrs.get("init")
            if op.opname != "tl.constant" or init not in ("const", "zero"):
                continue
            if init == "zero" and only_accumulator(op):
                continue
            op.attrs["init"] = "rand"
            op.attrs.setdefault("seed", seed)


def print_kernels(module: Module, func_name: str, device: torch.device,
                  file) -> None:
    """--print-mlir kernel: each dispatched key of the lowered function, the
    route and csrc/ source its kernel, the one the run launches, was built
    with (the reference prints each kernel's jaxpr and StableHLO here)."""
    from ..xsmm import global_cache
    from ..xsmm.kernels import describe_plan
    from .trace import describe
    where = "" if device.type == "cuda" else \
        f" (on {device.type}: its plain version)"
    for inv, key in module_keys(module, func_name):
        kern = global_cache().dispatch(key)
        runs = f"route {kern.route}, {kern.source}" if kern.source else \
            "no kernel: a PyTorch op"
        if kern.plan is not None:
            runs += f", {describe_plan(kern.plan)}"
        print(f"// kernel %{inv.result.name} = {inv.opname}: "
              f"{describe(key)}; {runs}{where}", file=file)


def run_module(module: Module, func_name: str = "entry", n: int = 0,
               init_type: str = "normal", seed: int = 0,
               pipeline: str = "default-tpp-passes",
               linalg_to_loops: bool = False, print_result: bool = False,
               device: str | torch.device = "cuda",
               out_stream=None, bench_mode: str = "auto",
               task_grid: str = "", print_mlir: str = "",
               sanitize: bool = False) -> dict:
    """Lower (unless linalg_to_loops), run once, and with n > 0 time n
    chained iterations: inside one kernel launch where the function is one
    kernel with a warm bench (B4, B5, B11) and bench_mode is "auto", else
    in a loop (result["bench"] says which). With `task_grid` every rank of
    the world runs the program at its dp share of the batch
    (`parallel.runner.local_batch`, `task_grid_run`), the outputs gathered,
    timed in a loop. `print_mlir` ("early", "mid", "late" or "kernel")
    prints the module or its kernels to stderr; `sanitize` raises at the
    first non-finite op output. Returns the module, outputs, device and
    timing."""
    out_stream = out_stream or sys.stdout
    device = resolve_device(device)
    if task_grid:
        # the whole batch's args and work; the rank's program at its share
        import copy

        from ..parallel.runner import (local_batch, parse_task_grid,
                                       task_grid_run)
        args = init_args(module, func_name, init_type, seed, device)
        flops = model_flops(module)
        module = copy.deepcopy(module)
        local_batch(module, func_name, parse_task_grid(task_grid)["dp"])
    if print_mlir == "early":
        print(module, file=sys.stderr)
    if not linalg_to_loops:
        PassManager([pipeline]).run(module)
    if print_mlir in ("mid", "late"):
        print(module, file=sys.stderr)
    elif print_mlir == "kernel":
        print_kernels(module, func_name, device, sys.stderr)
    wrapper = wrap_bench_main(module, func_name, n) \
        if n > 0 and not task_grid else None
    if not task_grid:
        args = init_args(module, func_name, init_type, seed, device)
        flops = model_flops(module)
    fn = tpp_compile(module, func_name, device, sanitize=sanitize)
    if task_grid:
        fn = task_grid_run(fn, task_grid, len(args))
    result = {"module": module, "device": device_name(device)}
    if n > 0:
        if wrapper is not None:
            # the timing lives in IR: run the perf.bench wrapper (in-kernel
            # repeats when the body is one benchable kernel, else a loop)
            ext = in_kernel_bench(module, func_name, device, bench_mode)
            result["bench"] = bench_label(ext[0]) if ext else "loop"
            outs = tpp_compile(module, wrapper, device,
                               bench_mode=bench_mode,
                               sanitize=sanitize)(*args)
            mean = float(outs[0])
        else:
            # results that cannot chain into the args: B5's ping-pong for a
            # non-square fc (the reference's warm bench of it), else a loop
            ext = None if task_grid else \
                in_kernel_bench(module, func_name, device, bench_mode)
            result["bench"] = bench_label(ext[0]) if ext else "loop"
            mean = time_in_kernel(ext, args, n, device)[0] if ext else \
                bench(fn, args, iters=n).mean_seconds
        result["mean_seconds"] = mean
        result["gflops"] = flops / mean / 1e9 if flops else None
        where = result["device"]
        how = f"{where}, {result['bench']}"
        if result["gflops"] is not None:
            print(f"{result['gflops']:.3f} gflops ({mean * 1e3:.6f} ms "
                  f"mean of {n}, {how})", file=out_stream)
        else:
            print(f"{mean * 1e3:.6f} ms (mean of {n}, {how})",
                  file=out_stream)
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    result["outputs"] = outs
    if print_result:
        for o in outs:
            print_tensor(o, file=out_stream)
    return result


def profile_run(fn, out_dir: str, device) -> str:
    """Run fn() under torch.profiler (the CPU, and CUDA activities on the
    card) and write its chrome trace to out_dir/trace.json."""
    import os

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpp-run (torch)", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("input", nargs="?", default="-")
    p.add_argument("-e", "--entry", default="entry")
    p.add_argument("-n", type=int, default=0, help="benchmark iterations")
    p.add_argument("--print", dest="print_result", action="store_true")
    p.add_argument("-seed", "--seed", type=int, default=0)
    p.add_argument("-init-type", "--init-type", default="normal")
    p.add_argument("--linalg-to-loops", action="store_true",
                   help="skip lowering; execute reference semantics")
    p.add_argument("--pipeline", default="default-tpp-passes")
    p.add_argument("--precision", choices=["default", "highest"],
                   default="default",
                   help="f32 only: 'default' = bf16 operands with f32 "
                        "accumulation, 'highest' = f32 FMA (no TF32)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no CPU fallback)")
    p.add_argument("--register-blocking", "-registerBlocking", default="",
                   help="bm,bn,bk: force the plan of every GEMM the "
                        "tile-and-fuse pass anchors (the reference's "
                        "--registerBlocking). On Hopper bm,bn choose the "
                        "mainloop's output tile (128,128 64,128 or 64,64; "
                        "f32 'highest' 64,64) and bk the depth of one k "
                        "slice, a multiple of 64: the k split is "
                        "ceil(K / bk), bk >= K none. A plan the kernel "
                        "does not run raises")
    p.add_argument("--task-grid", "-parallel-task-grid", default="",
                   help="split the batch over a (dp, tp) mesh of ranks, "
                        "e.g. '2x1' (the reference's --parallel-task-grid); "
                        "run under torchrun")
    p.add_argument("-print-mlir", "--print-mlir",
                   choices=["", "early", "mid", "late", "kernel"], default="",
                   help="print the module before (early) or after (mid, "
                        "late) lowering, or each dispatched kernel key with "
                        "its route and csrc/ source (kernel), to stderr")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="print the kernel cache's builds and launches")
    p.add_argument("-splat-to-random", "--splat-to-random",
                   action="store_true",
                   help="make splat constants random (accumulator zeros "
                        "stay), as the reference's -splat-to-random")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json")
    p.add_argument("--sanitize", choices=["", "nan"], default="",
                   help="'nan': raise at the first op whose output holds a "
                        "NaN or an Inf")
    args = p.parse_args(argv)

    text = sys.stdin.read() if args.input == "-" else open(args.input).read()
    module = load_module(text)
    if args.register_blocking:
        module.attrs["register_blocking"] = tuple(
            int(x) for x in args.register_blocking.split(","))
    if args.precision != "default":
        module.attrs["precision"] = args.precision
    if args.splat_to_random:
        splat_to_random(module, args.seed)
    out = sys.stdout
    device = args.device
    if args.task_grid:
        from ..parallel.mesh import join_world
        from ..parallel.runner import parse_task_grid
        device, out = join_world(device, parse_task_grid(args.task_grid))
    from ..xsmm import global_cache
    cache = global_cache()
    if args.verbose:
        cache.reset_launches()

    def go():
        run_module(module, args.entry, n=args.n, init_type=args.init_type,
                   seed=args.seed, pipeline=args.pipeline,
                   linalg_to_loops=args.linalg_to_loops,
                   print_result=args.print_result, device=device,
                   out_stream=out, task_grid=args.task_grid,
                   print_mlir=args.print_mlir,
                   sanitize=args.sanitize == "nan")

    if args.profile:
        profile_run(go, args.profile, device)
    else:
        go()
    if args.verbose:
        from .trace import describe
        print(f"kernel cache: {len(cache)} kernels, {cache.stats.hits} "
              f"hits, {cache.stats.misses} misses (builds)", file=sys.stderr)
        from ..xsmm.kernels import describe_plan
        for k in cache.kernels():
            plan = f", {describe_plan(k.plan)}" if k.plan is not None \
                else ""
            print(f"  {describe(k.key)}: {k.launches} launches{plan}",
                  file=sys.stderr)
    if args.task_grid:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
