"""tpp-run on PyTorch/CUDA: lower, execute, time and print IR programs.

The port's counterpart of `tpp_mlir_tpu/tools/tpp_run.py` (the reference
tpp-run: deterministic arg init, a perf.bench timing loop, result printing):

  tpp-gen --batch=256 --layers=1024,1024,1024,1024 --bias --relu \\
      | python -m tpp_mlir_tpu_torch.tools.tpp_run - -n 100
  python -m tpp_mlir_tpu_torch.tools.tpp_run model.ir --print -seed 3
  python -m tpp_mlir_tpu_torch.tools.tpp_run model.ir --linalg-to-loops

`--device` defaults to cuda; with no CUDA device it raises rather than
running on the CPU. `--device cpu` runs the kernels' plain versions.

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
from ..runtime.executor import bench_label, in_kernel_bench, time_in_kernel
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


def run_module(module: Module, func_name: str = "entry", n: int = 0,
               init_type: str = "normal", seed: int = 0,
               pipeline: str = "default-tpp-passes",
               linalg_to_loops: bool = False, print_result: bool = False,
               device: str | torch.device = "cuda",
               out_stream=None, bench_mode: str = "auto",
               task_grid: str = "") -> dict:
    """Lower (unless linalg_to_loops), run once, and with n > 0 time n
    chained iterations: inside one kernel launch where the function is one
    kernel with a warm bench (B4, B5, B11) and bench_mode is "auto", else
    in a loop (result["bench"] says which). With `task_grid` every rank of
    the world runs the program at its dp share of the batch
    (`parallel.runner.local_batch`, `task_grid_run`), the outputs gathered,
    timed in a loop. Returns the module, outputs, device and timing."""
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
    if not linalg_to_loops:
        PassManager([pipeline]).run(module)
    wrapper = wrap_bench_main(module, func_name, n) \
        if n > 0 and not task_grid else None
    if not task_grid:
        args = init_args(module, func_name, init_type, seed, device)
        flops = model_flops(module)
    fn = tpp_compile(module, func_name, device)
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
                               bench_mode=bench_mode)(*args)
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
    p.add_argument("--task-grid", "-parallel-task-grid", default="",
                   help="split the batch over a (dp, tp) mesh of ranks, "
                        "e.g. '2x1' (the reference's --parallel-task-grid); "
                        "run under torchrun")
    args = p.parse_args(argv)

    text = sys.stdin.read() if args.input == "-" else open(args.input).read()
    module = load_module(text)
    if args.precision != "default":
        module.attrs["precision"] = args.precision
    out = sys.stdout
    device = args.device
    if args.task_grid:
        from ..parallel.mesh import join_world
        from ..parallel.runner import parse_task_grid
        device, out = join_world(device, parse_task_grid(args.task_grid))
    run_module(module, args.entry, n=args.n, init_type=args.init_type,
               seed=args.seed, pipeline=args.pipeline,
               linalg_to_loops=args.linalg_to_loops,
               print_result=args.print_result, device=device,
               out_stream=out, task_grid=args.task_grid)
    if args.task_grid:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
