#!/usr/bin/env python
"""End-to-end on the PyTorch/CUDA port: generate an MLP, inspect the
pipeline, execute, benchmark.

Equivalent reference commands:
    mlir-gen --batch=256 --layers=1024,1024 --bias --relu | \
        tpp-opt --default-tpp-passes | tpp-run -n 100

    python examples/torch/01_mlp_pipeline.py [--device cuda|cpu]
"""

import argparse

from tpp_mlir_tpu_torch.models.mlp import MlpConfig, build_mlp
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime import bench, compile, tensor_init

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda")
p.add_argument("-n", type=int, default=100, help="timed forwards")
args = p.parse_args()

cfg = MlpConfig(batch=256, layers=(1024, 1024, 1024, 1024),
                float_type="bf16", bias=True, relu=True, kernel="const")
module = build_mlp(cfg)
print("=== generated IR ===")
print(module)

run_pipeline(module, "default-tpp-passes")
print("=== lowered IR (one fused whole-chain kernel) ===")
print(module)

fn = compile(module, device=args.device)
x = tensor_init("normal", (256, 1024), "bf16").to(args.device)
print("output:", tuple(fn(x).shape))

res = bench(fn, (x,), iters=args.n)
print(f"{module.attrs['flops'] / res.mean_seconds / 1e9:.0f} GFLOP/s "
      f"on {res.device}")
