#!/usr/bin/env python
"""Torch transformer ingestion: stock nn.TransformerEncoderLayer -> five
fused kernels on the port.

The pipeline turns LayerNorm -> MultiheadAttention -> residual ->
LayerNorm -> FFN -> residual into:

    QKV GEMM (merged, LayerNorm prologue in-kernel)
    attention (ONE [Q|K|V] packed operand, token layout)
    out-projection (residual rides the accumulator)
    fc1 (LayerNorm prologue + gelu epilogue)
    fc2 (residual accumulator)

    python examples/torch/04_transformer_import.py [--device cuda|cpu]
"""

import argparse

import torch

from tpp_mlir_tpu_torch.frontend import import_torch
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime import compile as tpp_compile

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda")
args = p.parse_args()

torch.manual_seed(0)
layer = torch.nn.TransformerEncoderLayer(
    d_model=256, nhead=4, dim_feedforward=1024, batch_first=True,
    norm_first=True, activation="gelu").eval()

module = import_torch(layer, (2, 64, 256))
run_pipeline(module, "default-tpp-passes")
print("=== lowered IR (five kernels) ===")
print(module)

x = torch.randn(2, 64, 256)
with torch.no_grad():
    want = layer(x)
got = tpp_compile(module, device=args.device)(x.to(args.device))
# f32 "default": the kernels round their operands to bf16
print("max |tpp - torch|:", float((got.float().cpu() - want).abs().max()))
