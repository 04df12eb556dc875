#!/usr/bin/env python
"""Import a torch model; train an MLP dp x tp over a mesh of ranks.

One process is a world of one (NCCL on the card, gloo on the CPU); under
torchrun every rank runs this script and the mesh spans the world:

    python examples/torch/03_torch_and_multichip.py [--device cuda|cpu]
    python -m torch.distributed.run --nproc-per-node 2 \
        examples/torch/03_torch_and_multichip.py --device cpu
"""

import argparse

import torch
import torch.distributed as dist

from tpp_mlir_tpu_torch.frontend import import_torch
from tpp_mlir_tpu_torch.parallel import (P, make_mesh, make_train_step,
                                         mlp_init, param_specs, shard_tree)
from tpp_mlir_tpu_torch.parallel.mesh import join_world
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime import compile

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda")
args = p.parse_args()

# --- torch import (the torch-dynamo ingestion equivalent) ---
model = torch.nn.Sequential(
    torch.nn.Linear(256, 512), torch.nn.ReLU(),
    torch.nn.Linear(512, 256), torch.nn.ReLU(),
)
module = import_torch(model, (32, 256))
run_pipeline(module, "default-tpp-passes")
fn = compile(module, device=args.device)
print("torch import:", tuple(fn(torch.zeros(32, 256,
                                            device=args.device)).shape))

# --- sharded training step (dp x tp over the world's ranks) ---
device, out = join_world(args.device)
n = dist.get_world_size()
mesh = make_mesh({"dp": max(1, n // 2), "tp": 2 if n >= 2 else 1})
layers = (256, 512, 256)
params = mlp_init(layers, device=device)
step = make_train_step(layers, lr=1e-2, mesh=mesh, device=device)
g = torch.Generator(device=device).manual_seed(0)
x = torch.randn(64, 256, generator=g, device=device)
y = torch.randn(64, 256, generator=g, device=device)
params, loss = step(shard_tree(params, param_specs(len(layers) - 1), mesh),
                    shard_tree(x, P("dp"), mesh), shard_tree(y, P("dp"), mesh))
print("train step loss:", float(loss), file=out)
dist.destroy_process_group()
