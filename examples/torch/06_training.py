#!/usr/bin/env python
"""Training on the port over a mesh of ranks: torch.optim optimizers,
gradient accumulation, ZeRO-1 sharded optimizer state, the GPT-family train
step that shares its parameter layout with the serving engine, and
LoRA / QLoRA fine-tuning.

One process is a world of one (NCCL on the card, gloo on the CPU); under
torchrun the mesh spans the world:

    python examples/torch/06_training.py [--device cuda|cpu]
    python -m torch.distributed.run --nproc-per-node 2 \
        examples/torch/06_training.py --device cpu
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from tpp_mlir_tpu_torch.parallel import (P, adamw, make_gpt_train_step,
                                         make_mesh, make_optim_train_step,
                                         mlp_init, param_specs, shard_tree)
from tpp_mlir_tpu_torch.parallel.mesh import join_world

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda")
args = p.parse_args()

device, log = join_world(args.device)
n = dist.get_world_size()
if n < 2:
    print(f"single device ({device}); dp=1 tp=1 mesh", file=log)
mesh = make_mesh({"dp": max(1, n // 2), "tp": min(2, n)})

# --- MLP chain: AdamW + gradient accumulation + ZeRO-1 --------------------
# an optimizer is a torch.optim constructor over the rank's leaves
# (parallel.adamw writes optax's defaults out)
layers = (256, 512, 256, 256)
params = shard_tree(mlp_init(layers, seed=0, device=device),
                    param_specs(len(layers) - 1), mesh)
step, init_state = make_optim_train_step(
    layers, adamw(1e-3), accum_steps=4, zero1=True, mesh=mesh,
    device=device)
state = init_state(params)

rng = np.random.default_rng(0)
dp = mesh.shape["dp"]
x = torch.from_numpy(rng.normal(size=(32 * dp, layers[0])).astype(
    np.float32)).to(device)
y = torch.from_numpy(rng.normal(size=(32 * dp, layers[-1])).astype(
    np.float32)).to(device)
for i in range(5):
    params, state, loss = step(params, state, shard_tree(x, P("dp"), mesh),
                               shard_tree(y, P("dp"), mesh))
    print(f"mlp step {i}: loss {float(loss):.4f}", file=log)

# --- GPT family: train under the SERVING param layout ---------------------
# (one checkpoint trains with dp x tp Megatron sharding and serves with the
# tp decode step, no re-layout)
from tpp_mlir_tpu_torch.parallel import gpt_param_specs
from tpp_mlir_tpu_torch.serving import GptConfig, init_params, stack_params

cfg = GptConfig(vocab=512, embed=128, heads=4, layers=2, mlp_ratio=4,
                max_seq=64, dtype="f32")
gparams = shard_tree(stack_params(init_params(cfg, seed=1, device=device)),
                     gpt_param_specs(cfg), mesh)
gstep, ginit = make_gpt_train_step(cfg, adamw(1e-3, eps=1e-4), mesh=mesh,
                                   device=device)
gstate = ginit(gparams)
ids = torch.from_numpy(rng.integers(0, cfg.vocab, (4 * dp, 48)).astype(
    np.int32)).to(device)
for i in range(5):
    gparams, gstate, loss = gstep(gparams, gstate,
                                  shard_tree(ids, P("dp"), mesh))
    print(f"gpt step {i}: next-token CE {float(loss):.4f}", file=log)

# --- LoRA / QLoRA: parameter-efficient fine-tuning -------------------------
# (serving/lora.py: a frozen base -- float or int8 QTensor -- plus rank-r
# adapters; only O(r*(in+out)) params get gradients and optimizer state)
from tpp_mlir_tpu_torch.serving import (lora_init, make_lora_train_step,
                                        make_prefill, merge_lora,
                                        quantize_params)

qbase = stack_params(quantize_params(init_params(cfg, seed=1,
                                                 device=device)))
adapters = lora_init(qbase, rank=8, targets=("wq", "wv"), device=device)
lstep, linit = make_lora_train_step(cfg, torch.optim.Adam,
                                    use_kernels=False)
lstate = linit(adapters)
for i in range(5):
    adapters, lstate, loss = lstep(qbase, adapters, lstate, ids)
    print(f"qlora step {i}: next-token CE {float(loss):.4f}", file=log)
merged = merge_lora(qbase, adapters)   # bake the deltas in -> float params
logits, _ = make_prefill(cfg, use_kernels=False)(merged, ids)
print(f"merged model serves: logits {tuple(logits.shape)}", file=log)
dist.destroy_process_group()
