#!/usr/bin/env python
"""Serve a GPT-family model on the port: prefill + KV-cache decode,
sampling knobs, a Megatron tensor-parallel decode step over the world's
ranks, the int8 stack, speculative decoding and continuous batching.

CLI equivalent:
    python -m tpp_mlir_tpu_torch.tools.tpp_serve --embed 256 --layers 4 \
        --steps 16 --temperature 0.8 --top-k 40

    python examples/torch/05_serving.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from tpp_mlir_tpu_torch.serving import (GptConfig, init_params,
                                        make_decode_step, make_generate,
                                        make_prefill, make_tp_decode_step,
                                        stack_params)

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda")
args = p.parse_args()
dev = args.device

cfg = GptConfig(vocab=512, embed=256, heads=4, layers=4, mlp_ratio=4,
                max_seq=128, dtype="f32")
# the port keeps the per-layer list (a Python loop over layers; on the card
# the decode step is replayed from a CUDA graph); stack_params takes either
# of the JAX package's layouts
params = stack_params(init_params(cfg, seed=0, device=dev))
prompt = torch.from_numpy(
    np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)).to(dev)

# --- one-shot generation: prefill + decode, nucleus sampling ---
gen = make_generate(cfg, steps=12, temperature=0.8, top_k=40, top_p=0.95)
toks = gen(params, prompt, torch.Generator(device=dev).manual_seed(0))
print("sampled:", toks[0].tolist())

# --- explicit prefill / stepwise decode (the serving-loop shape) ---
logits, cache = make_prefill(cfg)(params, prompt)
step = make_decode_step(cfg)
tok = logits[:, -1].argmax(-1).int()
out = []
for _ in range(8):
    logits, cache = step(params, cache, tok)   # the cache advances in place
    tok = logits.argmax(-1).int()
    out.append(tok.tolist())
print("greedy: ", [o[0] for o in out])

# --- tensor-parallel decode: KV cache sharded over heads ---
# a world of one here (NCCL on the card, gloo on the CPU); under torchrun
# with tp ranks the heads split over them
from tpp_mlir_tpu_torch.parallel import make_mesh, shard_tree
from tpp_mlir_tpu_torch.parallel.mesh import join_world
from tpp_mlir_tpu_torch.serving import decode_cache_specs, decode_param_specs

device, log = join_world(dev)
tp = dist.get_world_size()
if cfg.heads % tp == 0:
    import copy
    mesh = make_mesh({"tp": tp})
    tp_step = make_tp_decode_step(mesh, cfg)
    tp_cache = shard_tree(copy.deepcopy(cache), decode_cache_specs(cfg), mesh)
    tp_logits, _ = tp_step(shard_tree(params, decode_param_specs(cfg), mesh),
                           tp_cache, tok)
    want, _ = step(params, copy.deepcopy(cache), tok)
    print(f"tp={tp} decode matches:",
          bool(torch.allclose(tp_logits, want, atol=1e-4)), file=log)

# --- weight-only int8 + int8 KV cache: the low-bit serving stack ---
from tpp_mlir_tpu_torch.serving import quantize_params, quantized_bytes

qcfg = GptConfig(vocab=512, embed=256, heads=4, layers=4, mlp_ratio=4,
                 max_seq=128, dtype="f32", kv_quant="int8")
qparams = quantize_params(params)          # QTensor leaves
full = sum(v.numel() * v.element_size() for k, v in params.items()
           if k != "blocks") + sum(v.numel() * v.element_size()
                                   for blk in params["blocks"]
                                   for v in blk.values())
print(f"int8 params: {quantized_bytes(qparams):,} bytes (full {full:,})")
qlogits, qcache = make_prefill(qcfg)(qparams, prompt)
qtok = qlogits[:, -1].argmax(-1).int()
qlog2, _ = make_decode_step(qcfg)(qparams, qcache, qtok)
_, fcache = make_prefill(cfg)(params, prompt)   # same position, full prec
flog2, _ = step(params, fcache, qtok)
drift = float((qlog2 - flog2).norm() / flog2.norm())
print(f"int8 stack logits drift vs full precision: {drift:.3%}")

# --- speculative decoding: draft K tokens, verify in ONE target pass ---
# greedy speculative emits exactly the target's greedy stream; the draft
# only changes the speed (a random draft: acceptance ~0, output exact)
from tpp_mlir_tpu_torch.serving import make_speculative_generate

dcfg = GptConfig(vocab=512, embed=128, heads=4, layers=1, mlp_ratio=2,
                 max_seq=128, dtype="f32")
draft = stack_params(init_params(dcfg, seed=7, device=dev))
spec = make_speculative_generate(cfg, dcfg, steps=10, k=3)
stoks, stats = spec(params, draft, prompt[:1])
greedy = make_generate(cfg, steps=10, temperature=0.0)(params, prompt[:1])
print("speculative == target greedy:", bool((stoks == greedy).all()),
      f"(acceptance {int(stats['accepted'])}/{int(stats['drafted'])})")

# --- continuous batching: slot scheduler over the slotted decode step ---
# requests of different lengths flow through a fixed array of slots; a
# finished slot is refilled from the queue at once (no batch drain)
from tpp_mlir_tpu_torch.serving import BatchingEngine

eng = BatchingEngine(init_params(cfg, seed=0, device=dev), cfg, slots=2,
                     sync_steps=4, buckets=(16, 32), seed=0)
rng = np.random.default_rng(1)
rids = [eng.submit(rng.integers(0, cfg.vocab, n), max_new=8)
        for n in (5, 20, 9, 31, 13)]
done = eng.run()
for rid in rids:
    print(f"continuous req {rid}: {done[rid]}")
dist.destroy_process_group()
