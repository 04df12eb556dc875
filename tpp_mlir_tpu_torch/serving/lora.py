"""LoRA / QLoRA fine-tuning for the serving GPT family: the port of
`tpp_mlir_tpu/serving/lora.py`.

Every targeted weight W gains a trainable delta W' = W + (alpha / r) A @ B
with A (in, r) and B (r, out), r << min(in, out); the base stays frozen, so
a step's gradients and optimizer state are O(r (in + out)) a weight. Where
the base is a `QTensor` (int8 or packed int4, `quant.py`), the merged
weight is its dequantized f32 form plus the delta (QLoRA): gradients reach
A and B only, and the payload is never written.

Adapters mirror the params shape-generically: a weight (..., in, out) gets
A (..., in, r) and B (..., r, out), so a MoE block's expert stacks
(n_experts, E, F) and the JAX package's stacked (L, in, out) layout adapt
through the same code. `merge_lora` accepts either layout of params and
adapters and returns the port's one layout (a per-layer list).

The train step (`make_lora_train_step`) merges in its forward each step
and takes the gradient through the serving engine's prefill
(`engine.make_prefill`, differentiable: B14 forward and B18 backward for
attention on the card, `ops.trainable.f32_matmul` for the contractions,
and with `GptConfig.remat` each layer recomputed in the backward). The
optimizer is a `parallel.optim` constructor over the adapter leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.target import resolve_device
from .quant import QTensor, dequantize

ALL_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _weight_shape(w) -> tuple:
    """A base weight's shape, through a QTensor (its logical shape)."""
    return w.dims if isinstance(w, QTensor) else tuple(w.shape)


def _dense(w):
    """A base weight as a float tensor (dequantized if a QTensor)."""
    return dequantize(w) if isinstance(w, QTensor) else w


def lora_init(params: dict, rank: int = 8, targets=("wq", "wv"),
              seed: int = 0, dtype: torch.dtype | None = None,
              device="cuda") -> dict:
    """Zero-delta adapters for every targeted block weight: A ~ N(0, 1/in)
    from a torch.Generator seeded with `seed` (its numbers differ from
    jax.random's; carry JAX adapters with `adapters_from_numpy`), B = 0, so
    the first forward is the base model's. `targets` is a tuple of weight
    names or "all" (ALL_TARGETS). Returns {"blocks": [{name: {"a": A,
    "b": B}} a layer]}, or for a stacked params tree the stacked form
    {"blocks": {name: {"a": (L, in, r), "b": (L, r, out)}}}."""
    device = resolve_device(device)
    if targets == "all":
        targets = ALL_TARGETS
    dt = dtype or torch.float32
    blocks = params["blocks"]
    stacked = isinstance(blocks, dict)
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for blk in [blocks] if stacked else blocks:
        ad = {}
        for name in targets:
            if name not in blk:
                continue
            shp = _weight_shape(blk[name])
            if len(shp) < 2:
                continue
            a = torch.randn(shp[:-1] + (rank,), generator=g, device=device)
            ad[name] = {"a": (a * shp[-2] ** -0.5).to(dt),
                        "b": torch.zeros(shp[:-2] + (rank, shp[-1]),
                                         dtype=dt, device=device)}
        if not ad:
            raise ValueError(f"no LoRA targets {targets} in block "
                             f"{sorted(blk)}")
        out.append(ad)
    return {"blocks": out[0] if stacked else out}


def _adapter_layers(blocks) -> list[dict]:
    """Adapters as a per-layer list, from either layout (a stacked leaf's
    layer i is a view, so gradients reach the stacked leaf)."""
    if not isinstance(blocks, dict):
        return blocks
    L = next(iter(blocks.values()))["a"].shape[0]
    return [{name: {k: t[i] for k, t in ab.items()}
             for name, ab in blocks.items()} for i in range(L)]


def _freeze(w):
    if isinstance(w, QTensor):
        return w._replace(**{f: getattr(w, f).detach()
                             for f in ("q", "scale", "qt")
                             if getattr(w, f) is not None})
    return w.detach()


def merge_lora(params: dict, adapters: dict, alpha: float = 16.0,
               train: bool = False) -> dict:
    """Params with every adapted weight replaced by W + (alpha / r) A @ B,
    in f32 and cast to W's dtype (a QTensor base stays f32: dequantized,
    ready to re-quantize). `train=True` detaches the base leaves, so the
    gradient reaches only the adapters (the LoRA freeze); the default bakes
    the deltas in for serving, under no_grad: the merged weights carry no
    autograd history, so a prefill over them takes no gradient path.
    Either layout in; the per-layer list out."""
    from .engine import stack_params

    if not train:
        with torch.no_grad():
            return merge_lora(params, adapters, alpha, train=True)
    blocks = stack_params(params)["blocks"]
    ads = _adapter_layers(adapters["blocks"])
    if len(blocks) != len(ads):
        raise ValueError(f"{len(blocks)} layers of params, {len(ads)} of "
                         f"adapters")
    merged = []
    for blk, ad in zip(blocks, ads):
        nb = {}
        for name, w in blk.items():
            w = _freeze(w)
            if name in ad:
                a, b = ad[name]["a"].float(), ad[name]["b"].float()
                base = _dense(w).float()
                w = (base + (alpha / a.shape[-1]) * (a @ b)).to(base.dtype
                    if isinstance(w, QTensor) else w.dtype)
            nb[name] = w
        merged.append(nb)
    out = {k: _freeze(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = merged
    return out


def make_lora_train_step(cfg, optimizer, alpha: float = 16.0,
                         use_kernels: bool | None = None):
    """Return `(step, init)` for adapter-only training: `init(adapters)`
    makes the adapter leaves trainable and returns `optimizer` over them
    (`parallel.optim.sgd`, `adamw`); `step(params, adapters, opt_state,
    ids) -> (adapters, opt_state, loss)` takes the next-token
    cross-entropy of the engine prefill over the merged weights, and one
    optimizer update of the adapters, in place. `params` (the frozen base,
    float or QTensor) is never written. `use_kernels` is the prefill's
    (default: the params are on CUDA)."""
    from ..parallel.gpt_train import next_token_loss
    from ..parallel.optim import make_optim_step, tree_leaves
    from .engine import make_prefill

    prefill = make_prefill(cfg, use_kernels=use_kernels)

    def grads_fn(adapters, params, ids):
        merged = merge_lora(params, adapters, alpha=alpha, train=True)
        logits, _ = prefill(merged, ids)
        loss = next_token_loss(logits, ids)
        return loss.detach(), torch.autograd.grad(loss,
                                                  tree_leaves(adapters))

    opt_step, init = make_optim_step(optimizer, grads_fn)

    def step(params, adapters, opt_state, ids):
        return opt_step(adapters, opt_state, params, ids)

    return step, init


def adapters_from_numpy(tree: dict, device="cuda") -> dict:
    """A JAX adapter tree (`lora_init`'s, per-layer or stacked) passed as
    numpy arrays, as the port's adapters, bit for bit and in its layout."""
    from .engine import _from_numpy

    device = resolve_device(device)
    blocks = tree["blocks"]

    def tensor(a):
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16" or a.dtype == np.uint16
        return _from_numpy(a, torch.bfloat16 if bf16 else torch.float32,
                           device)

    def layer(ad):
        return {name: {k: tensor(v) for k, v in ab.items()}
                for name, ab in ad.items()}
    return {"blocks": layer(blocks) if isinstance(blocks, dict)
            else [layer(ad) for ad in blocks]}
