"""The optimizer step on one device: the port of
`tpp_mlir_tpu/parallel/optim.py` (`make_optim_train_step` and the
single-device core of `make_sharded_optim_step`).

An optimizer is a `torch.optim` constructor: a callable that takes the list
of parameter tensors and returns a `torch.optim.Optimizer` (`sgd`, `adamw`
below, or any `functools.partial` of a torch.optim class). The state it
holds is the `opt_state` of the JAX API. Where the JAX step returns new
params, the port's step updates the parameter tensors in place (the
counterpart of buffer donation) and returns them. ZeRO-1 shards optimizer
state over dp; on one device it has nothing to shard and raises, naming
ROADMAP A11.
"""

from __future__ import annotations

import functools

import torch

from ..utils.target import resolve_device
from .train import (_check_layers, _forward_local, check_single_device,
                    mse_loss)


def sgd(lr: float):
    """optax.sgd(lr): p - lr * g."""
    return functools.partial(torch.optim.SGD, lr=lr)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """optax.adamw(lr) with optax's defaults written out (torch's AdamW
    decays by 1e-2 unless told): the same bias-corrected moments, and the
    decay applied to every parameter."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


def tree_leaves(params) -> list[torch.Tensor]:
    """The tensors of a params tree in a fixed order: dict keys sorted (as
    JAX orders them), lists and tuples in order."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in tree_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in tree_leaves(p)]
    return [params]


def make_optim_step(optimizer, grads_fn):
    """Return `(step, init_opt_state)` over `grads_fn(params, *batch) ->
    (loss, grads)`, grads in `tree_leaves(params)` order.
    `init_opt_state(params)` makes the leaves trainable and returns the
    optimizer over them; `step(params, opt_state, *batch) -> (params,
    opt_state, loss)` sets each leaf's .grad and takes one optimizer step,
    updating the params in place."""

    def init_opt_state(params):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return optimizer(leaves)

    def step(params, opt_state, *batch):
        loss, grads = grads_fn(params, *batch)
        for t, g in zip(tree_leaves(params), grads):
            t.grad = g
        opt_state.step()
        return params, opt_state, loss

    return step, init_opt_state


def make_optim_train_step(layers, optimizer, accum_steps: int = 1,
                          zero1: bool = False,
                          use_kernels: bool | None = None, device="cuda",
                          mesh=None, precision: str = "default"):
    """Return `(step, init_opt_state)` for the MLP over `layers` (see
    `train.make_train_step` for use_kernels and precision). accum_steps
    microbatches per step: grads summed in f32, averaged, cast to the
    params' dtype, ONE optimizer update (optim.py:158-178 there)."""
    device = resolve_device(device)
    check_single_device(mesh, "make_optim_train_step")
    if zero1:
        raise NotImplementedError("zero1 shards optimizer state over dp; the "
                                  "port trains on one device (ROADMAP A11)")
    if use_kernels is None:
        use_kernels = device.type == "cuda"

    def loss_fn(params, x, y):
        return mse_loss(_forward_local(params, x, use_kernels, precision), y)

    def grads_fn(params, x, y):
        _check_layers(params, layers)
        leaves = tree_leaves(params)
        if accum_steps == 1:
            loss = loss_fn(params, x, y)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} must be divisible by "
                             f"accum_steps {accum_steps}")
        total = torch.zeros((), device=x.device)
        acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        for xs, ys in zip(x.chunk(accum_steps), y.chunk(accum_steps)):
            loss = loss_fn(params, xs, ys)
            for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                a += g.float()
            total += loss.detach()
        inv = 1.0 / accum_steps
        return total * inv, [(a * inv).to(t.dtype)
                             for a, t in zip(acc, leaves)]

    return make_optim_step(optimizer, grads_fn)
