"""The optimizer step: the port of `tpp_mlir_tpu/parallel/optim.py`
(`make_optim_train_step`, `make_sharded_optim_step`, ZeRO-1).

An optimizer is a `torch.optim` constructor: a callable that takes the list
of parameter tensors and returns a `torch.optim.Optimizer` (`sgd`, `adamw`
below, or any `functools.partial` of a torch.optim class). Where the JAX
step returns new params, the port's step updates this rank's parameter
shards in place (the counterpart of buffer donation) and returns them.

ZeRO-1 (`zero1=True`) keeps the JAX layout: each dp rank holds the
optimizer moments of its slice of every param along the param's first dim
that is unsharded and divisible by dp (`_zero1_spec`; a param with no such
dim keeps whole moments). The rank steps its `torch.optim` over slice
tensors whose `.grad` is the (dp-mean) grad's slice, then all-gathers the
updated slices over dp into the param: the moments take 1/dp of the
memory, the params stay replicated over dp. `ZeroRedundancyOptimizer`
shards whole params, not this layout, and is not used. The state is a
`ShardedOptim`, whose `state_dict` gathers the moments to their full
(global) shapes and whose `load_state_dict` takes a rank's slices of them,
so a checkpoint of it restores onto another mesh.
"""

from __future__ import annotations

import functools

import torch

from ..utils.target import resolve_device
from .collectives import all_gather, mean_over
from .mesh import P, as_mesh, gather_tensor, shard_tensor
from .train import _check_layers, _forward_local, mse_loss, param_specs


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


def spec_leaves(specs) -> list:
    """The leaf specs of a spec tree, in `tree_leaves` order."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [t for k in sorted(specs) for t in spec_leaves(specs[k])]
    from ..serving.quant import QTensor
    if isinstance(specs, QTensor):
        raise ValueError("a QTensor weight is not trained")
    return [t for s in specs for t in spec_leaves(s)]


def _zero1_spec(spec, shape, dp_axis: str, ndp: int) -> P:
    """Extend a param spec with dp on the first dim that is unsharded and
    dp-divisible; replicate (unchanged) if none fits."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, n) in enumerate(zip(parts, shape)):
        if ax is None and n % ndp == 0 and n > 0:
            parts[i] = dp_axis
            return P(*parts)
    return P(*parts)


def opt_state_shardings(params, mesh, pspec_tree, dp_axis: str = "dp",
                        zero1: bool = False) -> list:
    """The spec of each param's optimizer moments, in `tree_leaves` order:
    the param's spec, with the dp split of `_zero1_spec` under zero1 (the
    JAX function's NamedSharding tree over the optax state)."""
    ndp = mesh.size(dp_axis)
    specs = spec_leaves(pspec_tree)
    if not zero1:
        return specs
    return [_zero1_spec(s, t.shape, dp_axis, ndp)
            for s, t in zip(specs, tree_leaves(params), strict=True)]


class ShardedOptim:
    """A torch.optim over this rank's ZeRO-1 slices of the params (or the
    params themselves where a param keeps whole moments), and how to put
    the updated slices back (`step`). `state_dict` gathers the moments to
    their global shapes on every rank; `load_state_dict` takes this rank's
    slices of such a state."""

    def __init__(self, optimizer, params, pspec_tree, mesh, dp_axis: str,
                 zero1: bool):
        self.mesh, self.dp_axis = mesh, dp_axis
        self.leaves = tree_leaves(params)
        self.pspecs = spec_leaves(pspec_tree)
        self.mspecs = opt_state_shardings(params, mesh, pspec_tree, dp_axis,
                                          zero1)
        # the dim each param's moments split over dp (None: whole)
        self.dims = [next((i for i, a in enumerate(m) if a == dp_axis), None)
                     if mesh.size(dp_axis) > 1 else None for m in self.mspecs]
        # a slice is a view of its param (a leaf of its own): the update
        # writes the param's own block in place, so a param restored in
        # place is the slice the optimizer steps
        self.slices = []
        for t, d in zip(self.leaves, self.dims):
            t.requires_grad_(True)
            self.slices.append(t if d is None else
                               self._own(t.detach(), d).requires_grad_(True))
        self.optimizer = optimizer(self.slices)

    def _own(self, t, dim):
        n = t.shape[dim] // self.mesh.size(self.dp_axis)
        return t.narrow(dim, self.mesh.index(self.dp_axis) * n, n)

    def step(self, grads) -> None:
        for s, g, d in zip(self.slices, grads, self.dims):
            s.grad = g if d is None else self._own(g, d)
        self.optimizer.step()
        dp = self.mesh.group(self.dp_axis)
        with torch.no_grad():
            for t, s, d in zip(self.leaves, self.slices, self.dims):
                if d is not None:
                    t.copy_(all_gather(s.detach(), dp, d))

    def state_dict(self) -> dict:
        sd = self.optimizer.state_dict()
        full = {}
        for i, st in sd["state"].items():
            full[i] = {k: gather_tensor(v, self.mspecs[i], self.mesh)
                       if isinstance(v, torch.Tensor) and v.dim() else v
                       for k, v in st.items()}
        return {"state": full, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        local = {}
        for i, st in sd["state"].items():
            i = int(i)
            local[i] = {k: shard_tensor(v, self.mspecs[i], self.mesh).to(
                self.slices[i].device)
                if isinstance(v, torch.Tensor) and v.dim() else v
                for k, v in st.items()}
        self.optimizer.load_state_dict({"state": local,
                                        "param_groups": sd["param_groups"]})


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


def make_sharded_optim_step(mesh, optimizer, pspec_tree, grads_fn,
                            dp_axis: str = "dp", zero1: bool = False):
    """`make_optim_step` over a mesh: `grads_fn(params, *batch) -> (loss,
    grads)` on this rank's shards (grads already dp-mean'd). Without zero1
    the state is a torch.optim over the rank's shards (`make_optim_step`);
    with it a `ShardedOptim`."""
    if not zero1:
        return make_optim_step(optimizer, grads_fn)

    def init_opt_state(params):
        return ShardedOptim(optimizer, params, pspec_tree, mesh, dp_axis,
                            zero1)

    def step(params, opt_state, *batch):
        loss, grads = grads_fn(params, *batch)
        opt_state.step(grads)
        return params, opt_state, loss

    return step, init_opt_state


def make_optim_train_step(layers, optimizer, accum_steps: int = 1,
                          zero1: bool = False,
                          use_kernels: bool | None = None, device="cuda",
                          mesh=None, precision: str = "default",
                          dp_axis: str = "dp", tp_axis: str = "tp"):
    """Return `(step, init_opt_state)` for the MLP over `layers` with
    train.make_train_step's sharding (batch over dp, alternating Megatron
    column/row layers over tp; see it for use_kernels and precision).
    accum_steps microbatches per step of the rank's batch: grads summed in
    f32, averaged, cast to the params' dtype, ONE optimizer update
    (optim.py:158-178 there). zero1 splits the optimizer moments over dp
    (module docstring)."""
    device = resolve_device(device)
    mesh = as_mesh(mesh)
    tp, dp = mesh.group(tp_axis), mesh.group(dp_axis)
    if use_kernels is None:
        use_kernels = device.type == "cuda"

    def loss_fn(params, x, y):
        return mse_loss(_forward_local(params, x, use_kernels, precision, tp),
                        y)

    def local_grads(params, x, y):
        _check_layers(params, layers, mesh, tp_axis)
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

    def grads_fn(params, x, y):
        loss, grads = local_grads(params, x, y)
        return mean_over(loss, dp), [mean_over(g, dp) for g in grads]

    return make_sharded_optim_step(
        mesh, optimizer, param_specs(len(layers) - 1, tp_axis), grads_fn,
        dp_axis, zero1)
