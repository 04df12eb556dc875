"""Pipeline parallelism (pp): the GPipe microbatch schedule over a mesh
axis, the port of `tpp_mlir_tpu/parallel/pipeline.py`.

Stage s holds layer s's weights. The schedule runs n_micro + P - 1 ticks;
each tick every stage computes its layer on the microbatch it holds and
`ring_shift`s the result to the next stage (a pair of isend/irecv: a ring of
blocking sends would deadlock). Stage 0 injects a fresh microbatch per tick,
the last stage collects outputs, and one `row_parallel_psum` broadcasts them
(zeros elsewhere). The layers are `ops.trainable.mlp_layer` (B1 with bias +
ReLU) with the kernels on, else the f32-accumulated PyTorch form.

Autograd runs the schedule in reverse, the cotangents hopping back through
`ring_shift`'s backward. Every rank builds the same graph: the stage choice
is a `torch.where` on the stage index, as the JAX body's `jnp.where` is, so
each rank runs the same backward collectives in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.trainable import mlp_layer
from ..serving.engine import _f32mm
from ..utils.target import resolve_device
from .collectives import mean_over, ring_shift, row_parallel_psum
from .mesh import P, as_mesh
from .optim import make_sharded_optim_step
from .train import _DTYPES, numpy_leaf


def pipeline_init(d: int, n_stages: int, dtype="float32", seed: int = 0,
                  device="cuda") -> dict:
    """Per-stage (w, b) of an n_stages chain of d->d layers, stacked on the
    lead (stage) axis: w (P, d, d) ~ N(0, 1/d), b (P, d) zero; numbers from
    numpy's default_rng(seed) (carry JAX weights with
    `pipeline_params_from_numpy`)."""
    device = resolve_device(device)
    w = np.random.default_rng(seed).standard_normal(
        (n_stages, d, d), dtype=np.float32) * np.float32(np.sqrt(1.0 / d))
    dt = _DTYPES[dtype]
    return {"w": torch.from_numpy(w).to(device=device, dtype=dt),
            "b": torch.zeros(n_stages, d, dtype=dt, device=device)}


def pipeline_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The JAX pipeline_init's {"w", "b"} passed as numpy arrays."""
    device = resolve_device(device)
    return {k: numpy_leaf(tree[k], device) for k in ("w", "b")}


def pipeline_param_specs(pp_axis: str = "pp") -> dict:
    return {"w": P(pp_axis, None, None), "b": P(pp_axis, None)}


def _layer(x, w, b, use_kernels: bool):
    if use_kernels:
        return mlp_layer(x, w, b)
    return torch.relu(_f32mm(x, w) + b.float()).to(x.dtype)


def _pipeline_forward_local(params, xs, nstages: int, stage: int, pp,
                            use_kernels: bool):
    """This stage's tick loop; returns every microbatch's output (n_micro,
    mb, d), the same on every stage."""
    w, b = params["w"][0], params["b"][0]        # this rank's stage
    n_micro = xs.shape[0]
    first = torch.tensor(stage == 0, device=xs.device)
    state = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
    for t in range(n_micro + nstages - 1):
        # stage 0 injects microbatch t; the others take last tick's arrival
        x_in = torch.where(first, xs[min(t, n_micro - 1)], state)
        y = _layer(x_in, w, b, use_kernels)
        pos = t - (nstages - 1)                   # the last stage emits it
        if pos >= 0:
            write = torch.tensor(stage == nstages - 1, device=xs.device)
            outs[pos] = torch.where(write, y, outs[pos])
        if t < n_micro + nstages - 2:             # the last hop is unused
            state = ring_shift(y, pp)
    return row_parallel_psum(torch.stack(outs), pp)


def make_pipeline_forward(mesh, d: int, pp_axis: str = "pp",
                          use_kernels: bool | None = None):
    """Return `forward(params, xs) -> ys` on this rank's stage: xs (n_micro,
    mb, d) replicated, params one stage per rank by `pipeline_param_specs`;
    ys = every stage applied in order (bias + relu each), on every rank.
    use_kernels defaults to xs being on CUDA."""
    mesh = as_mesh(mesh)
    nstages, stage, pp = mesh.size(pp_axis), mesh.index(pp_axis), \
        mesh.group(pp_axis)
    del d

    def forward(params, xs):
        kernels = xs.is_cuda if use_kernels is None else use_kernels
        return _pipeline_forward_local(params, xs, nstages, stage, pp,
                                       kernels)

    return forward


def make_pipeline_train_step(mesh, d: int, optimizer, pp_axis: str = "pp",
                             dp_axis: str | None = None,
                             use_kernels: bool | None = None):
    """GPipe training: `(step, init_opt_state)`, `step(params, opt_state,
    xs, ys) -> (params, opt_state, loss)` on this rank's stage (and, with
    dp_axis, its dp slice of the microbatch rows: xs/ys split on dim 1),
    the MSE over the pipeline's outputs, one update of the rank's stage a
    step; with dp_axis the grads and loss take one mean over dp."""
    mesh = as_mesh(mesh)
    forward = make_pipeline_forward(mesh, d, pp_axis, use_kernels)
    dp = mesh.group(dp_axis)

    def grads_fn(params, xs, ys):
        leaves = [params["b"], params["w"]]       # tree_leaves order
        out = forward(params, xs)
        loss = torch.mean((out.float() - ys.float()) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        return mean_over(loss.detach(), dp), [mean_over(g, dp)
                                              for g in grads]

    return make_sharded_optim_step(mesh, optimizer,
                                   pipeline_param_specs(pp_axis), grads_fn,
                                   dp_axis or pp_axis, False)


def pipeline_reference(params, xs):
    """Unsharded oracle: every stage applied in order to each microbatch."""
    out = xs
    for s in range(params["w"].shape[0]):
        out = torch.stack([_layer(out[i], params["w"][s], params["b"][s],
                                  False) for i in range(out.shape[0])])
    return out
