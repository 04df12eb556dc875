"""The MLP training step over a (dp, tp) mesh: the port of
`tpp_mlir_tpu/parallel/train.py`.

SPMD over ranks (mesh.py): the batch is split over dp, and the layers are
Megatron's alternating tensor parallelism over tp. Even layers are
column-parallel (W split on N, bias local), one `ops.trainable.mlp_layer`
launch (B1 with bias + ReLU) a shard after `mark_replicated`; odd layers are
row-parallel (W split on K): `ops.trainable.matmul` (B1, beta 0), then
`row_parallel_psum` over tp, then bias + ReLU; an odd layer count ends in
`gather_cols`. With the kernels off both GEMMs are `f32_matmul`. The loss is
dp-local and the grads take one mean over dp after the backward
(collectives.py). On one device every collective is the identity.

The step works on this rank's shards: lay the full params out with
`shard_tree(params, param_specs(n), mesh)` and the batch with
`shard_tree(x, P("dp"), mesh)`; `gather_tree` reads them back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.trainable import f32_matmul, matmul, mlp_layer
from ..serving.engine import _from_numpy
from ..utils.target import resolve_device
from .collectives import (gather_cols, mark_replicated, mean_over,
                          row_parallel_psum)
from .mesh import P, as_mesh

_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def mlp_init(layers, dtype="float32", seed: int = 0, device="cuda"):
    """He-initialized ((w, b), ...) for the layer-size chain `layers`, as
    the JAX mlp_init makes them (w ~ N(0, 2/K), b = 0). The numbers come
    from numpy's default_rng(seed), not jax.random; carry JAX weights
    across with `mlp_params_from_numpy`."""
    device = resolve_device(device)
    dt = _DTYPES[dtype]
    rng = np.random.default_rng(seed)
    params = []
    for K, N in zip(layers[:-1], layers[1:]):
        w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)
                             * np.float32(np.sqrt(2.0 / K)))
        params.append((w.to(device=device, dtype=dt),
                       torch.zeros(N, dtype=dt, device=device)))
    return tuple(params)


def numpy_leaf(a, device) -> torch.Tensor:
    """One array of a JAX params tree passed as numpy (f32, or bf16 as
    ml_dtypes or uint16 bits) as a tensor, bit for bit."""
    a = np.asarray(a)
    bf16 = a.dtype == np.uint16 or a.dtype.name == "bfloat16"
    return _from_numpy(a, torch.bfloat16 if bf16 else torch.float32, device)


def mlp_params_from_numpy(params, device="cuda"):
    """((w, b), ...) from the JAX mlp_init's tuples passed as numpy arrays,
    bit for bit."""
    device = resolve_device(device)
    return tuple((numpy_leaf(w, device), numpy_leaf(b, device))
                 for w, b in params)


def param_specs(n_layers: int, tp_axis: str = "tp"):
    """Specs for alternating column/row tensor parallelism."""
    return [(P(None, tp_axis), P(tp_axis)) if i % 2 == 0 else
            (P(tp_axis, None), P()) for i in range(n_layers)]


def _forward_local(params, x, use_kernels: bool,
                   precision: str = "default", tp=None):
    """The MLP chain on this rank's shards; tp is the tp group (None: one
    device)."""
    h = x
    for i, (w, b) in enumerate(params):
        if i % 2 == 0:       # column parallel: one fused kernel a shard
            h = mark_replicated(h, tp)
            h = mlp_layer(h, w, b, precision) if use_kernels else \
                torch.relu(f32_matmul(h, w) + b).to(h.dtype)
        else:                # row parallel: GEMM, sum over tp, bias + relu
            z = matmul(h, w, precision) if use_kernels else f32_matmul(h, w)
            z = row_parallel_psum(z, tp)
            h = torch.relu(z + b).to(h.dtype)
    if len(params) % 2:      # ends column-parallel: gather the features
        h = gather_cols(h, tp, 1)
    return h


def mse_loss(out, y):
    return torch.mean((out.float() - y.float()) ** 2)


def _check_layers(params, layers, mesh=None, tp_axis: str = "tp") -> None:
    """The params must be the shards of the chain `layers` on `mesh`."""
    k = mesh.size(tp_axis) if mesh is not None else 1
    want = [(K, N // k) if i % 2 == 0 else (K // k, N) for i, (K, N) in
            enumerate(zip(layers[:-1], layers[1:]))]
    if len(params) != len(want) or any(
            tuple(w.shape) != s for (w, _), s in zip(params, want)):
        raise ValueError(f"params do not match the layer chain {layers} "
                         f"over tp={k}")


def make_train_step(layers, lr: float = 1e-3, use_kernels: bool | None = None,
                    device="cuda", mesh=None, precision: str = "default",
                    dp_axis: str = "dp", tp_axis: str = "tp"):
    """Return `step(params, x, y) -> (params, loss)`: one SGD step of the
    MLP over `layers` on this rank's shards (params by `param_specs`, x and
    y split over dp), new params returned (the inputs are not changed) and
    the dp mean of the loss. `mesh` is a Mesh, a {axis: size} mapping or
    None (one device). use_kernels (the JAX `use_pallas`) defaults to the
    device being CUDA; precision is the GEMM keys' ("default" rounds f32
    operands to bf16, as the compiled TPU kernels do; "highest" keeps
    f32)."""
    device = resolve_device(device)
    mesh = as_mesh(mesh)
    tp, dp = mesh.group(tp_axis), mesh.group(dp_axis)
    if use_kernels is None:
        use_kernels = device.type == "cuda"

    def step(params, x, y):
        _check_layers(params, layers, mesh, tp_axis)
        leaves = [t.detach().requires_grad_(True) for wb in params
                  for t in wb]
        pairs = tuple(zip(leaves[0::2], leaves[1::2]))
        loss = mse_loss(_forward_local(pairs, x, use_kernels, precision, tp),
                        y)
        grads = [mean_over(g, dp) for g in torch.autograd.grad(loss, leaves)]
        with torch.no_grad():
            new = [(t - lr * g).to(t.dtype) for t, g in zip(leaves, grads)]
        return tuple(zip(new[0::2], new[1::2])), mean_over(loss.detach(), dp)

    return step
