"""The MLP training step on one device: the port of
`tpp_mlir_tpu/parallel/train.py`.

The JAX step runs SPMD over a (dp, tp) mesh: the batch over dp, alternating
Megatron column/row layers over tp. On one device (dp = tp = 1) its
collectives (`mark_replicated`, `row_parallel_psum`, `gather_cols`,
train.py:53-90) and the dp mean of the grads are identities, so the port's
step is the local step alone; a larger mesh raises, naming ROADMAP A11.
Even layers run `ops.trainable.mlp_layer` (B1 with bias + ReLU), odd ones
`ops.trainable.matmul` (B1, beta 0) and then bias + ReLU, as the JAX step
does with `use_pallas`; with the kernels off both are `f32_matmul`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.trainable import f32_matmul, matmul, mlp_layer
from ..serving.engine import _from_numpy
from ..utils.target import resolve_device

_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def check_single_device(mesh, what: str) -> None:
    """Refuse a mesh of more than one device: `mesh` is None, a mapping of
    axis -> size ({"dp": 1, "tp": 1}), or anything with such a `shape`."""
    if mesh is None:
        return
    shape = dict(getattr(mesh, "shape", mesh))
    if math.prod(shape.values()) != 1:
        raise NotImplementedError(
            f"{what} over the mesh {shape}: the port trains on one device; "
            f"dp/tp sharding is ROADMAP A11")


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


def mlp_params_from_numpy(params, device="cuda"):
    """((w, b), ...) from the JAX mlp_init's tuples passed as numpy arrays
    (f32, or bf16 as ml_dtypes or uint16 bits), bit for bit."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        bf16 = a.dtype == np.uint16 or a.dtype.name == "bfloat16"
        return _from_numpy(a, torch.bfloat16 if bf16 else torch.float32,
                           device)
    return tuple((leaf(w), leaf(b)) for w, b in params)


def _forward_local(params, x, use_kernels: bool,
                   precision: str = "default"):
    """The MLP chain on one device (the JAX function at tp = 1)."""
    h = x
    for i, (w, b) in enumerate(params):
        if i % 2 == 0:       # the column-parallel layer: one fused kernel
            h = mlp_layer(h, w, b, precision) if use_kernels else \
                torch.relu(f32_matmul(h, w) + b).to(h.dtype)
        else:                # the row-parallel layer: GEMM, then bias+relu
            z = matmul(h, w, precision) if use_kernels else f32_matmul(h, w)
            h = torch.relu(z + b).to(h.dtype)
    return h


def mse_loss(out, y):
    return torch.mean((out.float() - y.float()) ** 2)


def _check_layers(params, layers) -> None:
    if len(params) != len(layers) - 1 or any(
            tuple(w.shape) != (k, n)
            for (w, _), k, n in zip(params, layers[:-1], layers[1:])):
        raise ValueError(f"params do not match the layer chain {layers}")


def make_train_step(layers, lr: float = 1e-3, use_kernels: bool | None = None,
                    device="cuda", mesh=None, precision: str = "default"):
    """Return `step(params, x, y) -> (params, loss)`: one SGD step of the
    MLP over `layers`, new params returned (the inputs are not changed).
    use_kernels (the JAX `use_pallas`) defaults to the device being CUDA;
    precision is the GEMM keys' ("default" rounds f32 operands to bf16, as
    the compiled TPU kernels do; "highest" keeps f32)."""
    device = resolve_device(device)
    check_single_device(mesh, "make_train_step")
    if use_kernels is None:
        use_kernels = device.type == "cuda"

    def step(params, x, y):
        _check_layers(params, layers)
        leaves = [t.detach().requires_grad_(True) for wb in params
                  for t in wb]
        pairs = tuple(zip(leaves[0::2], leaves[1::2]))
        loss = mse_loss(_forward_local(pairs, x, use_kernels, precision), y)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new = [(t - lr * g).to(t.dtype) for t, g in zip(leaves, grads)]
        return tuple(zip(new[0::2], new[1::2])), loss.detach()

    return step
