"""Collectives with the derivatives SPMD training needs: the port of
`tpp_mlir_tpu/parallel/collectives.py`.

The convention is the JAX module's: every cotangent in the backward pass is
the COMPLETE derivative of the (dp-local) loss. Each autograd Function
states the true dual of its collective:

- `row_parallel_psum`: all-reduce (sum) forward, identity backward: each
  shard's partial receives the complete cotangent of the sum once.
- `gather_cols`: tiled all-gather forward, the rank's own block backward.
- `mark_replicated`: identity forward on a value replicated over the axis
  that meets a sharded weight; the backward all-reduces the per-shard
  PARTIAL cotangents into the complete one.
- `pmax_stopgrad`: all-reduce (max) forward, zero backward (exact for an
  invariance of the loss, as the max shift of a stable log-softmax).

Two more, which the JAX package gets from autodiff of `ppermute` and
`all_to_all`: `ring_shift` (send to the next rank of the axis, receive from
the previous; the backward shifts the other way) and `all_to_all` (dim 0
split in equal blocks, block j to rank j; its own inverse, so the backward
is the same exchange).

`torch.distributed.nn.functional.all_reduce` is not used: its backward
all-reduces again, the over-count by the axis size that the JAX module's
docstring measured. The grads of dp-replicated params take one mean over
dp after the backward (`mean_over`), outside any derivative.

A group of None is a one-device axis (a mesh with no world, or an axis the
mesh lacks): every function is then the identity. A gloo group's
collective on CUDA tensors runs on a pinned host copy of the tensor, and
the result is copied back (gloo's own CUDA paths do the same for the few
collectives they take); an NCCL group runs on the device. `staged(group)`
says which a group takes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def staged(group, t: torch.Tensor | None = None) -> bool:
    """Whether a collective over `group` on `t` runs through host memory:
    a gloo group and a CUDA tensor (every CUDA tensor when t is None)."""
    return group is not None and dist.get_backend(group) == "gloo" and (
        t is None or t.is_cuda)


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _on(t: torch.Tensor, group):
    """(tensor the collective runs on, its device of origin)."""
    if staged(group, t):
        return _host(t), t.device
    return t.contiguous(), None


def _back(t: torch.Tensor, dev):
    return t if dev is None else t.to(dev)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor holding the reduction of `t` over the group."""
    if group is None:
        return t
    h, dev = _on(t, group)
    h = h.clone() if dev is None else h
    dist.all_reduce(h, op=op, group=group)
    return _back(h, dev)


def mean_over(t: torch.Tensor, group) -> torch.Tensor:
    """jax.lax.pmean: the sum over the group, divided by its size in t's
    dtype."""
    if group is None:
        return t
    return all_reduce(t, group) / dist.get_world_size(group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks concatenated along `dim`, in group rank order
    (jax.lax.all_gather with tiled=True)."""
    if group is None:
        return t
    h, dev = _on(t, group)
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, h, group=group)
    return _back(torch.cat(parts, dim), dev)


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:     # its own block, to itself
        return t.clone()
    h, dev = _on(t, group)
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=group)
    return _back(out, dev)


def _shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send t to group rank (i + step) % n, receive from (i - step) % n."""
    n = dist.get_world_size(group)
    if n == 1:                              # a ring of one: to itself
        return t.clone()
    i = dist.get_rank(group)
    h, dev = _on(t, group)
    out = torch.empty_like(h)
    peer = dist.get_global_rank
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, h, peer(group, (i + step) % n), group),
        dist.P2POp(dist.irecv, out, peer(group, (i - step) % n), group)])
    for r in reqs:
        r.wait()
    return _back(out, dev)


class _RowParallelPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.i = dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return ct.narrow(ctx.dim, ctx.i * ctx.n, ctx.n), None, None


class _MarkReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct, ctx.group), None


class _PmaxStopgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, ct):
        return torch.zeros_like(ct), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, ct):
        return _shift(ct, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _exchange(ct, ctx.group), None


def row_parallel_psum(x, group):
    """Sum over the group whose result is replicated; backward identity."""
    return x if group is None else _RowParallelPsum.apply(x, group)


def gather_cols(x, group, dim: int = 1):
    """Tiled all-gather along `dim`; backward the rank's own block."""
    return x if group is None else _GatherCols.apply(x, group, dim)


def mark_replicated(x, group):
    """Identity on a value replicated over the group; the backward sums the
    per-shard partial cotangents into the complete one."""
    return x if group is None else _MarkReplicated.apply(x, group)


def pmax_stopgrad(x, group):
    """Max over the group with a zero gradient."""
    return x if group is None else _PmaxStopgrad.apply(x, group)


def ring_shift(x, group):
    """jax.lax.ppermute to the next rank around the group's ring (rank i's
    block arrives at rank i + 1); the backward shifts the other way."""
    return x if group is None else _RingShift.apply(x, group)


def all_to_all(x, group):
    """Dim 0 in equal blocks, block j to group rank j; the received blocks
    stacked in source rank order on dim 0 (jax.lax.all_to_all, tiled, split
    and concat on axis 0). Its own inverse, which is its backward."""
    return x if group is None else _AllToAll.apply(x, group)
