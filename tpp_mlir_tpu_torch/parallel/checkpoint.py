"""Checkpoint and restore of training state: the port of
`tpp_mlir_tpu/parallel/checkpoint.py`.

The JAX package's layout is kept: a checkpoint of step n is the directory
`<path>/step_<n>`, and `latest_step` reads the largest n there. orbax is
replaced by `torch.save` of one file, `state.pt`, which `torch.load` reads
with `weights_only=True` (its default): no pickled objects, so a
checkpoint runs no code when it is read. That loader refuses a `QTensor`
or a `torch.optim.Optimizer`, so the tree is flattened to what it takes:
the tensors (as CPU copies), an optimizer's `state_dict()`, and plain
values, in the tree's order. The structure is not stored: `restore_checkpoint`
walks the `like` tree it is given (as the JAX function restores into the
`like` tree's shapes) and copies the saved values into its tensors in place
and into its optimizers by `load_state_dict`, so an optimizer made over
those tensors keeps its references and a resumed run continues the saved
one exactly.

Over a mesh, `specs` (the params' spec tree, None at a ShardedOptim) says
how the tree is laid out: `save_checkpoint` gathers it to the full tree
(a ZeRO-1 state's moments to their global shapes) and rank 0 writes it;
`restore_checkpoint` reads the full tree on every rank and takes the
rank's shards, so a state saved on one mesh restores onto another (JAX:
orbax restores into the `like` tree's shardings).
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist

from .mesh import P, gather_tree, shard_tensor
from .optim import ShardedOptim

_FILE = "state.pt"
_OPTIMIZERS = (torch.optim.Optimizer, ShardedOptim)


def _flatten(tree, out: list) -> None:
    """The savable leaves of `tree` in order: tensors, optimizer state
    dicts, and plain values (None, numbers, strings)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree.detach().cpu())
    elif isinstance(tree, _OPTIMIZERS):
        out.append(tree.state_dict())
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):     # QTensor is a NamedTuple
        for x in tree:
            _flatten(x, out)
    else:
        out.append(tree)


def _leaf_specs(like, specs, out: list) -> None:
    """The spec of each of `like`'s leaves, in `_flatten`'s order."""
    if isinstance(like, dict):
        for k in sorted(like):
            _leaf_specs(like[k], None if specs is None else specs[k], out)
    elif isinstance(like, (list, tuple)) and not isinstance(like, P):
        if isinstance(specs, P) or specs is None:
            specs = [specs] * len(like)
        for x, s in zip(like, specs, strict=True):
            _leaf_specs(x, s, out)
    else:
        out.append(specs)


def _fill(like, leaves, at: list, specs=None, mesh=None):
    """`like` with the saved leaves put in, in `_flatten`'s order: tensors
    copied in place (the rank's shard of a saved full tensor, by `specs`,
    the per-leaf spec list), optimizers loaded, plain values replaced; a
    tensor of another shape or dtype is refused."""
    if isinstance(like, torch.Tensor):
        saved = leaves[at[0]]
        if specs is not None and specs[at[0]] is not None \
                and isinstance(saved, torch.Tensor):
            saved = shard_tensor(saved, specs[at[0]], mesh)
        at[0] += 1
        if not isinstance(saved, torch.Tensor) or saved.shape != like.shape \
                or saved.dtype != like.dtype:
            raise ValueError(
                f"checkpoint leaf {at[0] - 1} does not fit the like tree: "
                f"saved {getattr(saved, 'shape', saved)} "
                f"{getattr(saved, 'dtype', '')}, like {tuple(like.shape)} "
                f"{like.dtype}")
        with torch.no_grad():
            like.copy_(saved)
        return like
    if isinstance(like, _OPTIMIZERS):
        like.load_state_dict(leaves[at[0]])
        at[0] += 1
        return like
    if isinstance(like, dict):
        filled = {k: _fill(like[k], leaves, at, specs, mesh)
                  for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_fill(x, leaves, at, specs, mesh) for x in like]
        if isinstance(like, list):
            return items
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    saved = leaves[at[0]]
    at[0] += 1
    return saved


def save_checkpoint(path: str, params: Any, step: int = 0, specs=None,
                    mesh=None) -> None:
    """Save `params` (any tree of dicts, lists, tuples, QTensors, tensors,
    optimizers and plain values) as step `step` under `path`; over a mesh,
    every rank calls it with the tree's `specs` (module docstring)."""
    if specs is not None:
        params = gather_tree(params, specs, mesh)
    leaves: list = []
    _flatten(params, leaves)
    if not dist.is_initialized() or dist.get_rank() == 0:
        d = os.path.join(os.path.abspath(path), f"step_{step}")
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, _FILE + ".tmp")
        torch.save({"leaves": leaves, "step": step}, tmp)
        os.replace(tmp, os.path.join(d, _FILE))
    if dist.is_initialized():
        dist.barrier()


def restore_checkpoint(path: str, like: Any, step: int = 0, specs=None,
                       mesh=None):
    """(params, step) of step `step` under `path`, restored into `like`, a
    tree of the saved tree's structure (see the module's docstring); over
    a mesh with the tree's `specs`, into the rank's shards."""
    f = os.path.join(os.path.abspath(path), f"step_{step}", _FILE)
    state = torch.load(f, map_location="cpu", weights_only=True)
    leaves, at = state["leaves"], [0]
    per_leaf = None
    if specs is not None:
        per_leaf = []
        _leaf_specs(like, specs, per_leaf)
    out = _fill(like, leaves, at, per_leaf, mesh)
    if at[0] != len(leaves):
        raise ValueError(f"the like tree takes {at[0]} leaves, the "
                         f"checkpoint holds {len(leaves)}")
    return out, state["step"]


def latest_step(path: str) -> int | None:
    """The largest n of the `step_<n>` directories under `path`, or None."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None
