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
"""

from __future__ import annotations

import os
from typing import Any

import torch

_FILE = "state.pt"


def _flatten(tree, out: list) -> None:
    """The savable leaves of `tree` in order: tensors, optimizer state
    dicts, and plain values (None, numbers, strings)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree.detach().cpu())
    elif isinstance(tree, torch.optim.Optimizer):
        out.append(tree.state_dict())
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):     # QTensor is a NamedTuple
        for x in tree:
            _flatten(x, out)
    else:
        out.append(tree)


def _fill(like, leaves, at: list):
    """`like` with the saved leaves put in, in `_flatten`'s order: tensors
    copied in place, optimizers loaded, plain values replaced; a tensor of
    another shape or dtype is refused."""
    if isinstance(like, torch.Tensor):
        saved = leaves[at[0]]
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
    if isinstance(like, torch.optim.Optimizer):
        like.load_state_dict(leaves[at[0]])
        at[0] += 1
        return like
    if isinstance(like, dict):
        filled = {k: _fill(like[k], leaves, at) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_fill(x, leaves, at) for x in like]
        if isinstance(like, list):
            return items
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    saved = leaves[at[0]]
    at[0] += 1
    return saved


def save_checkpoint(path: str, params: Any, step: int = 0) -> None:
    """Save `params` (any tree of dicts, lists, tuples, QTensors, tensors,
    optimizers and plain values) as step `step` under `path`."""
    d = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(d, exist_ok=True)
    leaves: list = []
    _flatten(params, leaves)
    tmp = os.path.join(d, _FILE + ".tmp")
    torch.save({"leaves": leaves, "step": step}, tmp)
    os.replace(tmp, os.path.join(d, _FILE))


def restore_checkpoint(path: str, like: Any, step: int = 0):
    """(params, step) of step `step` under `path`, restored into `like`, a
    tree of the saved tree's structure (see the module's docstring)."""
    f = os.path.join(os.path.abspath(path), f"step_{step}", _FILE)
    state = torch.load(f, map_location="cpu", weights_only=True)
    leaves, at = state["leaves"], [0]
    out = _fill(like, leaves, at)
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
