"""Expert parallelism (ep): a switch-routed MoE FFN with its experts split
over a mesh axis and two all-to-all token exchanges, the port of
`tpp_mlir_tpu/parallel/moe.py`.

Tokens and experts split over the same axis (the GShard/Switch layout):
each rank routes its tokens (top-1, a fixed capacity), builds the dense
dispatch tensor, exchanges the per-expert token buffers with the experts'
owners, runs its experts' FFNs, exchanges the results back and combines
them with the gate weights. `all_to_all` splits dim 0, so the ep split dim
is moved to the front before each exchange, and the received blocks are
laid out in JAX's (source rank, position) order (moe.py:88-95 there). The
JAX module computes the FFNs with einsums, and so does the port, with
PyTorch ops and no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.target import resolve_device
from .collectives import all_to_all
from .mesh import P, as_mesh
from .train import _DTYPES, numpy_leaf


def moe_init(d_model: int, d_ff: int, n_experts: int, dtype="float32",
             seed: int = 0, device="cuda") -> dict:
    """Router wr (d_model, E) ~ N(0, 1/d_model), experts w1 (E, d_model,
    d_ff) ~ N(0, 1/d_model) and w2 (E, d_ff, d_model) ~ N(0, 1/d_ff); numbers
    from numpy's default_rng(seed) (carry JAX weights with
    `moe_params_from_numpy`)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    s1, s2 = np.float32(np.sqrt(1.0 / d_model)), np.float32(np.sqrt(1.0 / d_ff))
    shapes = {"wr": ((d_model, n_experts), s1),
              "w1": ((n_experts, d_model, d_ff), s1),
              "w2": ((n_experts, d_ff, d_model), s2)}
    return {k: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * s).to(device=device, dtype=_DTYPES[dtype])
            for k, (shape, s) in shapes.items()}


def moe_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The JAX moe_init's dict passed as numpy arrays, bit for bit."""
    device = resolve_device(device)
    return {k: numpy_leaf(tree[k], device) for k in ("wr", "w1", "w2")}


def moe_param_specs(ep_axis: str = "ep") -> dict:
    return {"wr": P(), "w1": P(ep_axis, None, None),
            "w2": P(ep_axis, None, None)}


def _dispatch(x, wr, n_experts: int, capacity: int):
    """Top-1 switch routing with a fixed per-expert capacity: (dispatch
    (T, E, C) f32 one-hot, combine (T, E, C) f32 gate weights). A token
    past its expert's capacity is dropped (capacity >= T is lossless)."""
    gates = torch.softmax(x.float() @ wr.float(), dim=-1)       # (T, E)
    idx = gates.argmax(-1)
    gate = gates.gather(-1, idx[:, None])[:, 0]
    onehot_e = (idx[:, None] == torch.arange(n_experts, device=x.device)
                ).float()
    # each token's position within its expert's buffer
    pos = (onehot_e.cumsum(0) - 1.0) * onehot_e
    pos_tok = pos.sum(-1).long()
    keep = (pos_tok < capacity).float()
    onehot_c = (pos_tok[:, None] == torch.arange(capacity, device=x.device)
                ).float()
    dispatch = onehot_e[:, :, None] * onehot_c[:, None, :] \
        * keep[:, None, None]
    return dispatch, dispatch * gate[:, None, None]


def _experts(buf, w1, w2):
    h = torch.relu(torch.einsum("ecd,edf->ecf", buf, w1.float()))
    return torch.einsum("ecf,efd->ecd", h, w2.float())


def make_moe_forward(mesh, d_model: int, d_ff: int, n_experts: int,
                     capacity: int | None = None, ep_axis: str = "ep"):
    """Return `forward(params, x) -> y` on this rank's shards: x (tokens/ep,
    d_model), params by `moe_param_specs` (experts split over ep, the
    router replicated); capacity defaults to the rank's token count."""
    mesh = as_mesh(mesh)
    ep, group = mesh.size(ep_axis), mesh.group(ep_axis)
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not split over ep {ep}")
    e_local = n_experts // ep
    del d_ff

    def forward(params, x):
        cap = capacity or x.shape[0]
        dispatch, combine = _dispatch(x, params["wr"], n_experts, cap)
        buf = torch.einsum("tec,td->ecd", dispatch, x.float())  # (E, C, d)
        # to the experts' owners: block j (experts of rank j) to rank j;
        # the received blocks come stacked by source rank
        buf = all_to_all(buf.reshape(ep, e_local, cap, d_model), group)
        buf = buf.permute(1, 0, 2, 3).reshape(e_local, ep * cap, d_model)
        out = _experts(buf, params["w1"], params["w2"])
        # back to the tokens' owners: the (source, position) blocks
        out = out.reshape(e_local, ep, cap, d_model).permute(1, 0, 2, 3)
        out = all_to_all(out.contiguous(), group).reshape(n_experts, cap,
                                                          d_model)
        return torch.einsum("tec,ecd->td", combine, out).to(x.dtype)

    return forward


def moe_reference(params, x, capacity: int | None = None):
    """Unsharded oracle: the same routing and expert math on one device."""
    n_experts = params["wr"].shape[1]
    cap = capacity or x.shape[0]
    dispatch, combine = _dispatch(x, params["wr"], n_experts, cap)
    buf = torch.einsum("tec,td->ecd", dispatch, x.float())
    out = _experts(buf, params["w1"], params["w2"])
    return torch.einsum("tec,ecd->td", combine, out).to(x.dtype)
