"""The GPT training step over a (dp, tp) mesh: the port of
`tpp_mlir_tpu/parallel/gpt_train.py`.

The forward mirrors the serving prefill's math (LayerNorm, f32-accumulated
contractions rounded to the model dtype, exact-erf GELU), so the step-0
loss equals the cross-entropy of `make_prefill`'s logits. Attention is
`xsmm.flash_train.flash_attention_train` (B14 forward, B18 backward,
csrc/flash_train.cu) or the composed PyTorch attention; `flash_attn=None`
takes the kernels on CUDA and the composed form elsewhere (the TPU's VMEM
gate, gpt_train.py:63-70 there, is not carried). The params are the serving
engine's per-layer list (`init_params`, `params_from_numpy`), not the JAX
step's stacked arrays: PyTorch runs the layers in a Python loop.

Sharding is the Megatron transformer recipe, as there: the batch over dp
(a dp-local loss, the grads' mean over dp after the backward); q/k/v and
fc1 column-parallel (each tp rank holds heads/tp heads and its fc1
columns, `mark_replicated` before them), attention local to the rank's
heads (B14/B18 at heads/tp), out-proj and fc2 row-parallel with one
`row_parallel_psum` of the f32 partial product each; embeddings and norms
replicated. The LM head is replicated, or with `vocab_parallel` split over
the vocab with the vocab-parallel cross-entropy (`_vocab_parallel_loss`).
The specs are `serving.engine.decode_param_specs` (per-layer list), so a
model trains and serves under one layout. `zero1` splits the optimizer
moments over dp (optim.py).

A MoE configuration (`n_experts > 0`, gpt_train.py:92-101 there) trains its
sparse-expert FFN in the form `moe_prefill_form` names: the scan form (the
default, and "sorted"), which is the JAX step's own, or "grouped", the
autograd Function of the serving engine's grouped form (B16 forward and
dgrad, B17 weight gradient; `csrc/grouped_gemm.cu`) at the keys'
`precision`. The JAX package reaches its grouped core only through
`jax.grad` of `make_prefill`; the port's prefill has no derivative on the
card (`torch.mm(..., out_dtype=f32)`), so its step picks the form by the
same config field (ROADMAP queue C). Its experts are replicated: MoE under
tp > 1 is refused in the JAX package's words (ep sharding is
`parallel/moe.py`).

Refused: a configuration the training forward does not model (RMSNorm,
RoPE, SwiGLU: the LLaMA preset), since the JAX forward always runs
LayerNorm with biases, learned positions and a GELU FFN (gpt_train.py:
75-115 there) and the port does not train a model other than the one it
serves (queue C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.trainable import f32_matmul
from ..serving.engine import (GptConfig, _gather, _ln, _moe_ffn_grouped,
                              _moe_ffn_scan, composed_causal_attention)
from ..utils.target import resolve_device
from ..xsmm.flash_train import flash_attention_train
from ..xsmm.reference import DTYPES
from .collectives import (mark_replicated, mean_over, pmax_stopgrad,
                          row_parallel_psum)
from .mesh import P, as_mesh, mesh_shape
from .optim import make_sharded_optim_step, tree_leaves


def _check_config(cfg: GptConfig) -> None:
    odd = [name for name in ("rms_norm", "rope", "swiglu")
           if getattr(cfg, name)]
    if odd:
        raise NotImplementedError(
            f"{', '.join(odd)}: the training forward is LayerNorm, learned "
            f"positions and a GELU FFN, as the JAX step's is; training the "
            f"LLaMA preset is ROADMAP queue C")


def _dot(x, w, b):
    """The f32-accumulated contraction + bias in f32, cast to x's dtype."""
    return (f32_matmul(x, w) + b.float()).to(x.dtype)


def _moe_ffn(h, blk, cfg: GptConfig, precision: str):
    """The MoE block's FFN on (B, S, E): the grouped Function, or the scan
    form over the differentiable f32_matmul."""
    rows = h.reshape(-1, h.shape[-1])
    if cfg.moe_prefill_form == "grouped":
        y = _moe_ffn_grouped(rows, blk, cfg, kernels=True,
                             precision=precision)
    else:
        y = _moe_ffn_scan(rows, blk, cfg.top_k, mm=f32_matmul)
    return y.reshape(h.shape)


def _gpt_forward_local(params, ids, cfg: GptConfig, flash_attn: bool,
                       precision: str = "default", tp=None,
                       with_head: bool = True):
    """Causal LM forward on this rank's shards -> (B, S, V) f32 logits
    (replicated over tp), or with_head=False the (B, S, E) final-normed
    activations."""
    _check_config(cfg)
    B, S = ids.shape
    if S > cfg.max_seq:
        raise ValueError(f"sequence {S} exceeds max_seq {cfg.max_seq} "
                         f"(wpe table)")
    D = cfg.head_dim
    scale = D ** -0.5
    attn = flash_attention_train if flash_attn else composed_causal_attention
    x = (_gather(params["wte"], ids)
         + _gather(params["wpe"], torch.arange(S, device=ids.device))
         ).to(DTYPES[cfg.dtype])
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1_g"], blk["ln1_b"])
        # a tp-replicated activation meets tp-sharded weights
        h = mark_replicated(h, tp)
        q = _dot(h, blk["wq"], blk["bq"]).reshape(B, S, -1, D)
        k = _dot(h, blk["wk"], blk["bk"]).reshape(B, S, -1, D)
        v = _dot(h, blk["wv"], blk["bv"]).reshape(B, S, -1, D)
        a = attn(q, k, v, scale).reshape(B, S, -1).to(x.dtype)
        y = row_parallel_psum(f32_matmul(a, blk["wo"]), tp)
        x = x + (y + blk["bo"].float()).to(x.dtype)
        h = _ln(x, blk["ln2_g"], blk["ln2_b"])
        if cfg.n_experts:
            x = x + _moe_ffn(h, blk, cfg, precision)
        else:
            h = mark_replicated(h, tp)
            h = F.gelu(_dot(h, blk["w1"], blk["b1"]).float()).to(x.dtype)
            y = row_parallel_psum(f32_matmul(h, blk["w2"]), tp)
            x = x + (y + blk["b2"].float()).to(x.dtype)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    if not with_head:
        return x
    return f32_matmul(x, params["lm_head"])


def next_token_loss(logits, ids):
    """Mean next-token cross-entropy: logits[:, t] scores ids[:, t + 1]."""
    if ids.shape[1] < 2:
        raise ValueError("next-token loss needs at least 2 tokens per "
                         "sequence")
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = logp.gather(-1, ids[:, 1:, None].long())[..., 0]
    return -picked.mean()


def _vocab_parallel_loss(x, lm_head_local, ids, tp, shard: int):
    """Next-token CE with the LM head split over the vocab on tp: the
    stable log-softmax assembled from per-shard partials (gpt_train.py:
    131-167 there). The max shift takes no gradient (`pmax_stopgrad`: the
    CE is invariant to it); the sum of exps and the picked target logit are
    partials summed by `row_parallel_psum`."""
    x = mark_replicated(x, tp)              # sliced contraction below
    logits = f32_matmul(x[:, :-1], lm_head_local)      # (B, S-1, Vl) f32
    Vl = logits.shape[-1]
    m = pmax_stopgrad(logits.amax(-1).detach(), tp)    # (B, S-1)
    z = logits - m[..., None]
    se = row_parallel_psum(torch.exp(z).sum(-1), tp)
    local = ids[:, 1:].long() - shard * Vl
    valid = (local >= 0) & (local < Vl)
    picked = z.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    picked = row_parallel_psum(torch.where(valid, picked, 0.0), tp)
    return torch.mean(torch.log(se) - picked)


def gpt_param_specs(cfg: GptConfig, tp_axis: str = "tp",
                    vocab_parallel: bool = False):
    """The training step's specs: `decode_param_specs`, with the LM head
    split over the vocab under vocab_parallel."""
    from ..serving.engine import decode_param_specs
    specs = decode_param_specs(cfg, tp_axis)
    if vocab_parallel:
        specs["lm_head"] = P(None, tp_axis)
    return specs


def _check_tp(cfg: GptConfig, ntp: int, vocab_parallel: bool) -> None:
    """The JAX step's guards (gpt_train.py:186-197 there), in its words."""
    if cfg.n_experts and ntp > 1:
        raise NotImplementedError(
            "MoE GPT training shards experts over ep (parallel/moe.py), "
            "not tp -- use a dp-only mesh")
    for what, n in (("heads", cfg.heads), ("kv_heads", cfg.kv_h)) + (
            (("vocab", cfg.vocab),) if vocab_parallel else ()):
        if n % ntp:
            raise ValueError(f"tp training needs {what} {n} divisible by "
                             f"tp {ntp}")


def make_gpt_train_step(cfg: GptConfig, optimizer,
                        flash_attn: bool | None = None, device="cuda",
                        mesh=None, zero1: bool = False,
                        vocab_parallel: bool = False,
                        precision: str = "default", dp_axis: str = "dp",
                        tp_axis: str = "tp"):
    """Return `(step, init_opt_state)`: `step(params, opt_state, ids) ->
    (params, opt_state, loss)` over this rank's shards of the serving params
    (per-layer list, laid out by `gpt_param_specs`) and its dp slice of the
    ids, one optimizer update per step, params updated in place, the loss
    the dp mean; `optimizer` is a torch.optim constructor (`optim.sgd`,
    `optim.adamw`). `mesh` is a Mesh, a {axis: size} mapping or None (one
    device). `precision` is the grouped MoE form's kernel keys' ("default"
    rounds f32 operands to bf16, as `make_train_step`'s keys do)."""
    device = resolve_device(device)
    _check_config(cfg)
    _check_tp(cfg, mesh_shape(mesh).get(tp_axis, 1), vocab_parallel)
    mesh = as_mesh(mesh)
    tp, dp = mesh.group(tp_axis), mesh.group(dp_axis)
    shard = mesh.index(tp_axis)
    if flash_attn is None:
        flash_attn = device.type == "cuda"

    def loss_fn(params, ids):
        if vocab_parallel:
            x = _gpt_forward_local(params, ids, cfg, flash_attn, precision,
                                   tp, with_head=False)
            return _vocab_parallel_loss(x, params["lm_head"], ids, tp, shard)
        return next_token_loss(_gpt_forward_local(
            params, ids, cfg, flash_attn, precision, tp), ids)

    def grads_fn(params, ids):
        loss = loss_fn(params, ids)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return mean_over(loss.detach(), dp), [mean_over(g, dp)
                                              for g in grads]

    return make_sharded_optim_step(
        mesh, optimizer, gpt_param_specs(cfg, tp_axis, vocab_parallel),
        grads_fn, dp_axis, zero1)
