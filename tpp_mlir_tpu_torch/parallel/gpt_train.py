"""The GPT training step on one device: the port of
`tpp_mlir_tpu/parallel/gpt_train.py` at dp = tp = 1.

The forward mirrors the serving prefill's math (LayerNorm, f32-accumulated
contractions rounded to the model dtype, exact-erf GELU), so the step-0
loss equals the cross-entropy of `make_prefill`'s logits. Attention is
`xsmm.flash_train.flash_attention_train` (B14 forward, B18 backward,
csrc/flash_train.cu) or the composed PyTorch attention; `flash_attn=None`
takes the kernels on CUDA and the composed form elsewhere (the TPU's VMEM
gate, gpt_train.py:63-70 there, is not carried). The params are the serving
engine's per-layer list (`init_params`, `params_from_numpy`), not the JAX
step's stacked arrays: PyTorch runs the layers in a Python loop.

A MoE configuration (`n_experts > 0`, gpt_train.py:92-101 there) trains its
sparse-expert FFN in the form `moe_prefill_form` names: the scan form (the
default, and "sorted"), which is the JAX step's own, or "grouped", the
autograd Function of the serving engine's grouped form (B16 forward and
dgrad, B17 weight gradient; `csrc/grouped_gemm.cu`) at the keys'
`precision`. The JAX package reaches its grouped core only through
`jax.grad` of `make_prefill`; the port's prefill has no derivative on the
card (`torch.mm(..., out_dtype=f32)`), so its step picks the form by the
same config field (ROADMAP queue C).

Refused, each naming the ROADMAP item that ports it: any mesh beyond one
device (MoE included: its experts shard over ep in `parallel/moe.py`),
`vocab_parallel` and `zero1` (A11); a configuration the training forward
does not model (RMSNorm, RoPE, SwiGLU: the LLaMA preset), since the JAX
forward always runs LayerNorm with biases, learned positions and a GELU FFN
(gpt_train.py:75-115 there) and the port does not train a model other than
the one it serves (queue C).
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
from .optim import make_optim_step, tree_leaves
from .train import check_single_device


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
                       precision: str = "default"):
    """Causal LM forward -> (B, S, V) f32 logits (the JAX function at
    tp = 1)."""
    _check_config(cfg)
    B, S = ids.shape
    if S > cfg.max_seq:
        raise ValueError(f"sequence {S} exceeds max_seq {cfg.max_seq} "
                         f"(wpe table)")
    H, KVH, D = cfg.heads, cfg.kv_h, cfg.head_dim
    scale = D ** -0.5
    attn = flash_attention_train if flash_attn else composed_causal_attention
    x = (_gather(params["wte"], ids)
         + _gather(params["wpe"], torch.arange(S, device=ids.device))
         ).to(DTYPES[cfg.dtype])
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1_g"], blk["ln1_b"])
        q = _dot(h, blk["wq"], blk["bq"]).reshape(B, S, H, D)
        k = _dot(h, blk["wk"], blk["bk"]).reshape(B, S, KVH, D)
        v = _dot(h, blk["wv"], blk["bv"]).reshape(B, S, KVH, D)
        a = attn(q, k, v, scale).reshape(B, S, H * D).to(x.dtype)
        x = x + (f32_matmul(a, blk["wo"]) + blk["bo"].float()).to(x.dtype)
        h = _ln(x, blk["ln2_g"], blk["ln2_b"])
        if cfg.n_experts:
            x = x + _moe_ffn(h, blk, cfg, precision)
        else:
            h = F.gelu(_dot(h, blk["w1"], blk["b1"]).float()).to(x.dtype)
            x = x + (f32_matmul(h, blk["w2"])
                     + blk["b2"].float()).to(x.dtype)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return f32_matmul(x, params["lm_head"])


def next_token_loss(logits, ids):
    """Mean next-token cross-entropy: logits[:, t] scores ids[:, t + 1]."""
    if ids.shape[1] < 2:
        raise ValueError("next-token loss needs at least 2 tokens per "
                         "sequence")
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = logp.gather(-1, ids[:, 1:, None].long())[..., 0]
    return -picked.mean()


def make_gpt_train_step(cfg: GptConfig, optimizer,
                        flash_attn: bool | None = None, device="cuda",
                        mesh=None, zero1: bool = False,
                        vocab_parallel: bool = False,
                        precision: str = "default"):
    """Return `(step, init_opt_state)`: `step(params, opt_state, ids) ->
    (params, opt_state, loss)` over the serving params (per-layer list),
    one optimizer update per step, params updated in place; `optimizer` is
    a torch.optim constructor (`optim.sgd`, `optim.adamw`). `precision` is
    the grouped MoE form's kernel keys' ("default" rounds f32 operands to
    bf16, as `make_train_step`'s keys do)."""
    device = resolve_device(device)
    check_single_device(mesh, "make_gpt_train_step")
    if zero1 or vocab_parallel:
        raise NotImplementedError(
            "zero1 and vocab_parallel shard over dp/tp; the port trains on "
            "one device (ROADMAP A11)")
    _check_config(cfg)
    if flash_attn is None:
        flash_attn = device.type == "cuda"

    def grads_fn(params, ids):
        loss = next_token_loss(
            _gpt_forward_local(params, ids, cfg, flash_attn, precision), ids)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(params))

    return make_optim_step(optimizer, grads_fn)
