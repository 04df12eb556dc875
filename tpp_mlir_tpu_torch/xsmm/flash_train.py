"""Flash attention for training: B14 forward and B18 backward as one
differentiable op.

The port of `tpp_mlir_tpu/xsmm/flash_train.py:244-295` (`_flash_vjp`,
`flash_attention_train`). The forward saves (q, k, v, o, lse2), O(S·D) per
head; the backward recomputes the softmax from the base-2 log-sum-exp.
Both kernels (`csrc/flash_train.cu`) read the (B, S, H, D) layout through
its strides, so the four transposes the JAX function makes around its
(B, H, S, D) kernels are gone. On a CUDA tensor the kernels always run:
the VMEM gates that size TPU programs (`flash_train_fits`, `_hpp`) have no
counterpart. On a CPU tensor the wrappers run the plain versions.
"""

from __future__ import annotations

import torch

from .cache import global_cache
from .flags import FlashTrainBwdKey, FlashTrainKey


class FlashAttnTrain(torch.autograd.Function):
    """o = attention(q, k, v) over contiguous (B, S, H, D) operands with as
    many K/V heads as query heads; o in the operand dtype."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        B, S, H, D = q.shape
        key = FlashTrainKey(batch=B, heads=H, seq=S, head_dim=D,
                            dtype="bf16" if q.dtype == torch.bfloat16
                            else "f32", causal=causal, scale=float(scale))
        o, lse2 = global_cache().dispatch(key)(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.key = key
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse2 = ctx.saved_tensors
        # delta = rowsum(dO * O) in f32, outside the kernel as the JAX
        # backward computes it (flash_train.py:260), as (B, H, S)
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = global_cache().dispatch(FlashTrainBwdKey(**vars(ctx.key)))
        dq, dk, dv = bwd(q, k, v, g.to(q.dtype).contiguous(), lse2, delta)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, scale: float, causal: bool = True):
    """Attention for the training path over (B, S, H, D) operands, returning
    (B, S, H, D) in the operand dtype, differentiable through B14/B18. GQA
    K/V (fewer heads than q) are repeated outside the autograd Function, so
    autograd sums each group's gradients, as `jnp.repeat`'s transpose does
    in the JAX function."""
    H = q.shape[2]
    if k.shape[2] != H:
        g = H // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return FlashAttnTrain.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), scale, causal)
