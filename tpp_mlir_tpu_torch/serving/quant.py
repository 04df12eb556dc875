"""Weight-only int8 quantization for the serving engine.

The port of `tpp_mlir_tpu/serving/quant.py`. Per-output-channel symmetric
int8: a weight W (in, out) used as `x @ W` stores round(col / scale) with
scale = max|col| / 127 per output column, so the scale factors out of the
contraction exactly, `x @ (q * scale) == (x @ q) * scale`, and the engine
computes the right-hand form. `torch.round` rounds half to even like
`jnp.round`, and the division and the scale are the same f32 operations,
so the payloads and scales are bit-identical to the JAX package's on the
same f32 input.

int4 is not ported: torch has no packed int4 dtype, and int4 values kept
in int8 would not halve the bytes that make int4 worth having. `bits=4`
raises, naming ROADMAP A7 ("packed int4 weights").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT4_TODO = ("int4 weights are not ported: ROADMAP A7, packed int4 weights "
             "(torch has no packed int4 dtype; int4 values stored in int8 "
             "would not halve the bytes)")


class QTensor(NamedTuple):
    """Symmetric per-output-channel int8 weight: ``q * scale`` recovers the
    weight. ``q`` is int8 with the weight's shape; ``scale`` is f32 with the
    contraction (second-to-last) dim collapsed to 1, (in, out) -> (1, out),
    so it broadcasts against the matmul result. ``qt``, where present, is
    ``q``'s K-major (out, in) copy, made once where int8-compute weights
    are placed (`with_kmajor`): the int8 compute GEMM's wgmma body takes
    8-bit operands K-major only, and reads it in place of a transpose per
    call. The decode step's weight-only route reads ``q``."""

    q: torch.Tensor
    scale: torch.Tensor
    qt: torch.Tensor | None = None


def quantize(w: torch.Tensor, axis: int = -2, bits: int = 8) -> QTensor:
    """Quantize one weight per output channel along ``axis`` (the
    contraction dim; -2 for (in, out) layouts, -1 for gathered rows)."""
    if bits == 4:
        raise NotImplementedError(INT4_TODO)
    if bits != 8:
        raise ValueError(f"bits must be 8 (or 4, not ported): {bits}")
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(wf / scale), -127.0, 127.0).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(t):
    """The f32 weight (tests and oracles only; the engine never does this)."""
    if not isinstance(t, QTensor):
        return t
    return t.q.float() * t.scale


# block weights that are matmul operands; norms and biases stay in the model
# dtype (O(E) bytes, precision-critical)
_BLOCK_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _quantized(name: str, blk: dict) -> bool:
    """Whether a block leaf is quantized: a matmul weight, except the expert
    stacks (n_e, E, F) of a MoE block (its router "wr" marks it), which
    stay raw as the JAX package leaves them (quant.py:98-107 there); the
    router is O(E * n_e) and not a matmul weight here."""
    return name in _BLOCK_MATMUL_KEYS and not (
        "wr" in blk and name in ("w1", "w2"))


def quantize_params(params: dict, include_embed: bool = False,
                    bits: int = 8) -> dict:
    """Quantize every block matmul weight and the LM head of an engine
    params dict (a MoE block's expert stacks excepted). ``include_embed``
    also quantizes wte/wpe with per-row scales (rows are gathered)."""
    out = dict(params)
    out["lm_head"] = quantize(params["lm_head"], bits=bits)
    out["blocks"] = [{k: quantize(v, bits=bits) if _quantized(k, blk) else v
                      for k, v in blk.items()} for blk in params["blocks"]]
    if include_embed:
        out["wte"] = quantize(params["wte"], axis=-1, bits=bits)
        if "wpe" in params:     # absent under RoPE
            out["wpe"] = quantize(params["wpe"], axis=-1, bits=bits)
    return out


def _kmajor(w):
    if isinstance(w, QTensor) and w.q.dim() == 2 and w.qt is None:
        return w._replace(qt=w.q.t().contiguous())
    return w


def with_kmajor(params: dict) -> dict:
    """The params with each (in, out) QTensor that int8 compute contracts
    against (block matmul weights, the LM head) given its K-major copy
    ``qt``, made once here: for GPT-2 small 85 MB of block weights and
    38.6 MB of LM head beside the int8 payloads. Leaves that have one, and
    every other leaf, are kept as they are."""
    out = dict(params)
    out["lm_head"] = _kmajor(params["lm_head"])
    out["blocks"] = [{k: _kmajor(v) if k in _BLOCK_MATMUL_KEYS else v
                      for k, v in blk.items()} for blk in params["blocks"]]
    return out


def dequantize_params(params: dict) -> dict:
    """Undo quantize_params: f32 weights where QTensors were."""
    out = {k: dequantize(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: dequantize(v) for k, v in blk.items()}
                     for blk in params["blocks"]]
    return out


def quantize_tokens(x: torch.Tensor, axis: int = -1):
    """Per-token symmetric int8 over ``axis`` (default the trailing head
    dim): the KV-cache and activation form. Returns (q int8 with x's shape,
    scale f32 with ``axis`` dropped)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.round(xf / scale.unsqueeze(axis)).to(torch.int8)
    return q, scale


def quantized_bytes(params: dict) -> int:
    """Total parameter bytes as stored, the K-major copies (QTensor.qt)
    left out: the decode bandwidth denominator (the decode step reads
    ``q``)."""
    leaves = [v for k, v in params.items() if k != "blocks"]
    for blk in params["blocks"]:
        leaves += list(blk.values())
    total = 0
    for leaf in leaves:
        for t in ((leaf.q, leaf.scale) if isinstance(leaf, QTensor)
                  else (leaf,)):
            total += t.numel() * t.element_size()
    return total
