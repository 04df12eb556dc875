"""Weight-only int8 and int4 quantization for the serving engine.

The port of `tpp_mlir_tpu/serving/quant.py`. Per-output-channel symmetric:
a weight W (in, out) used as `x @ W` stores round(col / scale), clipped to
+-qmax, with scale = max|col| / qmax per output column (qmax 127 for int8,
7 for int4), so the scale factors out of the contraction exactly,
`x @ (q * scale) == (x @ q) * scale`, and the engine computes the
right-hand form. `torch.round` rounds half to even like `jnp.round`, and
the division and the scale are the same f32 operations, so the payloads
and scales are bit-identical to the JAX package's on the same f32 input.

int4 payloads are packed two to a byte along the last dim (`pack_int4`:
element 2i in the low nibble, 2i + 1 in the high one, two's complement; an
odd last dim pads one zero nibble), so they take half of int8's bytes, as
XLA stores `jnp.int4` packed on the TPU. `torch.int4` is not used: it is a
placeholder dtype with almost no kernels. The engine unpacks to int8 and
casts to the activation dtype in PyTorch, where XLA fuses the convert into
the dot; the values -7..7 are exact in bf16, so `(x @ q) * scale` stays
exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

QMAX = {8: 127.0, 4: 7.0}


def pack_int4(v: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] (..., n) -> uint8 (..., ceil(n / 2)), two
    two's-complement nibbles a byte: element 2i low, 2i + 1 high."""
    if v.shape[-1] % 2:
        v = torch.cat([v, v.new_zeros(*v.shape[:-1], 1)], -1)
    u = (v & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(p: torch.Tensor, n: int) -> torch.Tensor:
    """pack_int4's inverse: uint8 (..., ceil(n / 2)) -> int8 (..., n)."""
    v = torch.stack([p & 0xF, p >> 4], -1).reshape(*p.shape[:-1], -1)
    return (v[..., :n].to(torch.int8) ^ 8) - 8


class QTensor(NamedTuple):
    """Symmetric per-output-channel quantized weight: ``values() * scale``
    recovers the weight. ``q`` is the payload: int8 with the weight's shape
    (bits 8), or uint8 with two int4 values a byte along the last dim
    (bits 4, `pack_int4`). ``scale`` is f32 with the contraction
    (second-to-last) dim collapsed to 1, (in, out) -> (1, out), so it
    broadcasts against the matmul result. ``shape`` is the weight's shape
    where ``q``'s is not it (bits 4). ``qt``, where present, is the int8
    values' K-major (out, in) copy, made once where int8-compute weights
    are placed (`with_kmajor`): the int8 compute GEMM's wgmma body takes
    8-bit operands K-major only, and reads it in place of a transpose per
    call. The decode step's weight-only route reads ``q``."""

    q: torch.Tensor
    scale: torch.Tensor
    qt: torch.Tensor | None = None
    bits: int = 8
    shape: tuple | None = None

    @property
    def dims(self) -> tuple:
        """The weight's (logical) shape."""
        return tuple(self.q.shape) if self.shape is None else self.shape

    def values(self) -> torch.Tensor:
        """The integer payload as int8 at the weight's shape."""
        if self.bits == 8:
            return self.q
        return unpack_int4(self.q, self.dims[-1])

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """values()[idx] along dim 0, unpacking only the rows taken."""
        got = self.q.index_select(0, idx)
        return got if self.bits == 8 else unpack_int4(got, self.dims[-1])


def from_values(q: torch.Tensor, scale: torch.Tensor,
                bits: int = 8) -> QTensor:
    """A QTensor from int8 values (packed here for bits 4)."""
    if bits == 8:
        return QTensor(q=q, scale=scale)
    return QTensor(q=pack_int4(q), scale=scale, bits=4,
                   shape=tuple(q.shape))


def quantize(w: torch.Tensor, axis: int = -2, bits: int = 8) -> QTensor:
    """Quantize one weight per output channel along ``axis`` (the
    contraction dim; -2 for (in, out) layouts, -1 for gathered rows).
    bits 8 (qmax 127) or 4 (qmax 7, packed): round, clip, then cast, as
    the JAX package does, so no value wraps at the clip edge."""
    if bits not in QMAX:
        raise ValueError(f"bits must be 8 or 4: {bits}")
    qmax = QMAX[bits]
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, 1.0)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    return from_values(q, scale, bits)


def dequantize(t):
    """The f32 weight (tests and oracles only; the engine never does this)."""
    if not isinstance(t, QTensor):
        return t
    return t.values().float() * t.scale


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
        return w._replace(qt=w.values().t().contiguous())
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
    ``q``). A packed int4 payload counts its bytes, half of int8's (the
    JAX package counts half a byte an element: the same for even rows)."""
    leaves = [v for k, v in params.items() if k != "blocks"]
    for blk in params["blocks"]:
        leaves += list(blk.values())
    total = 0
    for leaf in leaves:
        for t in ((leaf.q, leaf.scale) if isinstance(leaf, QTensor)
                  else (leaf,)):
            total += t.numel() * t.element_size()
    return total
