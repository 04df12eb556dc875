"""Autoregressive serving engine: prefill + KV-cache decode for the GPT
family, on PyTorch and the port's Hopper kernels.

The port of `tpp_mlir_tpu/serving/engine.py` (GptConfig :36, params :178-300,
norms and RoPE :303-352, contractions :355-435, attention :936-1017, prefill
:1020-1172, decode :1175-1453, extend :1472, sampler :1773, generate :1807),
with the same numerics, function for function. What differs, and why:

- One params layout: a dict whose "blocks" is a list of per-layer dicts.
  `stack_params` and `params_from_numpy` load either of the JAX package's
  trees (per-layer list or stacked (L, ...) arrays) into it; the stacked
  form existed to keep the TPU's HLO small, which eager PyTorch does not
  need. QTensor weights are `quant.QTensor` (q, scale) pairs.
- The cache is updated in place at `pos` (the counterpart of buffer
  donation), and the decode step advances `cache["pos"]` in place. `pos` is
  an int32 device tensor, a scalar or (B,) for a slotted cache; nothing in
  a decode step reads it on the host, so the step can be captured in a CUDA
  graph (`make_generate` replays it per token).
- The kernels: prefill attention goes to `csrc/attention.cu` (FlashMhaKey,
  B7) for every shape, int8 compute to `csrc/int8_gemm.cu` (Int8GemmKey,
  B15) and decode attention to `csrc/decode_attn.cu` (DecodeAttnKey, B13)
  for every variant under "auto" (ROADMAP queue C). `use_kernels` (the
  JAX `use_pallas`) defaults to "the params are on CUDA"; with it off, or
  on the CPU, prefill attention is the composed path, `decode_attn="auto"`
  the einsum path, and a forced kernel runs its plain version
  (`xsmm/reference.py`), as interpret mode does off the TPU.
- The dense projections are PyTorch GEMMs (the JAX package's `jnp.dot`):
  f32 accumulation with an f32 result, TF32 off.

Not ported here: MoE (`n_experts > 0`, ROADMAP A9), the flash training
attention (`flash_attn`, A10/B14), the tp decode (A11), continuous
batching, beam and speculative decoding (A8), int4 weights (A7).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..xsmm import (DecodeAttnKey, FlashMhaKey, Int8GemmKey, global_cache,
                    reference_kernel)
from ..xsmm.reference import DTYPES
from .quant import QTensor, quantize_tokens


# GptConfig fields read only by code not ported yet: any value but the
# default is refused, naming the ROADMAP item that ports the code
_UNPORTED = {name: "A9, MoE" for name in (
    "n_experts", "top_k", "moe_decode_form", "moe_prefill_form",
    "moe_capacity_factor", "moe_group_bm", "moe_group_stacked")}
_UNPORTED["remat"] = "A10, training"


@dataclass(frozen=True)
class GptConfig:
    """The JAX engine's GptConfig, field for field (see engine.py:36 there
    for what each field means). The MoE fields and `remat` take only their
    defaults until ROADMAP A9 and A10 port the code that reads them."""

    vocab: int = 50304
    embed: int = 768
    heads: int = 12
    layers: int = 12
    mlp_ratio: int = 4
    max_seq: int = 1024
    dtype: str = "f32"
    kv_heads: int | None = None
    kv_quant: str | None = None
    n_experts: int = 0
    top_k: int = 2
    moe_decode_form: str = "auto"
    moe_prefill_form: str = "scan"
    moe_capacity_factor: float = 1.25
    moe_group_bm: int = 128
    moe_group_stacked: bool = True
    int8_compute: bool = False
    decode_attn: str = "auto"        # auto | xla (einsum) | pallas (kernel)
    rope: bool = False
    rms_norm: bool = False
    swiglu: bool = False
    rope_theta: float = 10000.0
    kv_packed: bool = False
    remat: bool = False
    flash_attn: bool = False

    @classmethod
    def llama(cls, **kw):
        """LLaMA-2/3-class preset: RoPE + RMSNorm + SwiGLU (pass kv_heads
        for GQA)."""
        kw.setdefault("rope", True)
        kw.setdefault("rms_norm", True)
        kw.setdefault("swiglu", True)
        return cls(**kw)

    def __post_init__(self):
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name, item in _UNPORTED.items():
            if getattr(self, name) != defaults[name]:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: the code that reads it "
                    f"is not ported yet (ROADMAP {item})")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be f32 or bf16: {self.dtype!r}")
        if self.kv_heads is not None and self.heads % self.kv_heads:
            raise ValueError(f"heads {self.heads} not divisible by kv_heads "
                             f"{self.kv_heads}")
        if self.kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8': "
                             f"{self.kv_quant!r}")
        if self.decode_attn not in ("auto", "xla", "pallas"):
            raise ValueError(f"decode_attn must be auto, xla or pallas: "
                             f"{self.decode_attn!r}")
        if self.rope and self.head_dim % 2:
            raise ValueError("RoPE needs an even head_dim")
        if self.kv_packed:
            if self.kv_heads is not None or self.heads % 2:
                raise ValueError("kv_packed is MHA-only and pairs heads")
            if 2 * self.head_dim > 128:
                raise ValueError(f"kv_packed packs two heads per 128-lane "
                                 f"group; head_dim {self.head_dim} is "
                                 f"already lane-full")
            if self.kv_quant is not None:
                raise ValueError("kv_packed is bf16/f32 KV only")
            if self.decode_attn == "xla":
                raise ValueError("kv_packed needs the decode kernel (the "
                                 "packed layout has no einsum path)")

    @property
    def head_dim(self) -> int:
        return self.embed // self.heads

    @property
    def kv_h(self) -> int:
        return self.kv_heads or self.heads

    @property
    def kv_dim(self) -> int:
        return self.kv_h * self.head_dim


# ---------------------------------------------------------------------------
# parameters

def params_from_torch(model, cfg: GptConfig, device="cpu") -> dict:
    """Params from a `tpp_mlir_tpu.models.gpt.GptTorch`; weight matrices are
    stored (in, out), so the forward is x @ W."""
    if cfg.kv_h != cfg.heads:
        raise ValueError("params_from_torch: models/gpt.py is MHA; GQA "
                         "configs use init_params or params_from_numpy")
    dt = DTYPES[cfg.dtype]

    def t(x):
        return x.detach().float().to(device=device, dtype=dt).contiguous()

    E = cfg.embed
    blocks = []
    for blk in model.blocks:
        w = blk.attn.in_proj_weight   # (3E, E) rows [q; k; v]
        b = blk.attn.in_proj_bias
        blocks.append({
            "ln1_g": t(blk.ln1.weight), "ln1_b": t(blk.ln1.bias),
            "wq": t(w[:E].T), "bq": t(b[:E]),
            "wk": t(w[E:2 * E].T), "bk": t(b[E:2 * E]),
            "wv": t(w[2 * E:].T), "bv": t(b[2 * E:]),
            "wo": t(blk.attn.out_proj.weight.T),
            "bo": t(blk.attn.out_proj.bias),
            "ln2_g": t(blk.ln2.weight), "ln2_b": t(blk.ln2.bias),
            "w1": t(blk.fc1.weight.T), "b1": t(blk.fc1.bias),
            "w2": t(blk.fc2.weight.T), "b2": t(blk.fc2.bias),
        })
    return {"wte": t(model.wte.weight), "wpe": t(model.wpe),
            "blocks": blocks, "lnf_g": t(model.ln_f.weight),
            "lnf_b": t(model.ln_f.bias), "lm_head": t(model.lm_head.weight.T)}


def init_params(cfg: GptConfig, seed: int = 0, device="cpu") -> dict:
    """Random params for synthetic serving runs, at the JAX init_params'
    scales, zeros and ones. The values come from a torch.Generator on
    `device` and differ from the JAX package's jax.random stream for the
    same seed; carry JAX weights across with `params_from_numpy`."""
    dt = DTYPES[cfg.dtype]
    E, V, S = cfg.embed, cfg.vocab, cfg.max_seq
    F_ = cfg.mlp_ratio * E
    g = torch.Generator(device=device).manual_seed(seed)

    def nrm(shape, scale):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dt)

    def const(n, v):
        return torch.full((n,), v, dtype=dt, device=device)

    blocks = []
    for _ in range(cfg.layers):
        blk = {
            "ln1_g": const(E, 1.0),
            "wq": nrm((E, E), E ** -0.5), "bq": const(E, 0.0),
            "wk": nrm((E, cfg.kv_dim), E ** -0.5),
            "bk": const(cfg.kv_dim, 0.0),
            "wv": nrm((E, cfg.kv_dim), E ** -0.5),
            "bv": const(cfg.kv_dim, 0.0),
            "wo": nrm((E, E), E ** -0.5), "bo": const(E, 0.0),
            "ln2_g": const(E, 1.0),
        }
        if not cfg.rms_norm:
            blk["ln1_b"] = const(E, 0.0)
            blk["ln2_b"] = const(E, 0.0)
        if cfg.swiglu:      # gate (w1) + up (w3) + down (w2), biasless
            blk["w1"] = nrm((E, F_), E ** -0.5)
            blk["w3"] = nrm((E, F_), E ** -0.5)
            blk["w2"] = nrm((F_, E), F_ ** -0.5)
        else:
            blk["w1"] = nrm((E, F_), E ** -0.5)
            blk["b1"] = const(F_, 0.0)
            blk["w2"] = nrm((F_, E), F_ ** -0.5)
            blk["b2"] = const(E, 0.0)
        blocks.append(blk)
    out = {"wte": nrm((V, E), 0.02), "blocks": blocks,
           "lnf_g": const(E, 1.0), "lm_head": nrm((E, V), E ** -0.5)}
    if not cfg.rope:
        out["wpe"] = nrm((S, E), 0.02)
    if not cfg.rms_norm:
        out["lnf_b"] = const(E, 0.0)
    return out


def stack_params(params: dict) -> dict:
    """The port's one layout from either of the JAX package's trees.

    The JAX `stack_params` stacks the blocks into (L, ...) arrays so that a
    `lax.scan` traces one block; the port runs a Python loop over layers
    and keeps the per-layer list, so a stacked tree is split by layer here
    (QTensor leaves too) and a per-layer tree is returned as it is."""
    blocks = params["blocks"]
    if not isinstance(blocks, dict):
        return params
    first = next(iter(blocks.values()))
    L = (first.q if isinstance(first, QTensor) else first).shape[0]
    out = dict(params)
    out["blocks"] = [{k: QTensor(v.q[i], v.scale[i]) if isinstance(v, QTensor)
                      else v[i] for k, v in blocks.items()}
                     for i in range(L)]
    return out


def _from_numpy(a, dt: torch.dtype, device) -> torch.Tensor:
    """One array of a JAX params tree as a tensor. bf16 arrives as a uint16
    (or ml_dtypes bfloat16) bit view, or as f32 holding bf16-exact values;
    either becomes torch.bfloat16 with no change of bits."""
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy()).to(device)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        if dt != torch.bfloat16:
            raise ValueError(f"bf16 bits for a {dt} leaf")
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if dt == torch.bfloat16:
        b = t.to(torch.bfloat16)
        if not torch.equal(b.float(), t):
            raise ValueError("an f32 leaf for a bf16 config must hold "
                             "bf16-exact values")
        t = b
    return t.to(device)


def params_from_numpy(tree: dict, cfg: GptConfig, device="cpu") -> dict:
    """The port's params from a JAX params tree passed as numpy arrays (per
    layer or stacked), QTensors as (q, scale) pairs: the weight carrier that
    lets both engines run the same weights. Leaves take the config's dtype;
    QTensor payloads stay int8 and their scales f32."""
    dt = DTYPES[cfg.dtype]

    def leaf(x):
        if isinstance(x, tuple) and len(x) == 2:
            return QTensor(_from_numpy(x[0], torch.int8, device),
                           _from_numpy(x[1], torch.float32, device))
        return _from_numpy(x, dt, device)

    blocks = tree["blocks"]
    if isinstance(blocks, dict):         # stacked (L, ...) arrays
        L = cfg.layers
        blocks = [{k: (tuple(np.asarray(t)[i] for t in v)
                       if isinstance(v, tuple) else np.asarray(v)[i])
                   for k, v in blocks.items()} for i in range(L)]
    out = {k: leaf(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [{k: leaf(v) for k, v in blk.items()} for blk in blocks]
    return out


def _use_kernels(params: dict, use_kernels: bool | None) -> bool:
    if use_kernels is not None:
        return use_kernels
    w = params["lm_head"]
    return (w.q if isinstance(w, QTensor) else w).is_cuda


def _kernel(key, use_kernels: bool):
    """The kernel wrapper for `key` (it runs the plain version for CPU
    tensors), or with kernels off the plain version itself."""
    return global_cache().dispatch(key) if use_kernels \
        else reference_kernel(key)


# ---------------------------------------------------------------------------
# norms, RoPE, contractions

def _ln(x, g, b, eps=1e-5):
    xf = x.float()
    d = xf - xf.mean(-1, keepdim=True)
    var = (d * d).mean(-1, keepdim=True)
    return ((d * torch.rsqrt(var + eps)) * g.float() + b.float()).to(x.dtype)


def _rmsnorm(x, g, eps=1e-5):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


def _block_norm(x, blk, which, cfg: GptConfig):
    """LayerNorm or RMSNorm per cfg.rms_norm (RMS has no bias)."""
    if cfg.rms_norm:
        return _rmsnorm(x, blk[f"{which}_g"])
    return _ln(x, blk[f"{which}_g"], blk[f"{which}_b"])


def _final_norm(x, params, cfg: GptConfig):
    if cfg.rms_norm:
        return _rmsnorm(x, params["lnf_g"])
    return _ln(x, params["lnf_g"], params["lnf_b"])


def _rope(x, pos, theta: float):
    """Rotary position embedding, rotate-half, f32 angles. x: (..., H, D);
    pos: (S,) prefill rows, a scalar or (B,) decode positions."""
    half = x.shape[-1] // 2
    xf = x.float()
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = (pos.float()[..., None] * inv)[..., None, :]   # the head axis
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _f32mm(x, w):
    """x (..., K) @ w (K, N) with f32 accumulation and an f32 result (the
    JAX package's preferred_element_type=f32). A bf16 matmul would round
    its result to bf16; on CUDA `out_dtype` keeps it f32, elsewhere the
    operands go up to f32 (bf16 products are exact in f32)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _f32bmm(a, b):
    """Batched a @ b with f32 accumulation and an f32 result."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _mm_int8(x, w: QTensor, b=None, unary=None, kernels=False):
    """The int8 compute route: activation rows quantized per row, then the
    s8 x s8 -> s32 GEMM with the dequantization, bias and unary on the f32
    accumulator (Int8GemmKey, csrc/int8_gemm.cu). Any row count: the TPU's
    padding of rows to 32 was a tile quantum."""
    K, N = x.shape[-1], w.q.shape[-1]
    x2 = x.reshape(-1, K)
    xq, xs = quantize_tokens(x2)                 # (M, K) s8, (M,) f32
    key = Int8GemmKey(m=x2.shape[0], n=N, k=K, out_dtype="f32",
                      has_bias=b is not None, unary_kind=unary)
    args = (xq, w.q, xs, w.scale) + ((b,) if b is not None else ())
    return _kernel(key, kernels)(*args).reshape(*x.shape[:-1], N)


def _int8_rows(x, w, int8: bool) -> bool:
    """Whether a contraction takes the int8 compute route: a QTensor weight,
    int8 compute on, and at least 32 rows (the gate decides the numerics,
    so it is kept; below it the weight-only route runs)."""
    return int8 and isinstance(w, QTensor) and \
        math.prod(x.shape[:-1]) >= 32


def _mm(x, w, int8: bool = False, kernels: bool = False):
    """f32-accumulated contraction; a QTensor weight contracts against its
    int8 payload cast to the activation dtype and scales the result."""
    if isinstance(w, QTensor):
        if _int8_rows(x, w, int8):
            return _mm_int8(x, w, kernels=kernels)
        return _f32mm(x, w.q.to(x.dtype)) * w.scale
    return _f32mm(x, w)


def _dot(x, w, b=None, int8: bool = False, unary: str | None = None,
         kernels: bool = False):
    """Contraction + bias (+ gelu). On the int8 route bias and unary are the
    kernel's epilogue; elsewhere the JAX order exactly: f32 result, + b in
    f32, cast, erf-gelu in f32, cast."""
    if _int8_rows(x, w, int8):
        return _mm_int8(x, w, b=b, unary=unary, kernels=kernels).to(x.dtype)
    y = _mm(x, w)
    if b is not None:
        y = y + b.float()
    y = y.to(x.dtype)
    if unary == "gelu":
        y = F.gelu(y.float()).to(x.dtype)
    elif unary is not None:
        raise NotImplementedError(f"unfused route for unary={unary}")
    return y


def _gather(w, idx):
    """Embedding rows (QTensor-aware, per-row scales) as f32. An index
    outside the table reads NaN, as `jnp.take` fills it (the free-slot
    sentinel pos == max_seq gathers wpe out of range)."""
    table = w.q if isinstance(w, QTensor) else w
    rows = table.shape[0]
    flat = idx.reshape(-1).long()
    safe = flat.clamp(0, rows - 1)
    got = table.index_select(0, safe).float()
    if isinstance(w, QTensor):
        got = got * w.scale.index_select(0, safe)
    got = torch.where(((flat >= 0) & (flat < rows))[:, None], got,
                      float("nan"))
    return got.reshape(*idx.shape, table.shape[1])


def _gather_window(w, pos, T: int):
    """Rows [pos, pos + T) of an embedding table, the start clamped so the
    window fits (dynamic_slice's rule); f32."""
    rows = (w.q if isinstance(w, QTensor) else w).shape[0]
    start = pos.long().clamp(0, rows - T)
    return _gather(w, start + torch.arange(T, device=pos.device))


# ---------------------------------------------------------------------------
# attention

def composed_causal_attention(q, k, v, scale, causal: bool = True):
    """Attention over (B, S, H, D) operands from PyTorch ops, f32 math, KV
    heads repeated when k/v carry fewer. Returns (B, S, H, D) f32."""
    B, S, H, D = q.shape
    if k.shape[2] != H:
        g = H // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def _attention_full(q, k, v, cfg: GptConfig, kernels: bool):
    """Causal attention over token-layout (B, S, E) projections: the B7
    kernel (csrc/attention.cu) with kernels on, else composed."""
    if cfg.flash_attn:
        raise NotImplementedError(
            "flash_attn (the flash training attention) is not ported: "
            "ROADMAP A10 / B14")
    B, S, E = q.shape
    H, D = cfg.heads, cfg.head_dim
    scale = D ** -0.5
    if cfg.kv_h != H:
        # GQA prefill: KV repeated to full heads for the MHA kernels
        g = H // cfg.kv_h
        k = k.reshape(B, S, cfg.kv_h, D).repeat_interleave(g, dim=2) \
            .reshape(B, S, E)
        v = v.reshape(B, S, cfg.kv_h, D).repeat_interleave(g, dim=2) \
            .reshape(B, S, E)
    if kernels:
        key = FlashMhaKey(batch=B, seq=S, seq_kv=S, head_dim=D,
                          dtype=cfg.dtype, scale=scale, causal=True, heads=H)
        return global_cache().dispatch(key)(
            q.contiguous(), k.contiguous(), v.contiguous())
    return composed_causal_attention(
        q.reshape(B, S, H, D), k.reshape(B, S, H, D), v.reshape(B, S, H, D),
        scale).reshape(B, S, E).to(q.dtype)


# ---------------------------------------------------------------------------
# prefill

def _ffn(x, h, blk, cfg: GptConfig, int8: bool, kernels: bool):
    """The block's MLP on the normed h, added to x."""
    if cfg.swiglu:
        act = (F.silu(_mm(h, blk["w1"], int8, kernels))
               * _mm(h, blk["w3"], int8, kernels)).to(x.dtype)
        return x + _mm(act, blk["w2"], int8, kernels).to(x.dtype)
    h = _dot(h, blk["w1"], blk["b1"], int8=int8, unary="gelu",
             kernels=kernels)
    return x + _dot(h, blk["w2"], blk["b2"], int8=int8, kernels=kernels)


def _prefill_layer(x, blk, cfg: GptConfig, kernels: bool):
    """One pre-LN causal block over (B, S0, E); returns (x, k4, v4), the
    layer's (B, S0, kv_h, D) cache entries."""
    B, S0, _ = x.shape
    H, D = cfg.kv_h, cfg.head_dim
    i8 = cfg.int8_compute
    h = _block_norm(x, blk, "ln1", cfg)
    q = _dot(h, blk["wq"], blk["bq"], int8=i8, kernels=kernels)
    k = _dot(h, blk["wk"], blk["bk"], int8=i8, kernels=kernels)
    v = _dot(h, blk["wv"], blk["bv"], int8=i8, kernels=kernels)
    if cfg.rope:
        pos = torch.arange(S0, device=x.device)
        q = _rope(q.reshape(B, S0, cfg.heads, D), pos,
                  cfg.rope_theta).reshape(B, S0, -1)
        k = _rope(k.reshape(B, S0, H, D), pos,
                  cfg.rope_theta).reshape(B, S0, -1)
    a = _attention_full(q, k, v, cfg, kernels)
    x = x + _dot(a, blk["wo"], blk["bo"], int8=i8, kernels=kernels)
    x = _ffn(x, _block_norm(x, blk, "ln2", cfg), blk, cfg, i8, kernels)
    return x, k.reshape(B, S0, H, D), v.reshape(B, S0, H, D)


def _empty_cache(cfg: GptConfig, batch: int, device) -> dict:
    """A zero KV cache: k/v (L, B, kv_h, max_seq, D) per-head contiguous,
    (L, B, H/2, max_seq, 2D) head pairs with kv_packed, int8 plus
    (L, B, kv_h, max_seq) f32 scales with kv_quant; pos 0."""
    L, S, D = cfg.layers, cfg.max_seq, cfg.head_dim
    if cfg.kv_packed:
        shape = (L, batch, cfg.heads // 2, S, 2 * D)
    else:
        shape = (L, batch, cfg.kv_h, S, D)
    dt = torch.int8 if cfg.kv_quant else DTYPES[cfg.dtype]
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device),
             "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.kv_quant:
        for name in ("k_s", "v_s"):
            cache[name] = torch.zeros((L, batch, cfg.kv_h, S),
                                      dtype=torch.float32, device=device)
    return cache


def make_prefill(cfg: GptConfig, use_kernels: bool | None = None):
    """Return `prefill(params, ids) -> (logits, cache)`: ids (B, S0) int, a
    causal forward over the prompt; logits (B, S0, V) for every prompt
    position; the cache (see `_empty_cache`) with [0:S0) written and pos S0
    (an int32 device scalar)."""

    def prefill(params, ids):
        kernels = _use_kernels(params, use_kernels)
        B, S0 = ids.shape
        dev = ids.device
        x = _gather(params["wte"], ids)
        if not cfg.rope:
            x = x + _gather(params["wpe"], torch.arange(S0, device=dev))
        x = x.to(DTYPES[cfg.dtype])
        cache = _empty_cache(cfg, B, dev)
        for li, blk in enumerate(params["blocks"]):
            x, k4, v4 = _prefill_layer(x, blk, cfg, kernels)
            # (B, S0, kv_h, D) -> per-head contiguous (B, kv_h, S0, D)
            kt, vt = k4.transpose(1, 2), v4.transpose(1, 2)
            if cfg.kv_packed:     # adjacent heads share one 2D row
                kt, vt = (t.reshape(B, cfg.heads // 2, 2, S0, -1)
                          .transpose(2, 3).reshape(B, cfg.heads // 2, S0, -1)
                          for t in (kt, vt))
            if cfg.kv_quant:
                kt, ksc = quantize_tokens(kt)
                vt, vsc = quantize_tokens(vt)
                cache["k_s"][li, :, :, :S0] = ksc
                cache["v_s"][li, :, :, :S0] = vsc
            cache["k"][li, :, :, :S0] = kt
            cache["v"][li, :, :, :S0] = vt
        x = _final_norm(x, params, cfg)
        logits = _dot(x, params["lm_head"], int8=cfg.int8_compute,
                      kernels=kernels)
        cache["pos"].fill_(S0)
        return logits, cache

    return prefill


# ---------------------------------------------------------------------------
# decode

def _write(arr, new, pos, slotted: bool):
    """Write one token's (B, Hs[, Ds]) values into arr (B, Hs, S[, Ds]) at
    pos, in place. Slotted: row b at pos[b]; the free-slot sentinel
    pos[b] == max_seq re-writes the old value at the clamped position, so
    the cache state is unchanged (engine.py:1263-1270 there)."""
    new = new.to(arr.dtype)
    if not slotted:
        arr.index_copy_(2, pos.reshape(1).long(), new.unsqueeze(2))
        return
    S = arr.shape[2]
    rows = torch.arange(arr.shape[0], device=arr.device)
    at = pos.long().clamp(max=S - 1)
    old = arr[rows, :, at]
    free = (pos >= S).reshape(-1, *([1] * (new.dim() - 1)))
    arr[rows, :, at] = torch.where(free, old, new)


def _decode_body(params, cache, token, cfg: GptConfig, kernels: bool):
    """One decode step: write the token's K/V at pos in place, attend over
    the cache, MLP; advances cache["pos"] in place. No host read of a
    device value, so the step can be captured in a CUDA graph."""
    H, KVH, D = cfg.heads, cfg.kv_h, cfg.head_dim
    G, S = H // KVH, cfg.max_seq
    scale = D ** -0.5
    B = token.shape[0]
    pos = cache["pos"]
    slotted = pos.dim() == 1
    quant_kv = cfg.kv_quant == "int8"
    dt = DTYPES[cfg.dtype]
    x = _gather(params["wte"], token)
    if not cfg.rope:
        x = x + _gather(params["wpe"], pos)
    x = x.to(dt)                                          # (B, E)
    use_dk = cfg.kv_packed or cfg.decode_attn == "pallas" or \
        (cfg.decode_attn == "auto" and kernels)
    if use_dk:
        attend = _kernel(DecodeAttnKey(
            batch=B, heads=KVH, seq=S, head_dim=D, dtype=cfg.dtype,
            slotted=slotted, groups=G, stacked=cfg.layers, kv_quant=quant_kv,
            pack2=cfg.kv_packed), kernels)
    else:
        live = torch.arange(S, device=x.device) <= pos.reshape(-1, 1)
        live = live[:, None, None]                        # (B|1, 1, 1, S)
    for li, blk in enumerate(params["blocks"]):
        h = _block_norm(x, blk, "ln1", cfg)
        q = _dot(h, blk["wq"], blk["bq"]).reshape(B, H, D)
        k = _dot(h, blk["wk"], blk["bk"]).reshape(B, KVH, D)
        v = _dot(h, blk["wv"], blk["bv"]).reshape(B, KVH, D)
        if cfg.rope:     # the cache holds post-rotation keys
            q = _rope(q, pos, cfg.rope_theta)
            k = _rope(k, pos, cfg.rope_theta)
        if cfg.kv_packed:
            k = k.reshape(B, KVH // 2, 2 * D)
            v = v.reshape(B, KVH // 2, 2 * D)
        if quant_kv:
            k, ksc = quantize_tokens(k)
            v, vsc = quantize_tokens(v)
            _write(cache["k_s"][li], ksc, pos, slotted)
            _write(cache["v_s"][li], vsc, pos, slotted)
        _write(cache["k"][li], k, pos, slotted)
        _write(cache["v"][li], v, pos, slotted)
        if use_dk:
            if cfg.kv_packed:
                qk = q.reshape(B, KVH // 2, 2 * D)
            else:
                qk = q if G == 1 else q.reshape(B, KVH, G, D)
            a = attend(qk, cache["k"], cache["v"], pos, li,
                       k_s=cache.get("k_s"), v_s=cache.get("v_s"))
        else:
            # the einsum path: q heads grouped per KV head, cache operands
            # in their storage dtype (int8 cast to the activation dtype),
            # f32 accumulation
            kc, vc = cache["k"][li], cache["v"][li]
            ct = x.dtype if quant_kv else kc.dtype
            qg = q.reshape(B * KVH, G, D).to(ct)
            s = _f32bmm(qg, kc.to(ct).reshape(B * KVH, S, D).transpose(1, 2))
            s = s.reshape(B, KVH, G, S) * scale
            if quant_kv:
                s = s * cache["k_s"][li][:, :, None]
            s = torch.where(live, s, -1e30)
            p = torch.softmax(s, dim=-1)
            if quant_kv:
                p = p * cache["v_s"][li][:, :, None]
            a = _f32bmm(p.to(ct).reshape(B * KVH, G, S),
                        vc.to(ct).reshape(B * KVH, S, D))
        a = a.reshape(B, H * D).to(x.dtype)
        x = x + _dot(a, blk["wo"], blk["bo"])
        x = _ffn(x, _block_norm(x, blk, "ln2", cfg), blk, cfg, False,
                 kernels)
    logits = _dot(_final_norm(x, params, cfg), params["lm_head"])
    pos.add_(1)
    return logits, cache


def make_decode_step(cfg: GptConfig, use_kernels: bool | None = None):
    """Return `step(params, cache, token) -> (logits, cache)`: token (B,)
    int at cache["pos"]; logits (B, V) for the next position. The cache is
    updated in place (K/V written at pos, pos advanced) and returned."""

    def step(params, cache, token):
        return _decode_body(params, cache, token, cfg,
                            _use_kernels(params, use_kernels))

    return step


# ---------------------------------------------------------------------------
# extend

def make_extend(cfg: GptConfig, use_kernels: bool | None = None):
    """Return `extend(params, cache, tokens) -> (logits, cache)`: append T
    tokens at [pos, pos + T) of a scalar-pos cache, each attending over the
    cache and its causal prefix of the chunk; logits for all T positions.
    The composed multi-token path (chunked prefill, speculative
    verification); it has no kernel. The cache is updated in place."""
    if cfg.kv_packed:
        raise ValueError("make_extend reads the cache through the composed "
                         "path; the packed (H/2, S, 2D) layout is decode-"
                         "kernel only")
    H, D, KVH = cfg.heads, cfg.head_dim, cfg.kv_h
    G, S = H // KVH, cfg.max_seq
    scale = D ** -0.5
    quant_kv = cfg.kv_quant == "int8"

    def extend(params, cache, tokens):
        kernels = _use_kernels(params, use_kernels)
        B, T = tokens.shape
        pos = cache["pos"]
        if pos.dim():
            raise ValueError("make_extend takes a scalar-pos cache")
        dev = tokens.device
        x = _gather(params["wte"], tokens)
        if not cfg.rope:
            x = x + _gather_window(params["wpe"], pos, T)[None]
        x = x.to(DTYPES[cfg.dtype])                        # (B, T, E)
        # the chunk's write positions (start clamped so the chunk fits)
        at = pos.long().clamp(max=S - T) + torch.arange(T, device=dev)
        allow = torch.arange(S, device=dev)[None] <= \
            pos + torch.arange(T, device=dev)[:, None]     # (T, S)
        for li, blk in enumerate(params["blocks"]):
            h = _block_norm(x, blk, "ln1", cfg)
            q = _dot(h, blk["wq"], blk["bq"]).reshape(B, T, H, D)
            k = _dot(h, blk["wk"], blk["bk"]).reshape(B, T, KVH, D)
            v = _dot(h, blk["wv"], blk["bv"]).reshape(B, T, KVH, D)
            if cfg.rope:
                tpos = pos + torch.arange(T, device=dev)
                q = _rope(q, tpos, cfg.rope_theta)
                k = _rope(k, tpos, cfg.rope_theta)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # (B, KVH, T, D)
            if quant_kv:
                kt, ksc = quantize_tokens(kt)
                vt, vsc = quantize_tokens(vt)
                cache["k_s"][li].index_copy_(2, at, ksc)
                cache["v_s"][li].index_copy_(2, at, vsc)
            cache["k"][li].index_copy_(2, at, kt.to(cache["k"].dtype))
            cache["v"][li].index_copy_(2, at, vt.to(cache["v"].dtype))
            kc, vc = cache["k"][li], cache["v"][li]
            ct = x.dtype if quant_kv else kc.dtype
            # f32 math on operands rounded to ct: bf16 products are exact
            qg = q.reshape(B, T, KVH, G, D).to(ct).float()
            s = torch.einsum("btkgd,bksd->bkgts", qg,
                             kc.to(ct).float()) * scale
            if quant_kv:
                s = s * cache["k_s"][li][:, :, None, None]
            s = torch.where(allow, s, -1e30)
            p = torch.softmax(s, dim=-1)
            if quant_kv:
                p = p * cache["v_s"][li][:, :, None, None]
            a = torch.einsum("bkgts,bksd->btkgd", p.to(ct).float(),
                             vc.to(ct).float())
            a = a.reshape(B, T, H * D).to(x.dtype)
            x = x + _dot(a, blk["wo"], blk["bo"])
            x = _ffn(x, _block_norm(x, blk, "ln2", cfg), blk, cfg, False,
                     kernels)
        logits = _dot(_final_norm(x, params, cfg), params["lm_head"],
                      int8=cfg.int8_compute, kernels=kernels)
        pos.add_(T)
        return logits, cache

    return extend


# ---------------------------------------------------------------------------
# sampling and generation

def make_sampler(temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0):
    """Return `sample(logits (B, V), generator=None) -> (B,) int32`.

    temperature 0 is greedy (top_k/top_p ignored). Otherwise logits are
    scaled by 1/temperature, truncated to the top_k largest and/or the
    smallest nucleus reaching mass top_p (the first token always kept), and
    sampled categorically by the Gumbel-max rule over a torch.Generator
    (its numbers differ from jax.random's)."""

    def sample(logits, generator=None):
        if temperature == 0.0:
            return logits.argmax(-1).to(torch.int32)
        x = logits.float() / temperature
        if top_k:
            kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
            x = torch.where(x < kth, -math.inf, x)
        if top_p:
            srt = torch.sort(x, dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            keep = probs.cumsum(-1) - probs < top_p
            cut = torch.where(keep, srt, math.inf).amin(-1, keepdim=True)
            x = torch.where(x < cut, -math.inf, x)
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return (x - torch.log(-torch.log(u))).argmax(-1).to(torch.int32)

    return sample


class DecodeRunner:
    """Decode steps over one cache from its current position: `run(token)
    -> logits (B, V)` writes the token's K/V at pos and advances it, as
    `step` does, eagerly or (graph=True) replayed from one CUDA graph over
    static token, cache and pos buffers. For the capture a warm-up step runs
    off the graph and its pos advance is undone; the K/V it wrote at pos are
    rewritten by the first replay. `reset()` returns to the start position,
    so the same steps can run again (timing, tracing)."""

    def __init__(self, step, params, cache, token, graph: bool):
        self.cache = cache
        self.pos0 = cache["pos"].clone()
        if not graph:
            self._run = lambda tok: step(params, cache, tok)[0]
            return
        static_tok = token.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(params, cache, static_tok)
        torch.cuda.current_stream().wait_stream(side)
        self.reset()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            logits, _ = step(params, cache, static_tok)

        def replay(tok):
            static_tok.copy_(tok)
            g.replay()
            return logits
        self._run = replay

    def __call__(self, token):
        return self._run(token)

    def reset(self):
        self.cache["pos"].copy_(self.pos0)

    def repeat(self, token, n: int):
        """From the start position, n steps that each take `token`."""
        self.reset()
        for _ in range(n):
            self._run(token)


def make_generate(cfg: GptConfig, steps: int, temperature: float = 0.0,
                  use_kernels: bool | None = None, top_k: int = 0,
                  top_p: float = 0.0, graph: bool | None = None):
    """Return `generate(params, ids, generator=None, mark=None) -> tokens
    (B, steps)`: prefill the prompt, sample, then `steps - 1` decode steps,
    sampling after each. On CUDA (or with graph=True) the decode step is
    captured once in a CUDA graph and replayed per token (`DecodeRunner`),
    the counterpart of the JAX `lax.scan` under `jit`; the sampler runs
    outside the graph. On the CPU, or with graph=False, the loop runs
    eagerly. `mark(phase)`, if given, is called at "start", after the
    prefill and first sample ("prefill"), after the capture ("capture") and
    after the decode loop ("decode"): the timers of `tools/tpp_serve.py`."""
    prefill = make_prefill(cfg, use_kernels)
    step = make_decode_step(cfg, use_kernels)
    sample = make_sampler(temperature, top_k, top_p)

    def generate(params, ids, generator=None, mark=None):
        mark = mark or (lambda phase: None)
        mark("start")
        logits, cache = prefill(params, ids)
        tok = sample(logits[:, -1], generator)
        toks = [tok]
        mark("prefill")
        if steps > 1:
            run = DecodeRunner(step, params, cache, tok,
                               graph if graph is not None else ids.is_cuda)
        mark("capture")
        for _ in range(steps - 1):
            tok = sample(run(tok), generator)
            toks.append(tok)
        mark("decode")
        return torch.stack(toks, dim=1)

    return generate
