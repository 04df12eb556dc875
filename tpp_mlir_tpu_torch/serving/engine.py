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
  B7) for every shape, or with `flash_attn` to B14's forward
  (`csrc/flash_train.cu`, FlashTrainKey), int8 compute to
  `csrc/int8_gemm.cu` (Int8GemmKey, B15) and decode attention to
  `csrc/decode_attn.cu` (DecodeAttnKey, B13) for every variant under "auto" (ROADMAP queue C). `use_kernels` (the
  JAX `use_pallas`) defaults to "the params are on CUDA"; with it off, or
  on the CPU, prefill attention is the composed path, `decode_attn="auto"`
  the einsum path, and a forced kernel runs its plain version
  (`xsmm/reference.py`), as interpret mode does off the TPU.
- The dense projections are PyTorch GEMMs (the JAX package's `jnp.dot`):
  f32 accumulation with an f32 result, TF32 off.
- The sparse-expert FFN (`n_experts > 0`, engine.py:438-920 there): the
  scan, gather, slice and sorted forms are PyTorch ops; the grouped form
  runs its two GEMMs on `csrc/grouped_gemm.cu` (GroupedGemmKey, B16), and
  its autograd Function's backward adds the grouped weight gradient
  (GroupedWgradKey, B17). Every form runs on the device with no host read
  of the routing, so the decode step stays capturable in a CUDA graph.
  `moe_group_stacked` changes nothing here: it kept a `lax.scan` from
  copying a per-layer weight slab, and the per-layer list's `w1` is
  already a view (ROADMAP queue C).

Continuous batching, beam search and speculative decoding (`batching.py`,
`beam.py`, `speculative.py`) run on these functions; their loops replay
one CUDA graph per body (`Replayed`). QTensor weights are int8 or packed
int4 (`quant.py`; the engine unpacks int4 to the activation dtype in
PyTorch). The prefill is differentiable for LoRA/QLoRA training
(`lora.py`): where a gradient is taken, its contractions run through
`ops.trainable.f32_matmul`, its attention through B14/B18 on the card (B7
has no backward), its K/V are written to the cache detached, and
`remat` recomputes each layer in the backward; int8 compute has no
backward and raises. The tensor-parallel decode (`make_tp_decode_step`,
`decode_param_specs`, `decode_cache_specs`) runs `_decode_body` on one tp
rank's shards (heads and the KV cache split over tp, one all-reduce of the
f32 partial product per row-parallel GEMM), as the JAX `shard_map` body
does (engine.py:1175-1217, 1650-1770 there).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..utils.target import resolve_device
from ..xsmm import (DecodeAttnKey, FlashMhaKey, FlashTrainKey,
                    GroupedGemmKey, GroupedWgradKey, Int8GemmKey,
                    global_cache, reference_kernel)
from ..xsmm.flash_train import flash_attention_train
from ..xsmm.reference import DTYPES
from .quant import QTensor, from_values, quantize_tokens, with_kmajor


# the MoE forms the JAX dispatchers read (_moe_ffn_decode, _moe_ffn_prefill)
MOE_DECODE_FORMS = ("auto", "slice", "gather", "scan")
MOE_PREFILL_FORMS = ("scan", "sorted", "grouped")


@dataclass(frozen=True)
class GptConfig:
    """The JAX engine's GptConfig, field for field (see engine.py:36 there
    for what each field means). `remat` recomputes each layer's forward in
    the backward of a prefill that takes a gradient (LoRA training)."""

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
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be f32 or bf16: {self.dtype!r}")
        if self.n_experts:      # engine.py:138-142 there
            if not 1 <= self.top_k <= self.n_experts:
                raise ValueError(f"top_k must be in [1, n_experts]: "
                                 f"{self.top_k}, {self.n_experts}")
            if self.swiglu:
                raise ValueError("MoE experts use GELU (SwiGLU experts are "
                                 "not in the JAX engine either)")
        if self.moe_decode_form not in MOE_DECODE_FORMS:
            raise ValueError(f"moe_decode_form must be one of "
                             f"{MOE_DECODE_FORMS}: {self.moe_decode_form!r}")
        if self.moe_prefill_form not in MOE_PREFILL_FORMS:
            raise ValueError(f"moe_prefill_form must be one of "
                             f"{MOE_PREFILL_FORMS}: "
                             f"{self.moe_prefill_form!r}")
        if self.moe_group_bm < 1:
            raise ValueError(f"moe_group_bm must be positive: "
                             f"{self.moe_group_bm}")
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

def params_from_torch(model, cfg: GptConfig, device="cuda") -> dict:
    """Params from a `models.gpt` GptTorch; weight matrices are
    stored (in, out), so the forward is x @ W."""
    device = resolve_device(device)
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


def init_params(cfg: GptConfig, seed: int = 0, device="cuda") -> dict:
    """Random params for synthetic serving runs, at the JAX init_params'
    scales, zeros and ones. The values come from a torch.Generator on
    `device` and differ from the JAX package's jax.random stream for the
    same seed; carry JAX weights across with `params_from_numpy`."""
    device = resolve_device(device)
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
        elif cfg.n_experts:  # a linear router and biasless expert stacks
            blk["wr"] = nrm((E, cfg.n_experts), E ** -0.5)
            blk["w1"] = nrm((cfg.n_experts, E, F_), E ** -0.5)
            blk["w2"] = nrm((cfg.n_experts, F_, E), F_ ** -0.5)
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
    out["blocks"] = [{k: v._replace(
        q=v.q[i], scale=v.scale[i], qt=None if v.qt is None else v.qt[i],
        shape=None if v.shape is None else v.shape[1:])
        if isinstance(v, QTensor) else v[i] for k, v in blocks.items()}
        for i in range(L)]
    return out


def _from_numpy(a, dt: torch.dtype, device) -> torch.Tensor:
    """One array of a JAX params tree as a tensor. bf16 arrives as a uint16
    (or ml_dtypes bfloat16) bit view, or as f32 holding bf16-exact values;
    either becomes torch.bfloat16 with no change of bits. A JAX int4
    payload (ml_dtypes int4) is read as its int8 values."""
    a = np.asarray(a)
    if a.dtype.name == "int4":
        a = a.astype(np.int8)
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


def params_from_numpy(tree: dict, cfg: GptConfig, device="cuda") -> dict:
    """The port's params from a JAX params tree passed as numpy arrays (per
    layer or stacked), QTensors as (q, scale) pairs: the weight carrier that
    lets both engines run the same weights. Leaves take the config's dtype;
    int8 QTensor payloads stay int8, int4 ones (`jnp.int4`) are packed two
    to a byte (quant.pack_int4), and their scales stay f32. Under int8
    compute the QTensors the int8 GEMM contracts against also get their
    K-major copies (quant.with_kmajor)."""
    device = resolve_device(device)
    dt = DTYPES[cfg.dtype]

    def leaf(x):
        if isinstance(x, tuple) and len(x) == 2:
            bits = 4 if np.asarray(x[0]).dtype.name == "int4" else 8
            return from_values(_from_numpy(x[0], torch.int8, device),
                               _from_numpy(x[1], torch.float32, device),
                               bits)
        return _from_numpy(x, dt, device)

    blocks = tree["blocks"]
    if isinstance(blocks, dict):         # stacked (L, ...) arrays
        L = cfg.layers
        blocks = [{k: (tuple(np.asarray(t)[i] for t in v)
                       if isinstance(v, tuple) else np.asarray(v)[i])
                   for k, v in blocks.items()} for i in range(L)]
    out = {k: leaf(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [{k: leaf(v) for k, v in blk.items()} for blk in blocks]
    return with_kmajor(out) if cfg.int8_compute else out


def params_device(params: dict) -> torch.device:
    """The device the params live on (the LM head's)."""
    w = params["lm_head"]
    return (w.q if isinstance(w, QTensor) else w).device


def _use_kernels(params: dict, use_kernels: bool | None) -> bool:
    if use_kernels is not None:
        return use_kernels
    return params_device(params).type == "cuda"


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


def _grad_on(*ts) -> bool:
    """Whether autograd records an op on ts: grad mode is on and one of
    them requires grad (a prefill under LoRA training)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _f32mm(x, w):
    """x (..., K) @ w (K, N) with f32 accumulation and an f32 result (the
    JAX package's preferred_element_type=f32). A bf16 matmul would round
    its result to bf16; on CUDA `out_dtype` keeps it f32, elsewhere the
    operands go up to f32 (bf16 products are exact in f32). Where a
    gradient is taken through it, the same forward runs inside
    `ops.trainable.f32_matmul` (torch.mm's out_dtype form has no
    derivative), so the forward's bits do not change."""
    if _grad_on(x, w):
        from ..ops.trainable import f32_matmul
        return f32_matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _f32bmm(a, b):
    """Batched a @ b with f32 accumulation and an f32 result (under a
    gradient as an f32 bmm of the upcast operands: out_dtype has no
    derivative)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and \
            not _grad_on(a, b):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _mm_int8(x, w: QTensor, b=None, unary=None, kernels=False):
    """The int8 compute route: activation rows quantized per row, then the
    s8 x s8 -> s32 GEMM with the dequantization, bias and unary on the f32
    accumulator (Int8GemmKey, csrc/int8_gemm.cu), reading the weight's
    K-major copy where the params carry one (quant.with_kmajor) and the
    bias in its stored dtype. Any row count: the TPU's padding of rows to
    32 was a tile quantum. B15 has no backward, in either package: a
    gradient through it raises."""
    if _grad_on(x) or (b is not None and _grad_on(b)):
        raise NotImplementedError(
            "int8_compute has no gradient: the int8 GEMM (Int8GemmKey, "
            "csrc/int8_gemm.cu) has no backward; train with int8_compute off")
    K, N = x.shape[-1], w.dims[-1]
    x2 = x.reshape(-1, K)
    xq, xs = quantize_tokens(x2)                 # (M, K) s8, (M,) f32
    key = Int8GemmKey(m=x2.shape[0], n=N, k=K, out_dtype="f32",
                      has_bias=b is not None, unary_kind=unary)
    args = (xq, w.values(), xs, w.scale) + ((b,) if b is not None else ())
    kw = {} if w.qt is None else {"wt": w.qt}
    return _kernel(key, kernels)(*args, **kw).reshape(*x.shape[:-1], N)


def _int8_rows(x, w, int8: bool) -> bool:
    """Whether a contraction takes the int8 compute route: a QTensor weight,
    int8 compute on, and at least 32 rows (the gate decides the numerics,
    so it is kept; below it the weight-only route runs)."""
    return int8 and isinstance(w, QTensor) and \
        math.prod(x.shape[:-1]) >= 32


def _mm(x, w, int8: bool = False, kernels: bool = False):
    """f32-accumulated contraction; a QTensor weight contracts against its
    int8 (or unpacked int4) values cast to the activation dtype and scales
    the result."""
    if isinstance(w, QTensor):
        if _int8_rows(x, w, int8):
            return _mm_int8(x, w, kernels=kernels)
        return _f32mm(x, w.values().to(x.dtype)) * w.scale
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
    quant = isinstance(w, QTensor)
    rows, cols = w.dims if quant else w.shape
    flat = idx.reshape(-1).long()
    safe = flat.clamp(0, rows - 1)
    if quant:
        got = w.rows(safe).float() * w.scale.index_select(0, safe)
    else:
        got = w.index_select(0, safe).float()
    got = torch.where(((flat >= 0) & (flat < rows))[:, None], got,
                      float("nan"))
    return got.reshape(*idx.shape, cols)


def _gather_window(w, pos, T: int):
    """Rows [pos, pos + T) of an embedding table, the start clamped so the
    window fits (dynamic_slice's rule); f32."""
    rows = (w.dims if isinstance(w, QTensor) else w.shape)[0]
    start = pos.long().clamp(0, rows - T)
    return _gather(w, start + torch.arange(T, device=pos.device))


# ---------------------------------------------------------------------------
# the sparse-expert FFN (n_experts > 0)

def _moe_gates(h, wr, top_k: int, mm=None):
    """Router (engine.py:438 there): the top_k expert ids and the softmax
    over the selected logits. h (..., E) -> gates (..., k) f32, idx
    (..., k) int64. `mm` is the f32-result contraction, `_mm` unless the
    training step passes its differentiable one."""
    logits = (mm or _mm)(h, wr)
    vals, idx = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(vals, dim=-1), idx


def _moe_ffn_scan(h, blk, top_k: int, mm=None):
    """Every expert over all T tokens, weighted by the dense (T, n_e) gate
    table (engine.py:450 there): exact, n_experts x the dense FFN's flops,
    each expert's weights read once. h (T, E) -> (T, E)."""
    mm = mm or _mm
    gates, idx = _moe_gates(h, blk["wr"], top_k, mm)
    n_e = blk["wr"].shape[-1]
    dense = torch.zeros(h.shape[0], n_e, device=h.device).scatter_add(
        1, idx, gates)
    acc = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in range(n_e):
        a = F.gelu(mm(h, blk["w1"][e])).to(h.dtype)
        acc = acc + dense[:, e:e + 1] * mm(a, blk["w2"][e])
    return acc.to(h.dtype)


def _moe_ffn_gather(h, blk, top_k: int):
    """Only the selected experts' weights, gathered per token (engine.py:480
    there): B*k expert reads. h (B, E) -> (B, E)."""
    gates, idx = _moe_gates(h, blk["wr"], top_k)
    B, E = h.shape
    w1s, w2s = blk["w1"][idx], blk["w2"][idx]     # (B, k, E, F), (B, k, F, E)
    F_ = w1s.shape[-1]
    hk = h[:, None, None, :].expand(B, top_k, 1, E).reshape(B * top_k, 1, E)
    a = F.gelu(_f32bmm(hk, w1s.reshape(B * top_k, E, F_))).to(h.dtype)
    y = _f32bmm(a, w2s.reshape(B * top_k, F_, E)).reshape(B, top_k, E)
    return (gates[..., None] * y).sum(1).to(h.dtype)


def _moe_ffn_slice(h, blk, top_k: int):
    """B == 1 (engine.py:862 there): the k selected experts' matrices taken
    by `index_select` on the device index, so no host read of the routing
    and the step stays capturable (XLA fuses its dynamic slice into the
    dot; here the slab is copied once). h (1, E) -> (1, E)."""
    gates, idx = _moe_gates(h, blk["wr"], top_k)
    acc = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for j in range(top_k):
        e = idx[0, j:j + 1]
        w1 = blk["w1"].index_select(0, e)[0]
        w2 = blk["w2"].index_select(0, e)[0]
        a = F.gelu(_mm(h, w1)).to(h.dtype)
        acc = acc + gates[:, j:j + 1] * _mm(a, w2)
    return acc.to(h.dtype)


def _moe_ffn_sorted(h, blk, top_k: int, capacity_factor: float = 1.25):
    """GShard sorted dispatch with capacity C = ceil(cf * T * k / n_e)
    (engine.py:499 there): assignments sorted by expert (stable), packed
    into an (n_e, C) token table, one batched GEMM per FFN layer;
    assignments past an expert's capacity drop to a zero delta. The
    dropped ones are written to one sentinel slot past the table, which is
    cut off (`.at[].set(mode="drop")` there). h (T, E) -> (T, E)."""
    gates, idx = _moe_gates(h, blk["wr"], top_k)
    T, E = h.shape
    n_e = blk["wr"].shape[-1]
    A = T * top_k
    C = max(1, int(-(-capacity_factor * A // n_e)))    # ceil
    dev = h.device
    e_flat = idx.reshape(A)
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    t_s = torch.arange(T, device=dev).repeat_interleave(top_k)[order]
    g_s = gates.reshape(A)[order]
    start = torch.searchsorted(e_s, torch.arange(n_e, device=dev))
    rank = torch.arange(A, device=dev) - start[e_s]
    dest = torch.where(rank < C, e_s * C + rank, n_e * C)
    table = torch.full((n_e * C + 1,), T, device=dev).scatter(
        0, dest, t_s)[:-1]
    gtab = torch.zeros(n_e * C + 1, device=dev).scatter(0, dest, g_s)[:-1]
    hp = torch.cat([h, h.new_zeros(1, E)])
    a = F.gelu(_f32bmm(hp[table].reshape(n_e, C, E), blk["w1"])).to(h.dtype)
    y = _f32bmm(a, blk["w2"]).reshape(n_e * C, E) * gtab[:, None]
    out = torch.zeros(T + 1, E, device=dev).index_add_(0, table, y)
    return out[:T].to(h.dtype)


def _grouped_dispatch(idx, T: int, n_e: int, bm: int, top_k: int) -> dict:
    """The single-sort grouped dispatch (engine.py:589 there), on the
    device with the static bound A_pad = (ceil(A/bm) + n_e) * bm rows, so
    one kernel key serves every routing. Each expert's rows pad to a bm
    multiple with at least one block (B17 then writes every expert's dW).
    Returns A_pad, ge (A_pad/bm,) int32 block -> expert, tt (A_pad,)
    source token (T = padding), aid (A_pad,) assignment id (A = padding)
    and rows (T, top_k) assignment -> padded slot."""
    dev = idx.device
    A = T * top_k
    A_pad = (-(-A // bm) + n_e) * bm
    e_flat = idx.reshape(A).long()
    # the one-hot as (n_e, A), so the inclusive scan runs along contiguous
    # memory (along the outer dim of (A, n_e), CUDA's scan took ~1.4 ms a
    # layer at A 8192)
    csum = torch.cumsum((torch.arange(n_e, device=dev)[:, None]
                         == e_flat[None, :]).long(), 1)
    rank = csum.gather(0, e_flat[None, :])[0] - 1
    counts = csum[:, -1]
    start = torch.cumsum(counts, 0) - counts            # exclusive
    padded = torch.clamp((counts + bm - 1) // bm * bm, min=bm)
    ends = torch.cumsum(padded, 0)
    offs = ends - padded
    # one sort on the unique key e*A + i orders like a stable sort by expert
    a_s = torch.sort(e_flat * A + torch.arange(A, device=dev)).values % A
    pslot = torch.arange(A_pad, device=dev)
    pe = torch.searchsorted(ends, pslot, right=True).clamp(max=n_e - 1)
    loc = pslot - offs[pe]
    valid = loc < counts[pe]
    # padding slots read any in-range entry, then take the sentinel
    si = (start[pe] + torch.where(valid, loc, 0)).clamp(max=A - 1)
    return {"A_pad": A_pad, "ge": pe[::bm].to(torch.int32),
            "tt": torch.where(valid, a_s[si] // top_k, T),
            "aid": torch.where(valid, a_s[si], A),
            "rows": (offs[e_flat] + rank).reshape(T, top_k)}


def _grouped_combine(gates, ys, rows, top_k: int):
    """out[t] = sum_j gates[t, j] * ys[rows[t, j]] in f32, k gathers
    (engine.py:647 there)."""
    out = torch.zeros(gates.shape[0], ys.shape[-1], device=ys.device)
    for j in range(top_k):
        out = out + gates[:, j, None].float() * ys[rows[:, j]].float()
    return out


def _grouped_keys(T, E, F_, n_e, bm, top_k, dtype, precision):
    """The two B16 keys of the grouped FFN: fc1 with the fused gelu, fc2."""
    A_pad = (-(-T * top_k // bm) + n_e) * bm
    k1 = GroupedGemmKey(n_groups=n_e, m=A_pad, n=F_, k=E, dtype=dtype,
                        unary_kind="gelu", precision=precision, bm=bm)
    k2 = GroupedGemmKey(n_groups=n_e, m=A_pad, n=E, k=F_, dtype=dtype,
                        precision=precision, bm=bm)
    return k1, k2


def _grouped_route(h, wr, top_k: int, bm: int):
    """(gates, idx, dispatch maps, xs): xs (A_pad, E) holds each padded
    slot's token row, zero for padding."""
    T, E = h.shape
    gates, idx = _moe_gates(h, wr, top_k)
    d = _grouped_dispatch(idx, T, wr.shape[-1], bm, top_k)
    return gates, idx, d, torch.cat([h, h.new_zeros(1, E)])[d["tt"]]


def _grouped_ffn(h, wr, w1, w2, top_k, bm, dtype, precision, kernels):
    """The grouped form without autograd: the fused-gelu B16 pair."""
    k1, k2 = _grouped_keys(*h.shape, w1.shape[-1], wr.shape[-1], bm, top_k,
                           dtype, precision)
    gates, _, d, xs = _grouped_route(h, wr, top_k, bm)
    a = _kernel(k1, kernels)(d["ge"], xs, w1)         # gelu(xs @ w1[e])
    ys = _kernel(k2, kernels)(d["ge"], a, w2)         # (A_pad, E)
    return _grouped_combine(gates, ys, d["rows"], top_k).to(h.dtype)


def _gelu_grad(z):
    """d/dz of the exact-erf gelu, in f32: Phi(z) + z phi(z)."""
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    return cdf + z * torch.exp(-0.5 * z * z) * 0.3989422804014327


def _router_vjp(h, wr, gates, idx, dgates):
    """(dh, dwr) in f32 through gates = softmax((h @ wr)[idx]) with the
    top-k selection fixed: routing indices carry no gradient."""
    dvals = gates * (dgates - (gates * dgates).sum(-1, keepdim=True))
    dlogits = torch.zeros(h.shape[0], wr.shape[-1],
                          device=h.device).scatter(1, idx, dvals)
    return dlogits @ wr.float().t(), h.float().t() @ dlogits


class _GroupedFFN(torch.autograd.Function):
    """The differentiable grouped core (engine.py:665
    _grouped_ffn_trainable there). Forward: z1 by an unfused B16 with an
    f32 output, the erf gelu, the second B16; z1 is saved at the compute
    dtype. Backward: the combine's backward as gathers, da and dxs by B16
    transpose_b over w2 and w1 in their own layouts, dw2 and dw1 by B17 on
    transposed views (no copy), dh as k gathers plus the router's
    derivative through the fixed top-k selection."""

    @staticmethod
    def forward(ctx, h, wr, w1, w2, top_k, bm, dtype, precision, kernels):
        k1, k2 = _grouped_keys(*h.shape, w1.shape[-1], wr.shape[-1], bm,
                               top_k, dtype, precision)
        gates, idx, d, xs = _grouped_route(h, wr, top_k, bm)
        z1 = _kernel(dataclasses.replace(k1, unary_kind=None, out_dtype="f32"),
                     kernels)(d["ge"], xs, w1)
        ys = _kernel(k2, kernels)(d["ge"], F.gelu(z1).to(xs.dtype), w2)
        ctx.save_for_backward(h, wr, w1, w2, gates, idx, d["ge"], d["tt"],
                              d["aid"], d["rows"], xs, z1.to(xs.dtype), ys)
        ctx.spec = (k1, k2, top_k, kernels)
        return _grouped_combine(gates, ys, d["rows"], top_k).to(h.dtype)

    @staticmethod
    def backward(ctx, dout):
        (h, wr, w1, w2, gates, idx, ge, tt, aid, rows, xs, z1,
         ys) = ctx.saved_tensors
        k1, k2, top_k, kernels = ctx.spec
        (T, E), F_, n_e = h.shape, w1.shape[-1], wr.shape[-1]
        cdt = xs.dtype
        do32 = dout.float()
        # dys[p] = gates_flat[aid[p]] * dout[tt[p]]; sentinels read zero
        dop = torch.cat([do32, do32.new_zeros(1, E)])
        gflat = torch.cat([gates.reshape(-1).float(), gates.new_zeros(1)])
        dys = (gflat[aid][:, None] * dop[tt]).to(cdt)
        dgates = torch.stack([(do32 * ys[rows[:, j]].float()).sum(-1)
                              for j in range(top_k)], -1)
        da = _kernel(dataclasses.replace(k2, n=F_, k=E, transpose_b=True,
                                         out_dtype="f32"),
                     kernels)(ge, dys, w2)              # dys @ w2[e]^T
        z1 = z1.float()
        dz1 = (da * _gelu_grad(z1)).to(cdt)
        wkey = GroupedWgradKey(n_groups=n_e, m=k1.m, k=F_, n=E,
                               dtype=k1.dtype, precision=k1.precision,
                               bm=k1.bm)
        dw2 = _kernel(wkey, kernels)(ge, F.gelu(z1).to(cdt).t(), dys)
        dw1 = _kernel(dataclasses.replace(wkey, k=E, n=F_), kernels)(
            ge, xs.t(), dz1)
        dxs = _kernel(dataclasses.replace(k1, n=E, k=F_, unary_kind=None,
                                          transpose_b=True, out_dtype="f32"),
                      kernels)(ge, dz1, w1)             # dz1 @ w1[e]^T
        dh, dwr = _router_vjp(h, wr, gates, idx, dgates)
        for j in range(top_k):
            dh = dh + dxs[rows[:, j]]
        return (dh.to(h.dtype), dwr.to(wr.dtype), dw1.to(w1.dtype),
                dw2.to(w2.dtype), None, None, None, None, None)


def _moe_ffn_grouped(h, blk, cfg: GptConfig, kernels: bool,
                     precision: str = "default"):
    """The dropless grouped-expert form (engine.py:550 there): assignments
    sorted by expert, each expert's rows padded to a moe_group_bm multiple
    (no token dropped), the two FFN GEMMs as B16 with gelu fused into the
    first. Under autograd (grad mode on and a leaf that asks for it) the
    `_GroupedFFN` Function runs instead, with B16/B17 in its backward.
    `precision` is the keys' own ("highest" keeps f32 operands f32).
    h (T, E) -> (T, E)."""
    args = (h, blk["wr"], blk["w1"], blk["w2"], cfg.top_k, cfg.moe_group_bm,
            cfg.dtype, precision, kernels)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:4]):
        return _GroupedFFN.apply(*args)
    return _grouped_ffn(*args)


def _moe_ffn_prefill(h, blk, cfg: GptConfig, kernels: bool):
    """The prefill (and extend) form by cfg.moe_prefill_form (engine.py:849
    there). h (T, E) -> (T, E)."""
    if cfg.moe_prefill_form == "sorted":
        return _moe_ffn_sorted(h, blk, cfg.top_k, cfg.moe_capacity_factor)
    if cfg.moe_prefill_form == "grouped":
        return _moe_ffn_grouped(h, blk, cfg, kernels)
    return _moe_ffn_scan(h, blk, cfg.top_k)


def moe_decode_form(cfg: GptConfig, batch: int) -> str:
    """The decode form (engine.py:885 there): a forced one, or under
    "auto" the JAX package's byte policy, kept as it is: slice at B == 1,
    scan once 3*B*k covers the expert table, gather otherwise."""
    form = cfg.moe_decode_form
    if form == "auto":
        if batch == 1:
            return "slice"
        return "scan" if 3 * batch * cfg.top_k >= cfg.n_experts else "gather"
    if form == "slice" and batch != 1:
        raise ValueError(f"moe_decode_form='slice' needs batch 1, got "
                         f"{batch}")
    return form


def _moe_ffn_decode(h, blk, cfg: GptConfig):
    """h (B, E) -> (B, E) in the form moe_decode_form picks."""
    form = moe_decode_form(cfg, h.shape[0])
    if form == "slice":
        return _moe_ffn_slice(h, blk, cfg.top_k)
    if form == "scan":
        return _moe_ffn_scan(h, blk, cfg.top_k)
    return _moe_ffn_gather(h, blk, cfg.top_k)


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
    """Causal attention over token-layout (B, S, E) projections: with
    cfg.flash_attn the training forward B14 (csrc/flash_train.cu; its plain
    version with kernels off), as the JAX engine routes it (engine.py:
    978-993 there, without its TPU VMEM gate); else the B7 kernel
    (csrc/attention.cu) with kernels on, or the composed attention. Where a
    gradient is taken (B7 has no backward): on CUDA with kernels on,
    `flash_attention_train` (B14 forward, B18 backward), else the composed
    attention, as `make_gpt_train_step` picks by default (ROADMAP
    queue C)."""
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
    if _grad_on(q, k, v):
        q4, k4, v4 = (t.reshape(B, S, H, D) for t in (q, k, v))
        if kernels and q.is_cuda:
            o = flash_attention_train(q4, k4, v4, scale)
        else:
            o = composed_causal_attention(q4, k4, v4, scale)
        return o.reshape(B, S, E).to(q.dtype)
    if cfg.flash_attn:
        key = FlashTrainKey(batch=B, heads=H, seq=S, head_dim=D,
                            dtype=cfg.dtype, scale=scale)
        o, _ = _kernel(key, kernels)(
            *(t.reshape(B, S, H, D).contiguous() for t in (q, k, v)))
        return o.reshape(B, S, E).to(q.dtype)
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

def _row_dot(x, w, b, tp=None):
    """A row-parallel contraction + bias: the f32 partial product summed
    over the tp group, then the bias once, cast to x's dtype (the JAX
    decode's `row_parallel`). With no group it is `_dot(x, w, b)`."""
    if tp is None:
        return _dot(x, w, b)
    from ..parallel.collectives import all_reduce
    return (all_reduce(_mm(x, w), tp) + b.float()).to(x.dtype)


def _ffn(x, h, blk, cfg: GptConfig, int8: bool, kernels: bool,
         decode: bool = False, tp=None):
    """The block's MLP on the normed h, added to x; a MoE block runs its
    decode form on a decode step's (B, E) rows, else its prefill form. With
    a tp group (the tp decode) the second GEMM is row-parallel."""
    if cfg.swiglu:
        act = (F.silu(_mm(h, blk["w1"], int8, kernels))
               * _mm(h, blk["w3"], int8, kernels)).to(x.dtype)
        y = _mm(act, blk["w2"], int8, kernels)
        if tp is not None:
            from ..parallel.collectives import all_reduce
            y = all_reduce(y, tp)
        return x + y.to(x.dtype)
    if cfg.n_experts:
        if decode:
            return x + _moe_ffn_decode(h, blk, cfg)
        rows = h.reshape(-1, h.shape[-1])
        return x + _moe_ffn_prefill(rows, blk, cfg, kernels).reshape(h.shape)
    h = _dot(h, blk["w1"], blk["b1"], int8=int8, unary="gelu",
             kernels=kernels)
    if tp is not None:
        return x + _row_dot(h, blk["w2"], blk["b2"], tp)
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
    (an int32 device scalar).

    The prefill is differentiable (the LoRA step takes its gradient): the
    contractions and attention take their differentiable forms where a
    gradient is taken (`_f32mm`, `_attention_full`), the cache gets
    detached K/V (it holds no activations alive), and with `cfg.remat`
    each layer runs under `torch.utils.checkpoint` (non-reentrant), so its
    activations are recomputed in the backward (engine.py:1111,1122
    there: `jax.checkpoint` around the scanned layer)."""

    def prefill(params, ids):
        kernels = _use_kernels(params, use_kernels)
        B, S0 = ids.shape
        dev = ids.device
        x = _gather(params["wte"], ids)
        if not cfg.rope:
            x = x + _gather(params["wpe"], torch.arange(S0, device=dev))
        x = x.to(DTYPES[cfg.dtype])
        cache = _empty_cache(cfg, B, dev)
        layer = _prefill_layer
        if cfg.remat and torch.is_grad_enabled():
            layer = functools.partial(torch.utils.checkpoint.checkpoint,
                                      _prefill_layer, use_reentrant=False)
        for li, blk in enumerate(params["blocks"]):
            x, k4, v4 = layer(x, blk, cfg, kernels)
            # (B, S0, kv_h, D) -> per-head contiguous (B, kv_h, S0, D)
            kt, vt = k4.detach().transpose(1, 2), v4.detach().transpose(1, 2)
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


def _decode_body(params, cache, token, cfg: GptConfig, kernels: bool,
                 tp=None):
    """One decode step: write the token's K/V at pos in place, attend over
    the cache, MLP; advances cache["pos"] in place. No host read of a
    device value, so the step can be captured in a CUDA graph. With a tp
    group the params and cache are one rank's shards (heads/tp query and
    kv_h/tp KV heads; `decode_param_specs`, `decode_cache_specs`) and the
    out-proj and fc2 partials are summed over it."""
    ntp = 1 if tp is None else tp.size()
    H, KVH, D = cfg.heads // ntp, cfg.kv_h // ntp, cfg.head_dim
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
        x = x + _row_dot(a, blk["wo"], blk["bo"], tp)
        x = _ffn(x, _block_norm(x, blk, "ln2", cfg), blk, cfg, False,
                 kernels, decode=True, tp=tp)
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
# the tensor-parallel decode

def decode_param_specs(cfg: GptConfig, tp_axis: str = "tp",
                       quantized: bool = False) -> dict:
    """Specs of the tp decode's params (engine.py:1650 there): q/k/v and
    fc1 (and w3) column-parallel (heads / fc1 columns on tp), out-proj and
    fc2 row-parallel; everything else replicated. The per-layer list layout
    (the port has no stacked one). With quantized=True the matmul weights'
    specs are QTensors: the payload splits like the weight; the (1, out)
    scale splits with the out dim for column-parallel weights and is
    replicated for row-parallel ones. A MoE block's experts are
    replicated (the tp decode refuses MoE; these serve the dp-only GPT
    step)."""
    from ..parallel.mesh import P

    def col():
        w = P(None, tp_axis)
        return QTensor(q=w, scale=P(None, tp_axis)) if quantized else w

    def row():
        w = P(tp_axis, None)
        return QTensor(q=w, scale=P(None, None)) if quantized else w

    blk = {"ln1_g": P(), "wq": col(), "bq": P(tp_axis), "wk": col(),
           "bk": P(tp_axis), "wv": col(), "bv": P(tp_axis), "wo": row(),
           "bo": P(), "ln2_g": P()}
    if not cfg.rms_norm:
        blk.update({"ln1_b": P(), "ln2_b": P()})
    if cfg.swiglu:
        blk.update({"w1": col(), "w3": col(), "w2": row()})
    elif cfg.n_experts:
        blk.update({"wr": P(), "w1": P(), "w2": P()})
    else:
        blk.update({"w1": col(), "b1": P(tp_axis), "w2": row(), "b2": P()})
    out = {"wte": P(), "blocks": [dict(blk) for _ in range(cfg.layers)],
           "lnf_g": P(),
           "lm_head": QTensor(q=P(), scale=P()) if quantized else P()}
    if not cfg.rope:
        out["wpe"] = P()
    if not cfg.rms_norm:
        out["lnf_b"] = P()
    return out


def decode_cache_specs(cfg: GptConfig, tp_axis: str = "tp") -> dict:
    """The KV cache (L, B, kv_h, max_seq, D) splits its KV-head dim over
    tp; an int8 cache's (L, B, kv_h, max_seq) scales split the same dim
    (engine.py:1759 there)."""
    from ..parallel.mesh import P
    kv = P(None, None, tp_axis, None, None)
    specs = {"k": kv, "v": kv, "pos": P()}
    if cfg.kv_quant == "int8":
        specs["k_s"] = specs["v_s"] = P(None, None, tp_axis, None)
    return specs


def make_tp_decode_step(mesh, cfg: GptConfig, tp_axis: str = "tp",
                        use_kernels: bool | None = None):
    """The tensor-parallel decode step over `mesh` (engine.py:1723 there):
    `step(params, cache, token) -> (logits, cache)` on this rank's shards
    (`shard_tree` with `decode_param_specs` / `decode_cache_specs`), heads
    and the KV cache split over tp, one all-reduce per row-parallel GEMM;
    the logits are replicated. The cache is updated in place, as
    `make_decode_step`'s is. QTensor params (laid out by
    `decode_param_specs(quantized=True)`) are read as they come."""
    from ..parallel.mesh import mesh_shape
    tp = mesh_shape(mesh).get(tp_axis, 1)
    if cfg.heads % tp:
        raise ValueError(f"tp decode needs heads {cfg.heads} divisible by "
                         f"tp {tp}")
    if cfg.kv_h % tp:
        raise ValueError(f"GQA tp decode needs kv_heads {cfg.kv_h} "
                         f"divisible by tp {tp}")
    if cfg.n_experts:
        raise NotImplementedError(
            "tp decode does not shard MoE experts (use the ep-sharded MoE "
            "in parallel/moe.py; Megatron-style expert sharding is future "
            "work)")
    from ..parallel.mesh import as_mesh
    group = as_mesh(mesh).group(tp_axis)

    def step(params, cache, token):
        return _decode_body(params, cache, token, cfg,
                            _use_kernels(params, use_kernels), group)

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
    """Return `sample(logits (B, V), generator=None, noise=None) -> (B,)
    int32`.

    temperature 0 is greedy (top_k/top_p ignored). Otherwise logits are
    scaled by 1/temperature, truncated to the top_k largest and/or the
    smallest nucleus reaching mass top_p (the first token always kept), and
    sampled categorically by the Gumbel-max rule over uniform numbers drawn
    from a torch.Generator (its numbers differ from jax.random's), or over
    `noise` (B, V), numbers drawn before a CUDA graph's replay."""

    def sample(logits, generator=None, noise=None):
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
        u = noise if noise is not None else torch.rand(
            x.shape, generator=generator, device=x.device)
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
        # the captured graph reads these tensors: they live as long as it
        self.params, self.cache = params, cache
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


class Replayed:
    """`body()`, run eagerly, or replayed from one CUDA graph (graph=True,
    or None on a CUDA `device`): the counterpart of a `lax.scan` or
    `lax.while_loop` body under `jit`. The body reads and writes only
    tensors that outlive it (static buffers, updated in place). With a
    graph, the first call runs the body eagerly on a side stream (a real
    call: it builds the kernels and warms the allocator), then captures it;
    every later call replays the capture."""

    def __init__(self, body, graph: bool | None, device: torch.device):
        self._body, self._g = body, None
        self._graph = graph if graph is not None else device.type == "cuda"

    def __call__(self):
        if not self._graph:
            self._body()
        elif self._g is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream().wait_stream(side)
            self._g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._g):
                self._body()
        else:
            self._g.replay()


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
