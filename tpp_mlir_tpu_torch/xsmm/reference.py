"""Plain PyTorch versions of the slice's kernels.

These are the port's oracles. The kernel wrappers in `kernels.py` call them
for tensors that lie on the CPU, the CPU tests pin them to the JAX package's
kernels, and `chip_smoke.py` holds each Hopper kernel against them on the
card.

Precision, one meaning everywhere (kernel and plain version alike):
  * f32 at precision "default": operands rounded to bf16, products and sums
    in f32. This is what the compiled TPU kernels do
    (`tpp_mlir_tpu/xsmm/kernels.py:141 _mxu_input_dtype`); the JAX package's
    interpret mode keeps exact f32 instead, so tests of f32 "default" round
    the JAX side's operands to bf16 first.
  * f32 at precision "highest": true f32 products and sums. No TF32 anywhere:
    the kernels set nothing that enables it, and the plain version refuses
    to run while `torch.backends.cuda.matmul.allow_tf32` is on.
  * bf16: bf16 operands, f32 accumulation and f32 epilogue, one rounding to
    the output dtype at the end.
Normalizations (LayerNorm, the GEMM's LayerNorm prologue, softmax) compute
in f32 whatever the dtype; only their results are rounded.
"""

from __future__ import annotations

import torch

from .flags import (BinaryKey, BrgemmKey, ChainKey, DecodeAttnKey,
                    FlashMhaKey, FlashTrainBwdKey, FlashTrainKey, Int8GemmKey,
                    LayerNormKey)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# ROADMAP items that own the key types and options outside this slice
_OUTSIDE = {
    "UnaryKey": "queue A3 (eltwise xsmm.unary, left to PyTorch)",
    "BinaryKey": "queue A3 (xsmm.binary has no kernel: the executor runs "
                 "it as a PyTorch op, binary_reference)",
    "BlockedMatmulKey": "queue A13 / B19-B20",
    "BatchMatmulKey": "queue A13 / B21-B22",
    "ConvBrgemmKey": "queue A13 / B23",
    "ConvNhwcKey": "queue A13 / B24-B25",
    "GroupedGemmKey": "queue A9 / B16",
    "GroupedWgradKey": "queue A9 / B17",
}


def _refuse(what: str, item: str, key) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is outside the port's slice: ROADMAP queue {item}: {key}")


def check_slice(key) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for any key or
    option this slice does not port."""
    if not isinstance(key, (BrgemmKey, ChainKey, FlashMhaKey, LayerNormKey,
                            DecodeAttnKey, Int8GemmKey, FlashTrainKey)):
        name = type(key).__name__
        raise NotImplementedError(
            f"{name} is outside the port's slice: ROADMAP "
            f"{_OUTSIDE.get(name, 'queue A')}")
    if isinstance(key, DecodeAttnKey):
        _check_decode_attn(key)
        return
    if isinstance(key, FlashTrainKey):
        if key.dtype not in DTYPES:
            raise _refuse(f"dtype {key.dtype!r}", "A14 (f16 keys)", key)
        return
    if isinstance(key, Int8GemmKey):
        if key.out_dtype not in DTYPES:
            raise _refuse(f"dtype {key.out_dtype!r}", "A14 (f16 keys)", key)
        if key.unary_kind not in (None, *UNARY_FNS):
            raise ValueError(f"unknown unary {key.unary_kind!r}")
        return
    for dt in (key.dtype, key.out_dtype or key.dtype):
        if dt not in DTYPES:
            raise _refuse(f"dtype {dt!r}", "A14 (f16 keys)", key)
    if key.precision not in ("default", "highest"):
        raise ValueError(f"unknown precision {key.precision!r}")
    if isinstance(key, BrgemmKey):
        if key.prologue == "ln_stats" or key.ln_stats_out:
            raise _refuse("ln_stats/ln_stats_out", "A6 / B2", key)
        if key.prologue not in (None, "layer_norm"):
            raise ValueError(f"unknown prologue {key.prologue!r}")
        if key.prologue and (key.batch != 1 or key.vnni or key.transpose_b):
            raise ValueError(f"the layer_norm prologue needs the whole A row: "
                             f"batch 1, flat, no transpose_b: {key}")
    elif isinstance(key, ChainKey):
        if key.pingpong:
            raise _refuse("pingpong chain bench", "B5", key)
    elif isinstance(key, FlashMhaKey):
        if not key.heads:
            raise _refuse("flat-layout attention (heads = 0)",
                          "A6 / B6, B8-B11", key)
        if key.repeats:
            raise _refuse("attention repeats (warm bench)", "A6 / B11", key)
        if key.strategy not in ("auto", "tokens"):
            # the reference falls through from a forced strategy it cannot
            # run (ADVICE.md #2); the port raises instead
            raise _refuse(f"attention strategy {key.strategy!r}",
                          "A6 / B6-B10, B14 (ADVICE.md #2)", key)
        if key.qkv_packed and key.seq != key.seq_kv:
            raise ValueError(f"qkv_packed needs seq == seq_kv: {key}")


def mxu_dtype(dtype: str, precision: str) -> torch.dtype:
    """The dtype the products see (see the module docstring)."""
    if dtype == "f32" and precision == "default":
        return torch.bfloat16
    return DTYPES[dtype]


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain version needs true f32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    return torch.matmul(a.float(), b.float())


# exp2-domain exact-erf gelu, the same constants and evaluation order as
# tpp_mlir_tpu/xsmm/kernels.py:85 _gelu_exp2
_GELU_Q5 = (0.0004712450553503085, -0.007063951197523899,
            0.05175779870672941, -0.26125505922286846,
            1.1507275369545586, 4.939192122802906e-05)
_GELU_K = 0.7213475204444817        # log2(e)/2
_GELU_UMAX = 5.939696961966999      # 4.2*sqrt2


def gelu_exp2(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    u = torch.clamp(xf.abs(), max=_GELU_UMAX)
    q = torch.full_like(u, _GELU_Q5[0])
    for coef in _GELU_Q5[1:]:
        q = q * u + coef
    e = torch.exp2(-(_GELU_K * u * u + q))
    return (torch.relu(xf) - 0.5 * u * e).to(x.dtype)


UNARY_FNS = {
    "relu": torch.relu,
    "identity": lambda x: x,
    "exp": torch.exp,
    "square": lambda x: x * x,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "tanh": torch.tanh,
    "gelu": gelu_exp2,
    "gelu_tanh": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "negate": lambda x: -x,
    "zero": torch.zeros_like,
}

BINARY_FNS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "max": torch.maximum,
}


def unvnni(b: torch.Tensor) -> torch.Tensor:
    """[..., k/v, n, v] -> [..., k, n] (tpp_mlir_tpu/xsmm/kernels.py:154)."""
    *lead, kv, n, v = b.shape
    return b.movedim(-1, -2).reshape(*lead, kv * v, n)


def canonical_d(key: BrgemmKey, d: torch.Tensor) -> torch.Tensor:
    """The binary operand D as the 2-D shape its broadcast names."""
    if d.ndim == 0:
        return d.reshape(1, 1)
    if d.ndim == 1:
        return d.reshape(1, -1) if key.binary_bcast == "bcast_col" \
            else d.reshape(-1, 1)
    return d


def ln_prologue(key: BrgemmKey, a, gamma=None, beta=None):
    """The GEMM's LayerNorm prologue on A (1, m, k), in f32: the one-pass
    statistics of the TPU kernels (mean, E[x^2] - mean^2;
    tpp_mlir_tpu/xsmm/kernels.py:688-699 and :423-429), then gamma/beta."""
    af = a.float()
    mu = af.mean(-1, keepdim=True)
    var = (af * af).mean(-1, keepdim=True) - mu * mu
    af = (af - mu) * torch.rsqrt(var + key.prologue_eps)
    if key.prologue_affine:
        af = af * gamma.float().reshape(-1) + beta.float().reshape(-1)
    return af


def brgemm_reference(key: BrgemmKey):
    """C (+)= sum_b A'[b] @ B[b], then unary(acc OP D), as one function;
    A' is A, or A through the LayerNorm prologue (gamma/beta trail)."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]

    def fn(a, b, c=None, d=None, gamma=None, beta=None):
        if key.prologue:
            a = ln_prologue(key, a, gamma, beta)
        if key.vnni:
            b = unvnni(b)
        if key.transpose_b:
            b = b.transpose(-1, -2)
        acc = _f32_matmul(a.to(mdt), b.to(mdt)).sum(0)
        if not key.beta0:
            acc = acc + c.float()
        if key.binary_kind:
            acc = BINARY_FNS[key.binary_kind](acc, canonical_d(key, d).float())
        if key.unary_kind:
            acc = UNARY_FNS[key.unary_kind](acc)
        return acc.to(out_dt)
    return fn


def chain_reference(key: ChainKey):
    """act(...act(x@W1+b1)@W2...): f32 between layers, each layer's input
    rounded to the MXU dtype (B3). With repeats > 1 the chain runs `repeats`
    times and the state fed back is held in the MXU dtype (B4)."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]
    L = len(key.dims) - 1
    bench = key.repeats > 1
    if bench and key.dims[0] != key.dims[-1]:
        raise ValueError(f"bench chain must be shape-preserving: {key}")

    def fn(x, *wb):
        step = 2 if key.has_bias else 1
        ws = [wb[step * i].to(mdt) for i in range(L)]
        bs = [wb[step * i + 1].reshape(1, -1).float() for i in range(L)] \
            if key.has_bias else [None] * L
        h = x.float()
        for _ in range(max(1, key.repeats)):
            for li in range(L):
                z = _f32_matmul(h.to(mdt), ws[li])
                if bs[li] is not None:
                    z = z + bs[li]
                kind = key.unary_kind if li < L - 1 else key.last_unary
                h = UNARY_FNS[kind or "identity"](z)
            if bench:
                h = h.to(mdt).float()
        return h.to(out_dt)
    return fn


LOG2E = 1.4426950408889634     # tpp_mlir_tpu/xsmm/kernels.py:1615


def attention_reference(key: FlashMhaKey):
    """softmax(Q K^T * scale) V on the token layout (B, S, H*D), with B7's
    own math (tpp_mlir_tpu/xsmm/kernels.py:2346-2370): Q in the MXU dtype
    scaled by scale*log2(e) in f32 and rounded to the MXU dtype again, an
    exp2 softmax over the whole row with -1e30 at causal-masked places, P
    normalized, rounded to the MXU dtype, then P V; products and sums f32.
    With qkv_packed, q is the one (B, S, 3E) [Q|K|V] operand (k and v, if
    given, are ignored, as the executor passes the packed operand thrice)."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]
    H, D = key.heads, key.head_dim
    E = H * D

    def fn(q, k=None, v=None):
        if key.qkv_packed:
            q, k, v = q[..., :E], q[..., E:2 * E], q[..., 2 * E:]
        B, S, Skv = q.shape[0], q.shape[1], k.shape[1]

        def split(x, s):        # (B, s, E) -> (B, H, s, D) in the MXU dtype
            return x.to(mdt).reshape(B, s, H, D).transpose(1, 2)
        qh = (split(q, S).float() * (key.scale * LOG2E)).to(mdt)
        s = _f32_matmul(qh, split(k, Skv).transpose(-1, -2))
        if key.causal:
            keep = torch.ones(S, Skv, dtype=torch.bool, device=s.device)
            s = s.masked_fill(~keep.tril(), -1e30)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        p = (p / p.sum(-1, keepdim=True)).to(mdt)
        o = _f32_matmul(p, split(v, Skv))
        return o.transpose(1, 2).reshape(B, S, E).to(out_dt)
    return fn


def layer_norm_reference(key: LayerNormKey):
    """Row LayerNorm of (m, n): two-pass f32 statistics, biased variance,
    optional affine, one rounding (tpp_mlir_tpu/xsmm/kernels.py:3281)."""
    check_slice(key)
    out_dt = DTYPES[key.out_dtype or key.dtype]

    def fn(x, gamma=None, beta=None):
        xf = x.float()
        d = xf - xf.mean(-1, keepdim=True)
        y = d * torch.rsqrt((d * d).mean(-1, keepdim=True) + key.eps)
        if key.affine:
            y = y * gamma.float().reshape(-1) + beta.float().reshape(-1)
        return y.to(out_dt)
    return fn


def binary_reference(key: BinaryKey):
    """xsmm.binary: the reference's kernel is jnp (tpp_mlir_tpu/xsmm/
    kernels.py:3343), so the port's is this PyTorch op and no CUDA kernel:
    both operands in f32 with NumPy broadcasting, one rounding."""
    if key.kind not in BINARY_FNS:
        raise ValueError(f"unknown binary kind {key.kind!r}")
    for dt in (key.dtype, key.out_dtype or key.dtype):
        if dt not in DTYPES:
            raise _refuse(f"dtype {dt!r}", "A14 (f16 keys)", key)
    fn = BINARY_FNS[key.kind]
    out_dt = DTYPES[key.out_dtype or key.dtype]

    def prep(x, bcast):
        # bcast_row: a rank-1 operand indexes the major dim
        x = x.float()
        return x.reshape(-1, 1) if bcast == "bcast_row" and x.ndim == 1 \
            else x
    return lambda a, b: fn(prep(a, key.bcast_a),
                           prep(b, key.bcast_b)).to(out_dt)


def _check_decode_attn(key: DecodeAttnKey) -> None:
    """The variants decode_attn.py accepts (its asserts, :113-115, :280)."""
    if key.dtype not in DTYPES:
        raise _refuse(f"dtype {key.dtype!r}", "A14 (f16 keys)", key)
    if key.groups < 1:
        raise ValueError(f"groups must be >= 1: {key}")
    if key.pack2 and (key.groups != 1 or key.kv_quant or key.heads % 2):
        raise ValueError(f"pack2 is MHA with an even head count and "
                         f"bf16/f32 KV only: {key}")


def decode_attn_reference(key: DecodeAttnKey):
    """Single-token attention over the KV cache, with build_decode_attn's
    math (tpp_mlir_tpu/xsmm/decode_attn.py:120-160), all in f32:
    s = sum_d k*q * D^-0.5 [* K scale], -1e30 where s > pos, exp(s - max)
    normalized [* V scale], out = sum_s p*v.

    fn(q, k, v, pos, li=None, k_s=None, v_s=None) -> f32 out. q is (B, H, D),
    (B, H, G, D) for groups G > 1, or (B, H/2, 2D) for pack2; k/v are the
    full stacked (L, B, H, S, D) cache when `stacked` (layer li), else one
    layer's (B, H, S, D) (pack2: (.., H/2, S, 2D)); pos is an int32 scalar
    or (B,) tensor (S, the free-slot sentinel, makes every row live);
    k_s/v_s the (L, B, H, S) [or (B, H, S)] f32 scales of an int8 cache."""
    check_slice(key)
    B, H, S, D, G = (key.batch, key.heads, key.seq, key.head_dim,
                     key.groups)
    scale = D ** -0.5

    def fn(q, k, v, pos, li=None, k_s=None, v_s=None):
        if key.stacked:
            k, v = k[li], v[li]
            if key.kv_quant:
                k_s, v_s = k_s[li], v_s[li]
        if key.pack2:        # head h at slot h//2, lanes (h%2)*D
            qf = q.float().reshape(B, H, 1, D)
            kf, vf = (t.float().reshape(B, H // 2, S, 2, D).transpose(2, 3)
                      .reshape(B, H, S, D) for t in (k, v))
        else:
            qf = q.float().reshape(B, H, G, D)
            kf, vf = k.float(), v.float()
        s = (kf[:, :, None] * qf[:, :, :, None]).sum(-1) * scale  # (B,H,G,S)
        if key.kv_quant:
            s = s * k_s.float()[:, :, None]
        p_live = torch.as_tensor(pos, device=q.device).reshape(-1, 1, 1, 1)
        live = torch.arange(S, device=q.device) <= p_live
        s = torch.where(live, s, torch.full_like(s, -1e30))
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        if key.kv_quant:
            p = p * v_s.float()[:, :, None]
        out = (p[..., None] * vf[:, :, None]).sum(-2)            # (B,H,G,D)
        if key.pack2:
            return out.reshape(B, H // 2, 2 * D)
        return out[:, :, 0] if G == 1 else out
    return fn


def int8_gemm_reference(key: Int8GemmKey):
    """(xq @ wq) exactly, then * xscale[m] * wscale[n] (+ bias) in f32, the
    unary, one rounding (tpp_mlir_tpu/xsmm/kernels.py:1422-1430). The s32
    sum is taken in f64, where every such sum is exact, and its rounding to
    f32 is the kernel's int32 -> f32 conversion."""
    check_slice(key)
    m, n = key.m, key.n
    out_dt = DTYPES[key.out_dtype]

    def fn(xq, wq, xscale, wscale, bias=None):
        acc = (xq.double() @ wq.double()).float()
        y = acc * xscale.reshape(m, 1).float() * wscale.reshape(1, n).float()
        if key.has_bias:
            y = y + bias.reshape(1, n).float()
        if key.unary_kind:
            y = UNARY_FNS[key.unary_kind](y)
        return y.to(out_dt)
    return fn


def _logits2(key: FlashTrainKey, q, k):
    """(B, H, S, S) f32 logits in the base-2 exponent domain of (B, S, H, D)
    q and k: the product with f32 sums, then * scale*log2(e), -1e30 above
    the diagonal when causal (tpp_mlir_tpu/xsmm/flash_train.py:126)."""
    s2 = _f32_matmul(q.transpose(1, 2), k.transpose(1, 2).transpose(-1, -2))
    s2 = s2 * (key.scale * LOG2E)
    if key.causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s2 = s2.masked_fill(~keep, -1e30)
    return s2


def flash_train_fwd_reference(key: FlashTrainKey):
    """B14's function (tpp_mlir_tpu/xsmm/flash_train.py:156-171) on the
    (B, S, H, D) layout: fn(q, k, v) -> (o, lse2). O = (P V) / l with
    P = exp2(s2 - m2) rounded to bf16 for a bf16 key before the product,
    l the f32 row sum of P; o in the operand dtype (the code writes `odt`,
    whatever the docstring there says), (B, S, H, D); lse2 = m2 +
    log(l) log2(e), (B, H, S) f32, the base-2 log-sum-exp with the scale
    folded in, private to B14 and B18."""
    check_slice(key)
    pv = DTYPES[key.dtype]

    def fn(q, k, v):
        s2 = _logits2(key, q, k)
        m2 = s2.amax(-1, keepdim=True)
        p = torch.exp2(s2 - m2)
        l = p.sum(-1, keepdim=True)
        o = _f32_matmul(p.to(pv), v.transpose(1, 2)) / l      # (B, H, S, D)
        lse2 = (m2 + torch.log(l) * LOG2E)[..., 0]
        return o.transpose(1, 2).to(pv).contiguous(), lse2
    return fn


def flash_train_bwd_reference(key: FlashTrainKey):
    """B18's function (tpp_mlir_tpu/xsmm/flash_train.py:201-227) on the
    (B, S, H, D) layout: fn(q, k, v, do, lse2, delta) -> (dq, dk, dv) in the
    operand dtype, with lse2 and delta = rowsum(dO * O) as (B, H, S) f32.
    P = exp2(s2 - lse2); dV = P'^T dO; dP = dO V^T; dS = (P (dP - delta)
    scale)'; dQ = dS K; dK = dS^T Q, where ' rounds to bf16 for a bf16 key;
    products and sums in f32."""
    check_slice(key)
    pv = DTYPES[key.dtype]

    def fn(q, k, v, do, lse2, delta):
        p = torch.exp2(_logits2(key, q, k) - lse2[..., None])
        dot = do.transpose(1, 2)
        dv = _f32_matmul(p.to(pv).transpose(-1, -2), dot)
        dp = _f32_matmul(dot, v.transpose(1, 2).transpose(-1, -2))
        ds = (p * (dp - delta[..., None]) * key.scale).to(pv)
        dq = _f32_matmul(ds, k.transpose(1, 2))
        dk = _f32_matmul(ds.transpose(-1, -2), q.transpose(1, 2))
        return tuple(x.transpose(1, 2).to(pv).contiguous()
                     for x in (dq, dk, dv))
    return fn


_REFERENCES = {BrgemmKey: brgemm_reference, ChainKey: chain_reference,
               FlashMhaKey: attention_reference,
               LayerNormKey: layer_norm_reference,
               DecodeAttnKey: decode_attn_reference,
               Int8GemmKey: int8_gemm_reference,
               FlashTrainKey: flash_train_fwd_reference,
               FlashTrainBwdKey: flash_train_bwd_reference}


def reference_kernel(key):
    """The plain version for any key of the slice."""
    check_slice(key)   # raises for keys outside it, naming the ROADMAP item
    return _REFERENCES[type(key)](key)
