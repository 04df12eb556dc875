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
    the kernels set nothing that enables it, the plain version refuses
    to run while `torch.backends.cuda.matmul.allow_tf32` is on, and every
    cuDNN convolution runs under `no_tf32_conv` (cuDNN's own TF32 flag,
    `torch.backends.cudnn.allow_tf32`, is on by default).
  * bf16: bf16 operands, f32 accumulation and f32 epilogue, one rounding to
    the output dtype at the end.
Normalizations (LayerNorm, the GEMM's LayerNorm prologue, softmax) compute
in f32 whatever the dtype; only their results are rounded.
"""

from __future__ import annotations

import contextlib

import torch

from .flags import (BatchMatmulKey, BinaryKey, BlockedMatmulKey, BrgemmKey,
                    ChainKey, ConvBrgemmKey, ConvNhwcKey, DecodeAttnKey,
                    FlashMhaKey, FlashTrainBwdKey, FlashTrainKey,
                    GroupedGemmKey, GroupedWgradKey, Int8GemmKey,
                    LayerNormKey, UnaryKey)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# ROADMAP items that own the key types and options outside this slice
_OUTSIDE = {
    "UnaryKey": "queue A3 (xsmm.unary has no kernel: the executor runs its "
                "transpose, relu and vnni2 as PyTorch ops, unary_reference)",
    "BinaryKey": "queue A3 (xsmm.binary has no kernel: the executor runs "
                 "it as a PyTorch op, binary_reference)",
}

# the reference's words for a strided channel-blocked conv
# (tpp_mlir_tpu/xsmm/kernels.py:2785-2788)
CONV_BLOCKED_STRIDE = (
    "stride>1 conv stays on the XLA conv path (reference also restricts "
    "conv-to-BRGEMM to stride 1, docs/ConvMapping.md)")


def _refuse(what: str, item: str, key) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is outside the port's slice: ROADMAP queue {item}: {key}")


def check_slice(key) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for any key or
    option this slice does not port."""
    if not isinstance(key, (BrgemmKey, BatchMatmulKey, ChainKey, FlashMhaKey,
                            LayerNormKey, DecodeAttnKey, Int8GemmKey,
                            FlashTrainKey, GroupedGemmKey, GroupedWgradKey,
                            ConvNhwcKey, BlockedMatmulKey, ConvBrgemmKey)):
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
    out_dt = "f32" if isinstance(key, GroupedWgradKey) else key.out_dtype
    for dt in (key.dtype, out_dt or key.dtype):
        if dt not in DTYPES:
            raise _refuse(f"dtype {dt!r}", "A14 (f16 keys)", key)
    if key.precision not in ("default", "highest"):
        raise ValueError(f"unknown precision {key.precision!r}")
    if isinstance(key, (GroupedGemmKey, GroupedWgradKey)):
        if key.bm < 1 or key.m % key.bm:
            raise ValueError(f"m must be a multiple of bm: {key}")
        if isinstance(key, GroupedGemmKey) and \
                key.unary_kind not in (None, *UNARY_FNS):
            raise ValueError(f"unknown unary {key.unary_kind!r}")
    elif isinstance(key, BrgemmKey):
        if key.prologue == "ln_stats" or key.ln_stats_out:
            raise _refuse("ln_stats/ln_stats_out", "A6 / B2", key)
        if key.prologue not in (None, "layer_norm"):
            raise ValueError(f"unknown prologue {key.prologue!r}")
        if key.prologue and (key.batch != 1 or key.vnni or key.transpose_b):
            raise ValueError(f"the layer_norm prologue needs the whole A row: "
                             f"batch 1, flat, no transpose_b: {key}")
    elif isinstance(key, ChainKey):
        if key.pingpong and key.repeats > 1 and len(key.dims) != 2:
            raise ValueError(f"the ping-pong bench is one fc layer: {key}")
    elif isinstance(key, FlashMhaKey):
        attention_route(key)
    elif isinstance(key, BlockedMatmulKey):
        _check_blocked(key)
    elif isinstance(key, ConvBrgemmKey):
        if (key.stride_h, key.stride_w) != (1, 1):
            raise NotImplementedError(CONV_BLOCKED_STRIDE)
        if key.binary_kind is not None and key.binary_bcast != "bcast_col":
            raise ValueError(f"a channel-blocked conv's D is a bias [Kb, k] "
                             f"(bcast_col): {key}")
        _check_epilogue(key)
    elif isinstance(key, ConvNhwcKey):
        conv_route(key)
        if key.binary_kind is not None and key.binary_bcast not in (
                "bcast_col", "none"):
            raise ValueError(f"a conv's D is a channel bias (bcast_col) or "
                             f"a full residual (none): {key}")
        _check_epilogue(key)


def _check_epilogue(key) -> None:
    if key.binary_kind not in (None, *BINARY_FNS) or \
            key.unary_kind not in (None, *UNARY_FNS):
        raise ValueError(f"unknown epilogue kind: {key}")


def _check_blocked(key: BlockedMatmulKey) -> None:
    """B19/B20's variants: a bias is [Nb, nb] added along the columns
    (the reference passes it flat and indexes it by column block), VNNI 2
    pairs of k, and B20 feeds its output back (square blocks, no C)."""
    _check_epilogue(key)
    if key.binary_kind is not None and key.binary_bcast != "bcast_col":
        raise ValueError(f"a blocked GEMM's D is a bias [Nb, nb] "
                         f"(bcast_col): {key}")
    if key.vnni not in (0, 2) or (key.vnni and key.kb % key.vnni):
        raise ValueError(f"VNNI factor {key.vnni} must be 0 or 2 and divide "
                         f"kb: {key}")
    if key.repeats and (key.Nb != key.Kb or key.nb != key.kb
                        or not key.beta0):
        raise ValueError(f"the blocked warm bench needs square feedback "
                         f"(Nb == Kb, nb == kb) and beta_0: {key}")


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


def blocked_product(x, w):
    """sum_r X[i, r] @ W[j, r] of a packed activation x [Mb, Kb, mb, kb]
    and packed weights w [Nb, Kb, kb, nb] (both already in the MXU dtype),
    as one f32 GEMM over the unpacked forms: f32 [Mb, Nb, mb, nb]."""
    Mb, Kb, mb, kb = x.shape
    Nb, nb = w.shape[0], w.shape[-1]
    x2 = x.permute(0, 2, 1, 3).reshape(Mb * mb, Kb * kb)
    w2 = w.permute(1, 2, 0, 3).reshape(Kb * kb, Nb * nb)
    return _f32_matmul(x2, w2).reshape(Mb, mb, Nb, nb).permute(0, 2, 1, 3)


def blocked_matmul_reference(key: BlockedMatmulKey):
    """B19 (tpp_mlir_tpu/xsmm/kernels.py:763 _build_blocked_matmul) as one
    function: C[i, j] (+)= sum_r A[i, r] @ B[j, r] over MXU-dtype operands
    in f32, then unary(acc OP bias[j]) with the bias [Nb, nb] along the
    columns, one rounding to the output dtype. A VNNI B [Nb, Kb, kb/2, nb,
    2] is un-VNNI'd first (:772-779). With repeats (B20, :870) the product
    runs `repeats` times, beta_0, each output held in the MXU dtype and fed
    back as the next packed activation (Nb == Kb, nb == kb); the result is
    that state in the output dtype. fn(a, b, c=None, d=None)."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]

    def fn(a, b, c=None, d=None):
        w = (unvnni(b) if key.vnni else b).to(mdt)
        bias = d.float().reshape(1, key.Nb, 1, key.nb) \
            if key.binary_kind else None

        def epilogue(acc):
            if bias is not None:
                acc = BINARY_FNS[key.binary_kind](acc, bias)
            return UNARY_FNS[key.unary_kind](acc) if key.unary_kind else acc
        if key.repeats:
            x = a.to(mdt)
            for _ in range(key.repeats):
                x = epilogue(blocked_product(x, w)).to(mdt)
            return x.to(out_dt)
        acc = blocked_product(a.to(mdt), w)
        if not key.beta0:
            acc = acc + c.float()
        return epilogue(acc).to(out_dt)
    return fn


def chain_reference(key: ChainKey):
    """act(...act(x@W1+b1)@W2...): f32 between layers, each layer's input
    rounded to the MXU dtype (B3). With repeats > 1 the chain runs `repeats`
    times and the state fed back is held in the MXU dtype (B4); a pingpong
    key runs B5 instead (_pingpong_reference)."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]
    L = len(key.dims) - 1
    bench = key.repeats > 1
    if bench and key.pingpong:
        return _pingpong_reference(key, mdt, out_dt)
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


def _pingpong_reference(key: ChainKey, mdt, out_dt):
    """B5's function (tpp_mlir_tpu/xsmm/kernels.py:1946-1974) for one fc
    (k, n): the state h (m, k) in the MXU dtype; even repeats make
    hn = act(h W + b) in the MXU dtype (`last_unary` is the act), odd
    repeats make h = hn W^T with no bias and no act; the result is hn after
    the last forward repeat."""
    R = key.repeats
    last_fwd = R - 1 if (R - 1) % 2 == 0 else R - 2
    act = UNARY_FNS[key.last_unary or "identity"]

    def fn(x, w, b=None):
        w = w.to(mdt)
        h, out = x.to(mdt), None
        for r in range(R):
            if r % 2:
                h = _f32_matmul(hn, w.T).to(mdt)
                continue
            z = _f32_matmul(h, w)
            if key.has_bias:
                z = z + b.reshape(1, -1).float()
            hn = act(z).to(mdt)
            if r == last_fwd:
                out = hn
        return out.to(out_dt)
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


FLAT_STRATEGIES = ("auto", "grouped", "qblock", "twocall", "twocall2")


def attention_route(key: FlashMhaKey) -> str:
    """Which of the port's attention paths runs `key`, or raise.

    The reference lets a forced strategy fall through to another kernel
    without a word (ADVICE.md #2, tpp_mlir_tpu/xsmm/kernels.py:1674-1745).
    The port runs a strategy wherever the reference's builder would run
    that strategy's kernel, and raises wherever it would run another:
      "kernel"      csrc/attention.cu: flat layout (heads = 0) under auto,
                    grouped (B9), qblock (B8), twocall (B10a), twocall2
                    (B10b) and B6's blocked form (auto with bq/bk), which
                    differ only in how they schedule the TPU's VMEM; token
                    layout under auto or tokens (B7);
      "bench"       the same kernel's repeats loop (B11), for repeats > 0
                    under any strategy above (the reference reads no
                    strategy once repeats is set, kernels.py:1746);
      "flash_heads" token layout, causal, seq == seq_kv, f32/bf16,
                    precision "default" (the reference's gate, :1674-1681):
                    B14's forward, csrc/flash_train.cu;
      "xla"         token layout: the composed PyTorch attention (the
                    reference composes it in XLA, :2198; no Pallas kernel).
    """
    S, Skv = key.seq, key.seq_kv
    if key.qkv_packed and (not key.heads or S != Skv):
        raise ValueError(f"qkv_packed needs the token layout and seq == "
                         f"seq_kv: {key}")
    if not key.heads:
        if key.strategy in ("tokens", "flash_heads", "xla"):
            raise NotImplementedError(
                f"strategy {key.strategy!r} names a token-layout kernel; on "
                f"the flat layout the reference falls through to B6 without "
                f"a word (ADVICE.md #2): {key}")
        if key.strategy not in FLAT_STRATEGIES:
            raise ValueError(f"unknown attention strategy "
                             f"{key.strategy!r}: {key}")
        # the reference's block overrides must divide (kernels.py:1767-1773)
        if key.bk and Skv % key.bk:
            raise ValueError(f"flash bk override {key.bk} must divide "
                             f"seq_kv {Skv}")
        if key.bq and S % key.bq:
            raise ValueError(f"flash bq override {key.bq} must divide "
                             f"seq {S}")
        if key.repeats:
            return "bench"
        if key.strategy in ("twocall", "twocall2") and (
                not key.causal or S != Skv or S % 2):
            # the builders return None for such shapes (:2512-2514,
            # :2635-2637) and the reference raises
            raise ValueError(f"{key.strategy} causal attention does not "
                             f"apply to {key}")
        return "kernel"
    if key.strategy in ("auto", "tokens"):
        return "bench" if key.repeats else "kernel"
    if key.strategy == "flash_heads" and not key.repeats and key.causal \
            and S == Skv and key.dtype in DTYPES \
            and key.precision == "default":
        return "flash_heads"
    if key.strategy == "xla" and not key.repeats:
        return "xla"
    raise NotImplementedError(
        f"strategy {key.strategy!r} on the token layout: the reference runs "
        f"another kernel here without a word (ADVICE.md #2): {key}")


def _heads(key: FlashMhaKey, x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, s, H*D) token layout or (B*H, s, D) flat layout -> (B', H', s,
    D)."""
    if key.heads:
        return x.reshape(x.shape[0], s, key.heads, key.head_dim) \
            .transpose(1, 2)
    return x[:, None]


def _merge(key: FlashMhaKey, o: torch.Tensor) -> torch.Tensor:
    """The inverse of _heads."""
    if key.heads:
        return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)
    return o[:, 0]


def _attend(key: FlashMhaKey, mdt, q, k, v):
    """One pass of csrc/attention.cu on (B', H', s, D) tensors, all f32 sums:
    Q rounded to the MXU dtype, scaled by scale*log2(e) in f32 and rounded
    again; exp2 scores with -1e30 at causal-masked places (rows >= cols,
    top-left aligned); P = exp2(s - max) rounded to the MXU dtype; P V
    divided by the f32 row sum of the unrounded P after the product, as the
    online kernel does and as B8/B9/B11 do."""
    qh = (q.to(mdt).float() * (key.scale * LOG2E)).to(mdt)
    s = _f32_matmul(qh, k.to(mdt).transpose(-1, -2))
    if key.causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
        s = s.masked_fill(~keep.tril(), -1e30)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    return _f32_matmul(p.to(mdt), v.to(mdt)) / p.sum(-1, keepdim=True)


def flat_attention_reference(key: FlashMhaKey):
    """The flat layout's function (B6, B8, B9, B10a, B10b: one function,
    scheduled five ways for the TPU's VMEM): _attend on (B*H, S, D), and,
    with repeats > 0, B11's warm bench (tpp_mlir_tpu/xsmm/kernels.py:
    2151-2176): the output rounded to the MXU dtype is the next Q, `repeats`
    times, and the last one, still in the MXU dtype, is the result. B11 and
    the kernel round P to the MXU dtype, where the TPU's B11 rounds it to
    the key's dtype (:2170); the two differ only for f32 "default". The
    token layout runs the same bench on each head's columns."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]

    def fn(q, k, v):
        S, Skv = q.shape[1], k.shape[1]
        kh, vh = _heads(key, k, Skv), _heads(key, v, Skv)
        h = _heads(key, q, S)
        for _ in range(max(1, key.repeats)):
            h = _attend(key, mdt, h, kh, vh)
            if key.repeats:
                h = h.to(mdt)
        return _merge(key, h).to(out_dt)
    return fn


def composed_attention_reference(key: FlashMhaKey):
    """Token-layout strategy "xla": the attention composed of PyTorch ops,
    as the reference composes it in XLA (tpp_mlir_tpu/xsmm/kernels.py:2198):
    scores in f32 from MXU-dtype operands, scaled, -inf at causal-masked
    places, an f32 softmax rounded to the MXU dtype, then P V in f32."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]

    def fn(q, k, v):
        S, Skv = q.shape[1], k.shape[1]
        s = _f32_matmul(_heads(key, q, S).to(mdt),
                        _heads(key, k, Skv).to(mdt).transpose(-1, -2))
        s = s * key.scale
        if key.causal:
            keep = torch.ones(S, Skv, dtype=torch.bool, device=s.device)
            s = s.masked_fill(~keep.tril(), float("-inf"))
        p = torch.softmax(s, dim=-1).to(mdt)
        return _merge(key, _f32_matmul(p, _heads(key, v, Skv).to(mdt))) \
            .to(out_dt)
    return fn


def flash_heads_key(key: FlashMhaKey) -> FlashTrainKey:
    """B14's key for a token-layout FlashMhaKey under "flash_heads"."""
    return FlashTrainKey(batch=key.batch, heads=key.heads, seq=key.seq,
                         head_dim=key.head_dim, dtype=key.dtype,
                         causal=key.causal, scale=key.scale)


def _flash_heads_reference(key: FlashMhaKey):
    """Strategy "flash_heads": B14's plain version on the (B, S, H, D) view
    of the token layout, its output cast to the out dtype."""
    fwd = flash_train_fwd_reference(flash_heads_key(key))
    out_dt = DTYPES[key.out_dtype or key.dtype]
    B, S, H, D = key.batch, key.seq, key.heads, key.head_dim

    def fn(q, k, v):
        if key.qkv_packed:
            E = H * D
            q, k, v = q[..., :E], q[..., E:2 * E], q[..., 2 * E:]
        o, _ = fwd(*(x.reshape(B, S, H, D) for x in (q, k, v)))
        return o.reshape(B, S, H * D).to(out_dt)
    return fn


def mha_reference(key: FlashMhaKey):
    """The plain version of whatever attention_route picks for `key`."""
    route = attention_route(key)
    if route == "xla":
        return composed_attention_reference(key)
    if route == "flash_heads":
        return _flash_heads_reference(key)
    if route == "bench" or not key.heads:
        inner = flat_attention_reference(key)
        if not key.qkv_packed:
            return inner
        E = key.heads * key.head_dim
        return lambda x, *_: inner(x[..., :E], x[..., E:2 * E],
                                   x[..., 2 * E:])
    return attention_reference(key)


def batch_matmul_reference(key: BatchMatmulKey):
    """B21/B22's function (tpp_mlir_tpu/xsmm/kernels.py:1009-1031,
    :1097-1109): O[b] = f(A[b]) @ B[b] (+ C[b]) in f32 from MXU-dtype
    operands, one rounding to the out dtype. With softmax_lhs, f is the row
    softmax over k taken in f32 from A's values and rounded to the MXU dtype
    before the product (the TPU wrapper leaves an f32 A's softmax in f32; at
    precision "default" the port rounds every product operand to bf16, as
    the module docstring says). With lhs_shared, A is one (m, k) matrix for
    every b."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]

    def fn(a, b, c=None):
        af = a.float()
        if key.softmax_lhs:
            e = torch.exp(af - af.amax(-1, keepdim=True))
            af = e / e.sum(-1, keepdim=True)
        acc = _f32_matmul(af.to(mdt), b.to(mdt))
        if not key.beta0:
            acc = acc + c.float()
        return acc.to(out_dt)
    return fn


CONV_STRATEGIES = ("auto", "window", "fullrow", "xla")


def conv_route(key: ConvNhwcKey) -> str:
    """Which of the port's conv paths runs `key`, or raise.

      "kernel"  csrc/conv.cu, stride 1 under auto, window (B24) and fullrow
                (B25): B24 and B25 compute one function, and fullrow's
                padded width is a TPU sublane artifact
                (tpp_mlir_tpu/xsmm/kernels.py:3140-3142);
      "xla"     torch.nn.functional.conv2d and the epilogue in PyTorch, TF32
                off: strategy xla at any stride, and auto at stride > 1 (the
                reference's auto is xla at every stride, :2927-2934; it was
                never a Pallas kernel).
    window and fullrow at stride > 1 raise in the reference's words
    (:2953-2956). The reference's auto at stride 1 is xla too, from a v5e
    measurement that the port does not carry over (ROADMAP queue C)."""
    if key.strategy not in CONV_STRATEGIES:
        raise ValueError(f"unknown conv strategy {key.strategy!r}: {key}")
    stride1 = (key.stride_h, key.stride_w) == (1, 1)
    if key.strategy == "xla" or (key.strategy == "auto" and not stride1):
        return "xla"
    if not stride1:
        raise NotImplementedError(
            "stride>1 conv runs via strategy='xla' (reference also "
            "restricts conv-to-BRGEMM to stride 1, docs/ConvMapping.md)")
    return "kernel"


@contextlib.contextmanager
def no_tf32_conv():
    """cuDNN convolutions in true f32 inside the block: cuDNN's TF32 flag
    is on by default, unlike matmul's."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def _conv_epilogue(key: ConvNhwcKey, acc, c, d):
    """(N*P*Q, K) f32 sums -> (N, P, Q, K): + C, then D (a channel bias or
    a full (N, P, Q, K) residual) under the binary, then the unary, one
    rounding (tpp_mlir_tpu/xsmm/kernels.py:3019-3032)."""
    K = key.K
    if not key.beta0:
        acc = acc + c.float().reshape(-1, K)
    if key.binary_kind:
        d = d.float().reshape(1, K) if key.binary_bcast == "bcast_col" \
            else d.float().reshape(-1, K)
        acc = BINARY_FNS[key.binary_kind](acc, d)
    if key.unary_kind:
        acc = UNARY_FNS[key.unary_kind](acc)
    return acc.reshape(key.N, key.P, key.Q, K).to(
        DTYPES[key.out_dtype or key.dtype])


def conv_nhwc_reference(key: ConvNhwcKey):
    """B24/B25's function with the TPU kernel's arithmetic (tpp_mlir_tpu/
    xsmm/kernels.py:3006-3017): per tap (r, s), the shifted (N*P*Q, C)
    window of the zero-padded input times W[r, s], products and sums in f32
    from MXU-dtype operands, the taps summed in order; then _conv_epilogue.
    A stride takes every stride-th window row and column. fn(i, w, c=None,
    d=None) with i (N, H, W, C) and w (R, S, C, K)."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    P, Q, sh, sw = key.P, key.Q, key.stride_h, key.stride_w
    pt, pb, pl, pr = key.pad

    def fn(i, w, c=None, d=None):
        x = torch.nn.functional.pad(i.to(mdt), (0, 0, pl, pr, pt, pb))
        w = w.to(mdt)
        acc = None
        for r in range(key.R):
            for s in range(key.S):
                win = x[:, r:r + (P - 1) * sh + 1:sh,
                        s:s + (Q - 1) * sw + 1:sw, :]
                tap = _f32_matmul(win.reshape(-1, key.C), w[r, s])
                acc = tap if acc is None else acc + tap
        return _conv_epilogue(key, acc, c, d)
    return fn


def conv_blocked_nhwc(key: ConvBrgemmKey):
    """B23's function in B24's layout: (the ConvNhwcKey of the same conv,
    ops(i, w, c=None, d=None)), ops giving the NHWC views of the channel-
    blocked operands: I as [N,H,W,Cb*c], W as [R,S,Cb*c,Kb*k], C as
    [N,P,Q,Kb*k] and the bias as [Kb*k]."""
    N, Cb, c, Kb, k = key.N, key.Cb, key.c, key.Kb, key.k
    C, K = Cb * c, Kb * k
    nkey = ConvNhwcKey(
        N=N, H=key.H, W=key.W, C=C, K=K, R=key.R, S=key.S, dtype=key.dtype,
        out_dtype=key.out_dtype, beta0=key.beta0,
        binary_kind=key.binary_kind, binary_bcast=key.binary_bcast,
        unary_kind=key.unary_kind, precision=key.precision)

    def ops(i, w, cacc=None, d=None):
        x = i.permute(0, 2, 3, 1, 4).reshape(N, key.H, key.W, C)
        wt = w.permute(2, 3, 1, 4, 0, 5).reshape(key.R, key.S, C, K)
        if cacc is not None:
            cacc = cacc.permute(0, 2, 3, 1, 4).reshape(N, key.P, key.Q, K)
        return x, wt, cacc, None if d is None else d.reshape(K)
    return nkey, ops


def conv_brgemm_reference(key: ConvBrgemmKey):
    """B23 (tpp_mlir_tpu/xsmm/kernels.py:2778 _build_conv_brgemm) as one
    function: O[N,Kb,P,Q,k] = unary((C) + sum_{Cb,R,S} I[N,Cb,h+r,w+s,c] *
    W[Kb,Cb,R,S,c,k] OP bias[Kb, k]), stride 1, no padding. It is B24's
    function in another layout, so it runs conv_nhwc_reference on the NHWC
    views of the operands (conv_blocked_nhwc): per tap, MXU-dtype operands,
    f32 sums. fn(i, w, c=None, d=None)."""
    check_slice(key)
    nkey, ops = conv_blocked_nhwc(key)
    nhwc = conv_nhwc_reference(nkey)

    def fn(i, w, cacc=None, d=None):
        out = nhwc(*ops(i, w, cacc, d))
        return out.reshape(key.N, key.P, key.Q, key.Kb, key.k) \
            .permute(0, 3, 1, 2, 4).contiguous()
    return fn


def conv_xla_reference(key: ConvNhwcKey):
    """The "xla" route (tpp_mlir_tpu/xsmm/kernels.py:3068): one
    torch.nn.functional.conv2d in f32 of the MXU-dtype operands, TF32 off,
    then _conv_epilogue. No kernel of the port runs here."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    pt, pb, pl, pr = key.pad

    def fn(i, w, c=None, d=None):
        x = torch.nn.functional.pad(i.to(mdt).float(), (0, 0, pl, pr, pt, pb))
        with no_tf32_conv():
            out = torch.nn.functional.conv2d(
                x.permute(0, 3, 1, 2), w.to(mdt).float().permute(3, 2, 0, 1),
                stride=(key.stride_h, key.stride_w))
        return _conv_epilogue(key, out.permute(0, 2, 3, 1).reshape(-1, key.K),
                              c, d)
    return fn


def conv_reference(key: ConvNhwcKey):
    """The plain version of whatever conv_route picks for `key`."""
    return conv_xla_reference(key) if conv_route(key) == "xla" \
        else conv_nhwc_reference(key)


UNARY_OPS = ("transpose", "relu", "vnni2")


def unary_reference(key: UnaryKey):
    """xsmm.unary's transpose, relu and vnni2: the reference's kernels are
    jnp (tpp_mlir_tpu/xsmm/kernels.py:3315-3335), so the port's are these
    PyTorch ops and no CUDA kernel. relu computes in f32 and rounds once;
    vnni2 is [..., K, N] -> [..., K/v, N, v]. The other unary kinds stand
    alone only where a pass the port has not copied leaves them (queue
    A3)."""
    if key.kind not in UNARY_OPS:
        raise _refuse(f"xsmm.unary {key.kind!r}", "A3", key)
    for dt in (key.dtype, key.out_dtype or key.dtype):
        if dt not in DTYPES:
            raise _refuse(f"dtype {dt!r}", "A14 (f16 keys)", key)
    out_dt = DTYPES[key.out_dtype or key.dtype]
    if key.kind == "relu":
        return lambda x: torch.relu(x.float()).to(out_dt)
    if key.kind == "vnni2":
        *lead, K, N = key.shape
        vf = key.vnni
        return lambda x: x.reshape(*lead, K // vf, vf, N).movedim(-2, -1) \
            .contiguous()
    perm = key.perm or tuple(reversed(range(len(key.shape))))
    return lambda x: x.permute(*perm).contiguous().to(out_dt)


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


def grouped_gemm_reference(key: GroupedGemmKey):
    """B16's function, per row block (tpp_mlir_tpu/xsmm/reference.py:181):
    O[i*bm:(i+1)*bm] = unary(A[i*bm:(i+1)*bm] @ B[ge[i]]), operands in the
    MXU dtype, products and sums in f32, the epilogue in f32 (`gelu` is the
    exp2-domain gelu_exp2, as the JAX epilogue table maps it), one rounding
    to the output dtype. fn(ge, a, b), or fn(li, ge, a, b) for a stacked
    (layers, G, ., .) table with li an int or an integer tensor."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]
    nb = key.m // key.bm

    def body(ge, a, b):
        blocks = a.to(mdt).reshape(nb, key.bm, key.k)
        w = b.to(mdt)[ge.long()]                      # (nb, k|n, n|k)
        if key.transpose_b:
            w = w.transpose(-1, -2)
        acc = _f32_matmul(blocks, w)
        if key.unary_kind:
            acc = UNARY_FNS[key.unary_kind](acc)
        return acc.reshape(key.m, key.n).to(out_dt)

    if key.layers:
        return lambda li, ge, a, b: body(ge, a, b[int(li)])
    return body


def grouped_wgrad_reference(key: GroupedWgradKey):
    """B17's function (tpp_mlir_tpu/xsmm/reference.py:206): dW[g] =
    sum_{i: ge[i] == g} xt[:, blk i] @ dy[blk i], f32 (G, k, n): each
    block's product in f32 from MXU-dtype operands, then the per-group sum
    as a one-hot product, so a group that owns no block is exactly zero.
    fn(ge, xt, dy) with xt (k, m) of any strides (the transpose of an
    (m, k) tensor is taken as it is) and dy (m, n)."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    nb = key.m // key.bm

    def fn(ge, xt, dy):
        xb = xt.to(mdt).reshape(key.k, nb, key.bm).permute(1, 0, 2)
        yb = dy.to(mdt).reshape(nb, key.bm, key.n)
        db = _f32_matmul(xb, yb)                      # (nb, k, n)
        oh = (ge.long()[:, None] == torch.arange(
            key.n_groups, device=ge.device)).float()  # (nb, G)
        return torch.einsum("ig,ikn->gkn", oh, db)
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
               BatchMatmulKey: batch_matmul_reference,
               FlashMhaKey: mha_reference,
               LayerNormKey: layer_norm_reference,
               DecodeAttnKey: decode_attn_reference,
               Int8GemmKey: int8_gemm_reference,
               FlashTrainKey: flash_train_fwd_reference,
               FlashTrainBwdKey: flash_train_bwd_reference,
               GroupedGemmKey: grouped_gemm_reference,
               GroupedWgradKey: grouped_wgrad_reference,
               ConvNhwcKey: conv_reference,
               BlockedMatmulKey: blocked_matmul_reference,
               ConvBrgemmKey: conv_brgemm_reference}


def reference_kernel(key):
    """The plain version for any key of the slice."""
    check_slice(key)   # raises for keys outside it, naming the ROADMAP item
    return _REFERENCES[type(key)](key)
