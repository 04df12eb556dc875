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
  * f16 (every kernel: the GEMM family, B1, B3-B5, B19, B20 and the
    xsmm.unary/binary ops; the transformer family, B2's LayerNorm prologue
    and ln_stats pair, B12 and attention, B6-B11; the MHA suite's batched
    matmul, B21/B22; the conv family, B23-B25; the grouped GEMMs, B16/B17;
    B15's f16 output; decode attention, B13; the training attention,
    B14/B18): as bf16, with f16 operands and f16 products at either
    precision (B15: s8 products, an f16 output); every rounding the bf16
    kernels make to bf16 (a chain's layers, the LayerNorm prologue's rows,
    attention's scaled Q and P, a softmax_lhs P) is a rounding to f16,
    except B14/B18's, which round P and dS to bf16 and store bf16 O, dQ,
    dK and dV, as the JAX package's f16 keys do (flash_train_pv_dtype).
    The products are f16 x f16 (exact in f32): never an f16 torch.matmul,
    whose cuBLAS reduction may run in reduced precision.
Normalizations (LayerNorm, the GEMM's LayerNorm prologue, softmax) compute
in f32 whatever the dtype; only their results are rounded.

Output types: every key with an `out_dtype` writes f32, bf16 or f16
whatever its products' type, and reads C, D, biases and gamma/beta in the
type they are stored in (widened to f32). The rounding follows the JAX
bodies' casts: B1/B2, B3, B6-B10, B7, B12, B16, B19, B21/B22 and B23-B25
store one rounding of the f32 value to `out_dtype`, never a rounding
through the products' type first (a bf16 output of f16 products keeps
values above f16's 65,504); B4, B5, B20 and B11 hold their state in the
products' type between repeats and cast that state to `out_dtype`
(tpp_mlir_tpu/xsmm/kernels.py:2053-2061, :1969-1974, :933, :2172-2176).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .flags import (BatchMatmulKey, BinaryKey, BlockedMatmulKey, BrgemmKey,
                    ChainKey, ConvBrgemmKey, ConvNhwcKey, DecodeAttnKey,
                    FlashMhaKey, FlashTrainBwdKey, FlashTrainKey,
                    GroupedGemmKey, GroupedWgradKey, Int8GemmKey,
                    LayerNormKey, UnaryKey)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}
# the 16-bit product types of the wgmma kernels (f32 "default" takes bf16)
MMA16 = (torch.bfloat16, torch.float16)

# the reference's words for a strided channel-blocked conv
# (tpp_mlir_tpu/xsmm/kernels.py:2785-2788)
CONV_BLOCKED_STRIDE = (
    "stride>1 conv stays on the XLA conv path (reference also restricts "
    "conv-to-BRGEMM to stride 1, docs/ConvMapping.md)")


def check_slice(key) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for any key or
    option this slice does not port."""
    if not isinstance(key, (BrgemmKey, BatchMatmulKey, ChainKey, FlashMhaKey,
                            LayerNormKey, DecodeAttnKey, Int8GemmKey,
                            FlashTrainKey, GroupedGemmKey, GroupedWgradKey,
                            ConvNhwcKey, BlockedMatmulKey, ConvBrgemmKey,
                            UnaryKey, BinaryKey)):
        raise NotImplementedError(f"{type(key).__name__} is outside the "
                                  f"port's slice: ROADMAP queue A")
    if isinstance(key, DecodeAttnKey):
        _check_decode_attn(key)
        return
    if isinstance(key, FlashTrainKey):
        if key.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {key.dtype!r}: {key}")
        return
    if isinstance(key, Int8GemmKey):
        if key.out_dtype not in DTYPES:
            raise ValueError(f"unknown dtype {key.out_dtype!r}: {key}")
        if key.unary_kind not in (None, *UNARY_FNS):
            raise ValueError(f"unknown unary {key.unary_kind!r}")
        return
    out_dt = "f32" if isinstance(key, GroupedWgradKey) else key.out_dtype
    for dt in (key.dtype, out_dt or key.dtype):
        if dt not in DTYPES:
            raise ValueError(f"unknown dtype {dt!r}: {key}")
    if isinstance(key, UnaryKey):
        if key.kind not in (*UNARY_OPS, *UNARY_FNS):
            raise ValueError(f"unknown unary kind {key.kind!r}")
        return
    if isinstance(key, BinaryKey):
        if key.kind not in BINARY_FNS:
            raise ValueError(f"unknown binary kind {key.kind!r}")
        return
    if key.precision not in ("default", "highest"):
        raise ValueError(f"unknown precision {key.precision!r}")
    if isinstance(key, (GroupedGemmKey, GroupedWgradKey)):
        if key.bm < 1 or key.m % key.bm:
            raise ValueError(f"m must be a multiple of bm: {key}")
        if isinstance(key, GroupedGemmKey) and \
                key.unary_kind not in (None, *UNARY_FNS):
            raise ValueError(f"unknown unary {key.unary_kind!r}")
    elif isinstance(key, BrgemmKey):
        if key.prologue not in (None, "layer_norm", "ln_stats"):
            raise ValueError(f"unknown prologue {key.prologue!r}")
        if (key.prologue == "ln_stats" or key.ln_stats_out) and (
                key.batch != 1 or key.vnni or key.transpose_b):
            # the TPU builds the pair only as its weights-resident kernel
            # (kernels.py:258-259, :596-601 there); its VMEM fit is a TPU
            # limit and is not carried over (ROADMAP queue C)
            raise ValueError(f"the ln_stats form needs the weights-resident "
                             f"shape (batch 1, flat, no transpose_b): {key}")
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
    """The dtype the products see (see the module docstring): bf16 for f32
    at "default", else the key's own (f16 at either precision)."""
    if dtype == "f32" and precision == "default":
        return torch.bfloat16
    return DTYPES[dtype]


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain version needs true f32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    return torch.matmul(a.float(), b.float())


def contraction(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A named contraction's product in f32, TF32 off: "matmul" A @ B,
    "matmul_tb" A @ B^T, "brgemm" sum_b A[b] @ B[b], "batch_matmul"
    A[b] @ B[b]. The executor's tl oracles and tl.generic's evaluator
    (`ir/affine.py eval_generic`) share it, so a generic and its named form
    give the same bits."""
    if kind == "matmul_tb":
        b = b.transpose(-1, -2)
    out = _f32_matmul(a, b)
    return out.sum(0) if kind == "brgemm" else out


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


def ln_stats_prologue(key: BrgemmKey, a, mu, var, gamma=None, beta=None):
    """The consumer's ln_stats prologue on A (1, m, k), in f32: A's rows
    normalized with a producer's per-row (m, 1) mean and variance, then
    gamma/beta (tpp_mlir_tpu/xsmm/kernels.py:563-572)."""
    af = (a.float() - mu.float().reshape(-1, 1)) * torch.rsqrt(
        var.float().reshape(-1, 1) + key.prologue_eps)
    if key.prologue_affine:
        af = af * gamma.float().reshape(-1) + beta.float().reshape(-1)
    return af


def ln_stats_out(y):
    """The producer's per-row statistics of its stored output y (m, n):
    (mean, one-pass variance s2/n - mean^2), each (m, 1) f32
    (tpp_mlir_tpu/xsmm/kernels.py:456-467)."""
    rf = y.float()
    n = rf.shape[-1]
    mu = rf.sum(-1, keepdim=True) / n
    return mu, (rf * rf).sum(-1, keepdim=True) / n - mu * mu


def brgemm_reference(key: BrgemmKey):
    """C (+)= sum_b A'[b] @ B[b], then unary(acc OP D), as one function;
    A' is A, or A through the LayerNorm prologue (gamma/beta trail) or the
    ln_stats prologue (gamma/beta, then the producer's mu/var). With
    ln_stats_out it returns (out, mean, var) of the output rows."""
    check_slice(key)
    mdt = mxu_dtype(key.dtype, key.precision)
    out_dt = DTYPES[key.out_dtype or key.dtype]

    def fn(a, b, c=None, d=None, gamma=None, beta=None, mu=None, var=None):
        if key.prologue == "ln_stats":
            a = ln_stats_prologue(key, a, mu, var, gamma, beta)
        elif key.prologue:
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
        out = acc.to(out_dt)
        return (out, *ln_stats_out(out)) if key.ln_stats_out else out
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
    # the reference's gate (tpp_mlir_tpu/xsmm/kernels.py:1674-1681): an f16
    # key fails it and reaches the refusal below
    if key.strategy == "flash_heads" and not key.repeats and key.causal \
            and S == Skv and key.dtype in ("f32", "bf16") \
            and key.precision == "default":
        return "flash_heads"
    if key.strategy == "xla" and not key.repeats:
        return "xla"
    raise NotImplementedError(
        f"strategy {key.strategy!r} on the token layout: the reference runs "
        f"another kernel here without a word (ADVICE.md #2): {key}")


def tma_aligned(itemsize: int, *elements: int) -> bool:
    """Whether TMA can take these row strides and column offsets (in
    elements of `itemsize` bytes): each a multiple of 16 bytes."""
    return all(e * itemsize % 16 == 0 for e in elements)


def attention_loader(key: FlashMhaKey) -> str:
    """Which loader csrc/attention.cu runs a "kernel" or "bench" route key
    with, from the key alone:
      "fma"      MXU dtype f32 (f32 "highest"): the f32-FMA kernel;
      "tma"      bf16 or f16 operands whose row stride (E, 3E packed, D
                 flat) and column offsets (each head's h*D, the packed
                 groups' E and 2E) TMA can take: TMA fills the K/V ring of
                 the wgmma kernel, whose products are the operands' own type
                 (wgmma .bf16 or .f16);
      "convert"  f32 operands at "default" (bf16 products), and bf16
                 operands TMA cannot take: the wgmma kernel's producer
                 warpgroup loads K/V through registers, f32 rounded to
                 bf16, bf16 stored as it is.
    f16 operands have the TMA loader only: at every head_dim attention.cu
    instantiates (32, 64, 128) each stride and column offset is a multiple
    of 16 bytes, so an f16 key TMA cannot take is refused (ValueError).
    The operands' base pointers must be 16-byte aligned too; the wrapper
    checks them (every torch allocation is)."""
    if mxu_dtype(key.dtype, key.precision) == torch.float32:
        return "fma"
    if key.dtype == "f32":
        return "convert"
    E = (key.heads or 1) * key.head_dim
    ld = 3 * E if key.qkv_packed else E
    if tma_aligned(2, ld, E, key.head_dim):
        return "tma"
    if key.dtype == "bf16":
        return "convert"
    raise ValueError(f"attention.cu has no register loader for f16 "
                     f"operands, and TMA cannot take these strides (no "
                     f"head_dim it instantiates makes them): {key}")


def brgemm_route(key: BrgemmKey) -> str:
    """Which loader runs B1/B2 at `key` (csrc/brgemm.cu on the pipelined
    mainloop of csrc/gemm_sm90.cuh), from the key alone:
      "fma"      MXU dtype f32 (f32 "highest"): brgemm.cu's f32-FMA body,
                 no TF32;
      "tma"      bf16 or f16 operands whose row strides TMA can take (A's
                 k and, unless transpose_b, B's n: 16-byte multiples): one
                 producer thread fills the ring by TMA, the products in the
                 operands' own type (wgmma .bf16 or .f16);
      "convert"  f32 operands at "default" (bf16 products, f32 sums) and
                 16-bit operands TMA cannot take: the producer warpgroup
                 loads through registers and stores the swizzled layout TMA
                 would, so the consumers run one code: f32 is rounded to
                 bf16, bf16 passes through f32 unchanged, f16 is copied as
                 raw 16-bit units (no rounding at all).
    A VNNI B is un-VNNI'd by the wrapper first (as _unvnni does), so it
    takes the flat B's route. The "tma" route also needs 16-byte aligned
    base pointers; the wrapper checks them (every torch allocation is).
    The tile and the k split are gemm_plan's: forced by the key or the
    tuning table (xsmm/tune.py), else the launcher's heuristic on the card
    (tpp_gemm_plan; gemm_heuristic is its mirror)."""
    if mxu_dtype(key.dtype, key.precision) == torch.float32:
        return "fma"
    strides = (key.k,) if key.transpose_b else (key.k, key.n)
    if DTYPES[key.dtype] in MMA16 and tma_aligned(2, *strides):
        return "tma"
    return "convert"


def blocked_matmul_route(key: BlockedMatmulKey) -> str:
    """Which kernel runs a BlockedMatmulKey, from the key alone:
      "warm"     repeats > 0: B20's panel kernel in csrc/blocked_matmul.cu;
      and B19 on the loaders of brgemm_route's table:
      "fma"      f32 "highest": the f32-FMA body (VNNI read in place);
      "tma"      bf16 or f16, not VNNI, kb and nb 16-byte multiples: 4D
                 tensor maps over the packed A and B;
      "convert"  f32 "default", any VNNI B (VNNI2 pairs two k of one n in 4
                 bytes, no wgmma layout, so it is re-laid in registers on
                 the way in, in place: no un-VNNI pass; f16 as raw 16-bit
                 halves, bf16 through f32 unchanged), and strides TMA
                 cannot take."""
    if key.repeats:
        return "warm"
    if mxu_dtype(key.dtype, key.precision) == torch.float32:
        return "fma"
    if DTYPES[key.dtype] in MMA16 and not key.vnni and \
            tma_aligned(2, key.kb, key.nb):
        return "tma"
    return "convert"


H100_SMS = 132   # the plans below are pinned to the H100's SM count

# csrc/gemm_sm90.cuh's launch plans: the output tiles its mainloop is
# instantiated at (rows, columns), and the depth of one k stage; the f32-FMA
# bodies of f32 "highest" (brgemm.cu, blocked_matmul.cu) have one 64 x 64
# tile and no split
GEMM_TILES = ((128, 128), (64, 128), (64, 64))
FMA_TILES = ((64, 64),)
GEMM_STAGE_K = 64


class GemmPlan(NamedTuple):
    """A launch plan of csrc/gemm_sm90.cuh's mainloop: the output tile
    (bm rows x bn columns) and the k split (1: none)."""

    bm: int
    bn: int
    split: int


def gemm_problem(key: BrgemmKey | BlockedMatmulKey) -> tuple:
    """A B1/B2 or B19 key as the launcher sees it: (Mb, Nb, Kb, mb, nb, kb,
    fma, no_split). A brgemm is the packed problem with Mb = Nb = 1 and the
    batch as Kb; fma is the f32-FMA body (64 x 64, no split); no_split is
    ln_stats_out, whose row statistics come from the tile epilogue."""
    if isinstance(key, BrgemmKey):
        return (1, 1, key.batch, key.m, key.n, key.k,
                brgemm_route(key) == "fma", key.ln_stats_out)
    return (key.Mb, key.Nb, key.Kb, key.mb, key.nb, key.kb,
            blocked_matmul_route(key) == "fma", False)


def gemm_stages(key: BrgemmKey | BlockedMatmulKey) -> int:
    """The key's 64-deep k stages: the most slices a split can make."""
    _, _, Kb, _, _, kb, _, _ = gemm_problem(key)
    return Kb * -(-kb // GEMM_STAGE_K)


def gemm_heuristic(key: BrgemmKey | BlockedMatmulKey,
                   sms: int = H100_SMS) -> GemmPlan:
    """The launcher's own plan (gemm_sm90.cuh gemm_plan, brgemm.cu
    brgemm_plan) on a card of `sms` SMs: the largest tile of 128 x 128,
    64 x 128, 64 x 64 whose grid fills half a wave; under that 64 x 64 and
    k split into as many slices as fill the wave, each at least four
    stages; 64 x 64 unsplit for the FMA body and ln_stats_out."""
    Mb, Nb, Kb, mb, nb, kb, fma, no_split = gemm_problem(key)
    if fma:
        return GemmPlan(64, 64, 1)

    def tiles(bm, bn):
        return Mb * -(-mb // bm) * Nb * -(-nb // bn)
    for bm, bn in GEMM_TILES:
        if 2 * tiles(bm, bn) >= sms:
            return GemmPlan(bm, bn, 1)
    if no_split:
        return GemmPlan(64, 64, 1)
    kt = Kb * -(-kb // GEMM_STAGE_K)
    return GemmPlan(64, 64, max(1, min(sms // tiles(64, 64), kt // 4)))


def bk_split(key: BrgemmKey | BlockedMatmulKey, bk: int) -> int:
    """The k split a slice depth `bk` makes: ceil(K / bk) over the whole
    reduction K (batch x k, or Kb x kb); bk >= K is no split. bk must be
    a multiple of the mainloop's 64-deep stage."""
    if bk <= 0 or bk % GEMM_STAGE_K:
        raise ValueError(f"bk {bk} must be a positive multiple of the "
                         f"mainloop's {GEMM_STAGE_K}-deep k stage: {key}")
    _, _, Kb, _, _, kb, _, _ = gemm_problem(key)
    return -(-(Kb * kb) // bk)


def plan_request(key: BrgemmKey | BlockedMatmulKey) -> tuple[int, int, int]:
    """The forced (bm, bn, split) of a B1/B2 or B19 key, zeros where the
    heuristic decides: the key's own bm/bn/bk (a BrgemmKey's; tpp-run's
    --register-blocking), else the tuning table's cfg {"bm", "bn",
    "split"} (an entry with a `cluster` is B20's and is skipped), else
    (0, 0, 0)."""
    from . import tune
    if isinstance(key, BrgemmKey) and (key.bm or key.bn or key.bk):
        return key.bm, key.bn, bk_split(key, key.bk) if key.bk else 0
    cfg = tune.tuned(key)
    if "cluster" in cfg:
        return 0, 0, 0
    return cfg.get("bm", 0), cfg.get("bn", 0), cfg.get("split", 0)


def gemm_plan(key: BrgemmKey | BlockedMatmulKey, force=None,
              sms: int = H100_SMS) -> GemmPlan:
    """The plan a B1/B2 or B19 launch runs on a card of `sms` SMs: the
    forced (bm, bn, split) (plan_request's by default; zeros take the
    heuristic's: its tile, and its split where the tile is its own, else
    no split), checked by check_gemm_plan. The Python mirror of
    brgemm.cu's resolve_plan, which the launch checks again."""
    bm, bn, split = plan_request(key) if force is None else force
    h = gemm_heuristic(key, sms)
    if (bm, bn) == (0, 0):
        bm, bn = h.bm, h.bn
    if split == 0:
        split = h.split if (bm, bn) == (h.bm, h.bn) else 1
    plan = GemmPlan(bm, bn, split)
    check_gemm_plan(key, plan)
    return plan


def legal_gemm_plans(key: BrgemmKey | BlockedMatmulKey) -> tuple:
    """(tiles, most splits) a key may force: FMA_TILES and 1 on the
    f32-FMA body, GEMM_TILES otherwise; no split under ln_stats_out."""
    _, _, _, _, _, _, fma, no_split = gemm_problem(key)
    return (FMA_TILES if fma else GEMM_TILES,
            1 if fma or no_split else gemm_stages(key))


def check_gemm_plan(key: BrgemmKey | BlockedMatmulKey, plan) -> None:
    """Raise ValueError, naming the legal set, for a plan the mainloop does
    not run at `key` (the rule brgemm.cu's plan_legal applies on the card)."""
    bm, bn, split = plan
    tiles, most = legal_gemm_plans(key)
    if (bm, bn) not in tiles or not 1 <= split <= most:
        legal = ", ".join(f"{a}x{b}" for a, b in tiles)
        raise ValueError(
            f"illegal GEMM plan {bm}x{bn} split {split} for {key}: the tile "
            f"is one of {legal} and the split 1..{most}"
            + (" (the f32-FMA body: 64 x 64, no split)"
               if tiles == FMA_TILES else
               " (ln_stats_out: no split)" if most == 1 else
               f" (the key's {GEMM_STAGE_K}-deep k stages)"))


SM90_SMEM_OPTIN = 232448    # shared memory one block may opt into on sm_90

# csrc/warm_panel.cuh: a tile's columns (and a weight slice's depth), the
# bytes of a 64 x 64 bf16 slice, the streamed ring's stages, the weights
# that can stream (one tensor map each), the panel heights
WARM_TILE, WARM_SLICE, WARM_STAGES, WARM_MAPS = 64, 8192, 8, 8
# the panel chunks a block's barriers cover (K up to 2560) and the
# barriers: the ring's full and empty, each chunk's, the panel's `freed`
WARM_MAXKT = 40
WARM_BARRIERS = 2 * WARM_STAGES + WARM_MAXKT + 1
WARM_ROWS = (16, 24, 32, 40, 64)
# cudaOccupancyMaxActiveClusters for the engine at one block an SM (above
# ~114 KB of shared memory), by cluster size, as an NVIDIA H100 80GB HBM3
# answered it (scripts/exp_warm_plan.py; chip_smoke.py prints the card's)
H100_WARM_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                      8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7,
                      15: 7, 16: 7}


class WarmPlan(NamedTuple):
    """A launch plan of csrc/warm_panel.cuh: the panel's rows (wgmma's N),
    the cluster's blocks, the most 64-column tiles a block owns at each step
    of a period, whether the weights stay resident (else they stream
    through the TMA ring), the dynamic shared memory a block asks for, and
    the clusters of the grid (one a row panel)."""

    rows: int
    cluster: int
    tiles: tuple
    resident: bool
    smem: int
    clusters: int


def warm_steps(key: ChainKey | BlockedMatmulKey):
    """One period of the warm-panel engine's GEMM steps at `key`, as
    ((K, N, fwd), ...), with its row groups and their rows: a chain's
    layers; B5's forward (k -> n) and backward (n -> k, W^T) steps; B20's
    one step, its groups the Mb tiles."""
    if isinstance(key, BlockedMatmulKey):
        K = key.Kb * key.kb
        return ((K, key.Nb * key.nb, True),), key.Mb, key.mb
    d = key.dims
    if key.pingpong and key.repeats > 1:
        return ((d[0], d[1], True), (d[1], d[0], False)), 1, key.m
    return tuple((k, n, True) for k, n in zip(d[:-1], d[1:])), 1, key.m


def warm_smem_bytes(rows: int, cluster: int, steps, resident: bool) -> int:
    """csrc/warm_panel.cuh layout()'s bytes: the panel (the widest K's
    64-column chunks of `rows` rows), two staging buffers (the most tiles a
    block owns at a step), the weights (every owned 64 x 64 slice, or the
    ring), the barriers and 1024 bytes of alignment."""
    kt = [-(-K // WARM_TILE) for K, _, _ in steps]
    tiles = [-(-(-(-N // WARM_TILE)) // cluster) for _, N, _ in steps]
    weights = sum(t * k for t, k in zip(tiles, kt)) if resident \
        else WARM_STAGES
    return (max(kt) + 2 * max(tiles)) * rows * 128 + weights * WARM_SLICE \
        + WARM_BARRIERS * 8 + 1024


def warm_plan(key: ChainKey | BlockedMatmulKey, clusters=None,
              rows: int | None = None, cluster: int | None = None,
              resident: bool | None = None) -> WarmPlan | None:
    """The warm-panel engine's plan at `key` (B3/B4/B5 chains, B20), or None
    where the engine does not take it (f32 products, or a plan that does
    not fit a block's shared memory). bf16 and f16 products plan alike: a
    slice, a panel row and a weight are 2 bytes an element in either. `clusters` maps a cluster
    size to the clusters the card holds at once (the card's
    cudaOccupancyMaxActiveClusters at one block an SM; default the H100's).
    The cluster C: at most 16, and the fewest blocks that keep the most
    tiles a block owns at each step (B5 768 <-> 2304: 12, three tiles
    forward, one backward). The panel: the fewest rows (WARM_ROWS, wgmma
    N values) whose row panels all fit in one wave of clusters, else the
    fewest waves (256 rows in clusters of 16, of which the H100 holds 7:
    40 rows, 7 panels).
    The weights: resident if a block's slices fit beside the panel, else
    streamed (a chain's flat 16-bit weights only, at most WARM_MAPS of
    them). rows, cluster and resident force a choice (for experiments)."""
    if mxu_dtype(key.dtype, key.precision) not in MMA16:
        return None
    steps, groups, m = warm_steps(key)
    nts = [-(-N // WARM_TILE) for _, N, _ in steps]
    if max(max(nts), *(-(-K // WARM_TILE) for K, _, _ in steps)) > \
            WARM_MAXKT:
        return None
    if cluster is None:
        c0 = min(16, max(nts))
        cluster = min(c for c in range(1, c0 + 1)
                      if all(-(-n // c) == -(-n // c0) for n in nts))
    table = clusters or H100_WARM_CLUSTERS
    stream_ok = isinstance(key, ChainKey) and len(steps) <= WARM_MAPS

    def panels(p):
        return groups * -(-m // p)

    order = (rows,) if rows else sorted(
        WARM_ROWS, key=lambda p: (-(-panels(p) // table[cluster]), p))
    for p in order:
        for res in (True, False) if resident is None else (resident,):
            if not res and not stream_ok:
                continue
            smem = warm_smem_bytes(p, cluster, steps, res)
            if smem <= SM90_SMEM_OPTIN:
                return WarmPlan(p, cluster,
                                tuple(-(-n // cluster) for n in nts), res,
                                smem, panels(p))
    return None


WARM_MAX_CLUSTER = 16   # blocks a cluster may hold (non-portable above 8)


def warm_request(key: ChainKey | BlockedMatmulKey) -> tuple[int, int]:
    """The forced (rows, cluster) of the warm-panel engine at a ChainKey
    (B3/B4/B5) or B20 key, zeros where the heuristic decides: a ChainKey's
    bm (the panel rows), else the tuning table's {"bm", "cluster"} (for a
    BlockedMatmulKey only an entry with a cluster: one without is B19's
    tile, the two sharing a tag)."""
    from . import tune
    if isinstance(key, ChainKey) and key.bm:
        return key.bm, 0
    cfg = tune.tuned(key)
    if isinstance(key, BlockedMatmulKey) and "cluster" not in cfg:
        return 0, 0
    return cfg.get("bm", 0), cfg.get("cluster", 0)


def requested_warm_plan(key: ChainKey | BlockedMatmulKey, clusters=None,
                        request=None) -> WarmPlan | None:
    """warm_plan at the forced (rows, cluster) (warm_request's by default):
    the heuristic's plan where nothing is forced; a forced plan the engine
    cannot take (rows not in WARM_ROWS, a cluster outside
    1..WARM_MAX_CLUSTER, shared memory over SM90_SMEM_OPTIN, a width over
    WARM_MAXKT tiles, f32 products) raises ValueError."""
    rows, cluster = warm_request(key) if request is None else request
    if not rows and not cluster:
        return warm_plan(key, clusters)
    if rows and rows not in WARM_ROWS:
        raise ValueError(f"panel rows {rows} for {key}: the warm-panel "
                         f"engine takes rows in {WARM_ROWS}")
    if cluster and not 1 <= cluster <= WARM_MAX_CLUSTER:
        raise ValueError(f"cluster {cluster} for {key}: the warm-panel "
                         f"engine takes 1..{WARM_MAX_CLUSTER} blocks")
    plan = warm_plan(key, clusters, rows=rows or None,
                     cluster=cluster or None)
    if plan is None:
        raise ValueError(f"the warm-panel engine cannot place rows {rows} "
                         f"cluster {cluster} at {key}: 16-bit products, "
                         f"at most {WARM_MAXKT} 64-column tiles a width and "
                         f"{SM90_SMEM_OPTIN} bytes of shared memory a "
                         f"block")
    return plan


def chain_route(key: ChainKey) -> str:
    """Which body of csrc/chain.cu runs a chain (B3, B4, B5), from the key
    alone:
      "panel"  16-bit products (bf16 and f32 "default": bf16; f16: f16)
               where warm_plan has a plan: the warm-panel engine
               (csrc/warm_panel.cuh), its wgmma in the products' type;
      "fma"    f32 "highest": the first design's f32-FMA body;
      "wmma"   16-bit products warm_plan cannot place (more streamed layers
               than WARM_MAPS whose weights do not fit resident): the first
               design's WMMA body, its fragments in the products' type.
    chain_fits_smem gates every key as before; the route only picks the
    body."""
    if mxu_dtype(key.dtype, key.precision) == torch.float32:
        return "fma"
    return "panel" if warm_plan(key) else "wmma"


def warm_route(key: BlockedMatmulKey) -> str:
    """Which body of csrc/blocked_matmul.cu runs B20 (repeats > 0), from the
    key alone: "panel" (the warm-panel engine, its weight resident) where
    warm_plan has a plan, "fma" at f32 "highest", else "wmma" (the first
    design's 16-row panel); the 16-bit bodies run in the products' type
    (bf16, or f16 for an f16 key). blocked_warm_fits_smem gates every key as
    before."""
    if mxu_dtype(key.dtype, key.precision) == torch.float32:
        return "fma"
    return "panel" if warm_plan(key) else "wmma"


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


BMM_MULTI_MAX = 64     # m, n and k of batch_matmul.cu's multi route


def batch_matmul_route(key: BatchMatmulKey) -> str:
    """Which of csrc/batch_matmul.cu's kernels runs B21/B22 at `key`:
      "multi"  16-bit products (bf16 for bf16 keys and f32 "default", f16
               for f16 keys), m, n and k at most 64 (a whole problem fits
               one warp's registers and its staging), k and n multiples of
               8 (rows of 16-byte copies): one warp per problem, cp.async
               staging, mma.sync (.bf16 or .f16). Every MHA suite key:
               mha_qk 1024x32x32x64, mha_softmax_v 1024x32x64x32.
      "tiled"  everything else (f32 "highest", larger problems): 64x64
               block tiles (WMMA in the products' 16-bit type, or f32
               FMA), `group` problems a block in turn."""
    small = max(key.m, key.n, key.k) <= BMM_MULTI_MAX and \
        key.k % 8 == 0 and key.n % 8 == 0
    mma16 = mxu_dtype(key.dtype, key.precision) in MMA16
    return "multi" if small and mma16 else "tiled"


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




def conv_kernel_route(key: ConvNhwcKey | ConvBrgemmKey) -> str:
    """Which body of csrc/conv.cu runs a conv key, from the key alone (c
    and k are the channel counts C and K, or a channel-blocked key's block
    sizes):
      "xla"      a ConvNhwcKey that conv_route sends to F.conv2d: no kernel;
      "fma"      MXU dtype f32 (f32 "highest"): the tile body's f32 FMA, no
                 TF32;
      "tma"      bf16 or f16 operands with c and k multiples of 8 (16-byte
                 channel runs): the wgmma implicit GEMM on
                 csrc/gemm_sm90.cuh's consumer loop in the operands' type,
                 A by 16-byte cp.async with a zero fill for padding, W by
                 TMA;
      "convert"  f32 operands at "default" (bf16 products, f32 sums) with c
                 and k multiples of 4: the same kernel, A and W by cp.async
                 into raw f32 stages that the producer rounds to bf16 (never
                 an f16 key: its stages would round to bf16);
      "wmma"     16-bit products at any other channel count: the tile
                 body's WMMA (bf16, or f16 for f16 keys), staged through
                 shared memory with no pipelining.
    The tile and k split of the wgmma routes are conv_plan's. The base
    pointers of I and W must be 16-byte aligned there too; the wrapper
    checks them (every torch allocation is)."""
    if isinstance(key, ConvNhwcKey):
        if conv_route(key) == "xla":
            return "xla"
        c, k = key.C, key.K
    else:
        c, k = key.c, key.k
    if mxu_dtype(key.dtype, key.precision) == torch.float32:
        return "fma"
    if key.dtype in ("bf16", "f16"):
        return "tma" if c % 8 == 0 and k % 8 == 0 else "wmma"
    return "convert" if c % 4 == 0 and k % 4 == 0 else "wmma"


def conv_gemm_shape(key: ConvNhwcKey | ConvBrgemmKey) -> tuple:
    """The packed GEMM csrc/conv.cu's wgmma kernel runs for a key: (Mb, Nb,
    KT, mb, nb). Rows are output pixels: one block of N P Q (Mb 1), or per
    image (Mb N, mb P Q) where Kb > 1, so that a row tile stays inside one
    [N, Kb, P, Q, k] output block; Nb = Kb blocks of nb = k columns; KT is
    the reduction's 64-channel slices, Cb R S ceil(c / 64)."""
    if isinstance(key, ConvBrgemmKey):
        Cb, c, Kb, k = key.Cb, key.c, key.Kb, key.k
    else:
        Cb, c, Kb, k = 1, key.C, 1, key.K
    pq = key.P * key.Q
    KT = Cb * key.R * key.S * -(-c // 64)
    if Kb > 1:
        return key.N, Kb, KT, pq, k
    return 1, 1, KT, key.N * pq, k


def conv_plan(key: ConvNhwcKey | ConvBrgemmKey) -> tuple[int, int, int]:
    """(tile rows, tile columns, k split) of the wgmma routes on
    conv_gemm_shape's GEMM at the H100's 132 SMs. The conv re-reads its
    operand tiles from L2 (each A row 9 times, W by every row tile), so
    larger tiles win while the grid stays in one wave of resident blocks:
    "convert" (its f32 staging ring: one block an SM) takes the first of
    128 x 128, 64 x 128, 64 x 64 whose tiles fill a third of the 132
    slots, "tma" (two blocks an SM) the first of 64 x 128, 64 x 64 that
    fill a third of 264; then k is split into as many slices as the slots
    hold, each at least eight 64-deep stages. The partials are summed in
    slice order (bit-repeatable). Chosen from a sweep on the H100 at the
    conv suite's c128/30 and c256/16 keys (scripts/exp_conv_plan.py). An
    f16 key takes its bf16 twin's plan: the same route, tiles and bytes."""
    Mb, Nb, KT, mb, nb = conv_gemm_shape(key)
    if conv_kernel_route(key) == "tma":
        tiles, slots = ((64, 128), (64, 64)), 2 * H100_SMS
    else:
        tiles, slots = ((128, 128), (64, 128), (64, 64)), H100_SMS
    for bm, bn in tiles:
        t = Mb * -(-mb // bm) * Nb * -(-nb // bn)
        if 3 * t >= slots:
            break
    return bm, bn, max(1, min(slots // t, KT // 8))


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


UNARY_OPS = ("transpose", "vnni2", "vnni")   # data movement


def unary_reference(key: UnaryKey):
    """xsmm.unary: the reference's kernels are jnp (tpp_mlir_tpu/xsmm/
    kernels.py:3315-3335), so the port's are these PyTorch ops and no CUDA
    kernel. "zero" fills the output shape; "identity" broadcasts to it
    (a bcast_col or bcast_scalar operand of a generic); "transpose" and
    "vnni2" ([..., K, N] -> [..., K/v, N, v]) move data; every other kind
    computes in f32 and rounds once to the output dtype."""
    check_slice(key)
    out_dt = DTYPES[key.out_dtype or key.dtype]
    out_shape = key.out_shape or key.shape
    if key.kind == "zero":
        return lambda x=None: torch.zeros(
            out_shape, dtype=out_dt,
            device=None if x is None else x.device)
    if key.kind == "identity":
        return lambda x: x.broadcast_to(out_shape).to(out_dt).contiguous()
    if key.kind in ("vnni2", "vnni"):
        *lead, K, N = key.shape
        vf = key.vnni
        return lambda x: x.reshape(*lead, K // vf, vf, N).movedim(-2, -1) \
            .contiguous()
    if key.kind == "transpose":
        perm = key.perm or tuple(reversed(range(len(key.shape))))
        return lambda x: x.permute(*perm).contiguous().to(out_dt)
    fn = UNARY_FNS[key.kind]
    return lambda x: fn(x.float()).to(out_dt)


LN_MAX_VPL = 8   # csrc/layer_norm.cu's register template: vectors a lane


def layer_norm_route(key: LayerNormKey) -> str:
    """Which body of csrc/layer_norm.cu runs B12 at `key`, from the key
    alone:
      "register"  rows of whole 16-byte vectors of the input dtype (n a
                  multiple of 4 in f32, of 8 in bf16 or f16) and at most
                  LN_MAX_VPL of them a lane of the row's warp (n up to 1,024
                  f32 or 2,048 bf16 or f16): the row is loaded once into
                  registers, one-pass;
      "strided"   any other n: the first design, each lane walking the row
                  with stride 32 and reading it three times.
    The wrapper also needs the operands 16-byte aligned on the "register"
    route (every torch allocation is) and copies one that is not."""
    es = 4 if key.dtype == "f32" else 2
    vectors = key.n * es // 16
    if key.n * es % 16 == 0 and -(-vectors // 32) <= LN_MAX_VPL:
        return "register"
    return "strided"


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
    check_slice(key)
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
        raise ValueError(f"unknown dtype {key.dtype!r}: {key}")
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


DECODE_TARGET_BLOCKS = 2 * H100_SMS   # blocks at a full cache
DECODE_CHUNK_BYTES = 48 * 1024        # K + V of a chunk in shared memory
DECODE_TILE = 64                      # rows a bulk copy lands
DECODE_MAX_TILES = 2                  # tiles a chunk


def decode_attn_plan(key: DecodeAttnKey) -> tuple[int, int]:
    """(chunk, splits) of csrc/decode_attn.cu at `key`: the cache's S rows
    are cut into `splits` chunks of `chunk` rows, one block per (chunk, KV
    head, batch row); a chunk whose first row is past pos exits at once.
    The chunk is a multiple of 64 rows (one bulk copy and barrier a 64-row
    tile), at most 128 and, above 64, at most DECODE_CHUNK_BYTES of K and
    V, and no larger than gives DECODE_TARGET_BLOCKS blocks over the whole
    cache (two an SM). On the H100 at the serving keys (B 8, S 1024, D 64,
    pos 639; MHA, GQA kv4, int8 KV) chunks of 128 rows ran as fast as or
    faster than 64, 192 or 256 (scripts/exp_decode_split.py)."""
    es = 1 if key.kv_quant else (4 if key.dtype == "f32" else 2)
    row = 2 * key.head_dim * es
    cap = max(DECODE_TILE, min(DECODE_MAX_TILES * DECODE_TILE,
                               DECODE_CHUNK_BYTES // row // DECODE_TILE
                               * DECODE_TILE))
    splits = -(-DECODE_TARGET_BLOCKS // (key.batch * key.heads))
    rows = -(-key.seq // splits)
    chunk = min(cap, max(DECODE_TILE, -(-rows // DECODE_TILE) * DECODE_TILE))
    return chunk, -(-key.seq // chunk)


def int8_gemm_reference(key: Int8GemmKey):
    """(xq @ wq) exactly, then * xscale[m] * wscale[n] (+ bias) in f32, the
    unary, one rounding (tpp_mlir_tpu/xsmm/kernels.py:1422-1430). The s32
    sum is taken in f64, where every such sum is exact, and its rounding to
    f32 is the kernel's int32 -> f32 conversion. `wt`, the weight's K-major
    (n, k) copy the kernel reads, is accepted and not needed here."""
    check_slice(key)
    m, n = key.m, key.n
    out_dt = DTYPES[key.out_dtype]

    def fn(xq, wq, xscale, wscale, bias=None, wt=None):
        acc = (xq.double() @ wq.double()).float()
        y = acc * xscale.reshape(m, 1).float() * wscale.reshape(1, n).float()
        if key.has_bias:
            y = y + bias.reshape(1, n).float()
        if key.unary_kind:
            y = UNARY_FNS[key.unary_kind](y)
        return y.to(out_dt)
    return fn


INT8_BK = 128      # k a stage of csrc/int8_gemm.cu's ring (128 bytes)


def int8_gemm_route(key: Int8GemmKey) -> str:
    """Which body of csrc/int8_gemm.cu runs B15 at `key`: "wgmma" (the TMA +
    wgmma s8 mainloop on int8_gemm_plan's persistent tiles) for every key
    with k a multiple of 16, the rule of the first design too (TMA's row
    stride, WMMA's fragment), so no key falls back; "wmma", the first
    design, runs only where forced (kernels.build_int8). A k that is not a
    multiple of 16 has no body (ValueError). A ragged m, n or k is masked
    by TMA's out-of-bounds fill on the way in and by the stores."""
    if key.k % 16:
        raise ValueError(f"int8_gemm.cu needs k a multiple of 16: {key}")
    return "wgmma"


class Int8Plan(NamedTuple):
    """csrc/int8_gemm.cu's plan (i8_plan there, which refuses another):
    the output tile (bm rows: one or two consumer warpgroups of 64, beside
    an epilogue warpgroup and a producer warp; bn columns: the wgmma N),
    the ring's stages, the k split, the tiles (m
    tiles x n tiles x split), the grid and whether it is persistent (more
    tiles than SMs: each block walks tiles grid apart), and the dynamic
    shared memory a block asks for."""

    bm: int
    bn: int
    stages: int
    split: int
    tiles: int
    grid: int
    persistent: bool
    smem: int


def int8_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Shared memory of csrc/int8_gemm.cu's I8Tile: the ring (X rows and Wt
    rows of 128 bytes a stage), the s32 staging tile (bn + 4 words a row),
    the epilogue's f32 row scales, the full/empty barriers and 1024 bytes
    of alignment."""
    return stages * (bm + bn) * 128 + bm * (bn + 4) * 4 + bm * 4 + \
        2 * stages * 8 + 1024


def int8_gemm_plan(key: Int8GemmKey) -> Int8Plan:
    """B15's plan at `key` on the H100's 132 SMs: 128 rows (two consumer
    warpgroups) above m 64, else 64; 192 columns above n 128, else 128 (the
    widest wgmma N whose s32 staging tile fits beside a ring of 3 stages:
    4096 x 768 is 128 tiles, one wave); the ring 3 stages at 128 x 192,
    else 4. Under half a wave of tiles, k is split into as many slices as
    fill the card, each at least four 128-deep stages (the s32 partials sum
    exactly in any order). A grid of min(tiles, 132) blocks; with more
    tiles than that the blocks are persistent (the LM head's 8,384)."""
    int8_gemm_route(key)
    bm = 128 if key.m > 64 else 64
    bn = 192 if key.n > 128 else 128
    stages = 3 if (bm, bn) == (128, 192) else 4
    mn = -(-key.m // bm) * -(-key.n // bn)
    kt = -(-key.k // INT8_BK)
    split = max(1, min(H100_SMS // mn, kt // 4)) if 2 * mn <= H100_SMS \
        else 1
    tiles = mn * split
    return Int8Plan(bm, bn, stages, split, tiles, min(tiles, H100_SMS),
                    tiles > H100_SMS, int8_smem_bytes(bm, bn, stages))


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


GROUPED_BM_QUANTUM = 16     # the WMMA tile's rows: 16, 32 or 64


def grouped_gemm_route(key: GroupedGemmKey) -> str:
    """Which tile of csrc/grouped_gemm.cu runs B16 at `key`, or raise:
      "wgmma"  bf16 or f16 operands (products in their type), bm a
               multiple of 64 (the tile's 64 or 128 rows divide it, so no
               tile straddles two row blocks), k and n multiples of 8 (TMA
               takes the row strides): the pipelined TMA + wgmma tile;
               every key of the MoE slice;
      "wmma"   any other bm that is a multiple of 16, f32 operands ("default"
               and "highest"), strides TMA cannot take: the WMMA (bf16, or
               f16 for f16 keys) / f32-FMA tile staged through shared
               memory.
    A bm that is not a multiple of 16 has no tile (ValueError)."""
    if key.bm % GROUPED_BM_QUANTUM:
        raise ValueError(f"grouped_gemm.cu needs bm a multiple of "
                         f"{GROUPED_BM_QUANTUM}: {key}")
    if key.dtype in ("bf16", "f16") and key.bm % 64 == 0 and \
            tma_aligned(2, key.k, key.n):
        return "wgmma"
    return "wmma"


def grouped_wgrad_route(key: GroupedWgradKey,
                        xt_stride: tuple[int, int] | None = None) -> str:
    """Which tile of csrc/grouped_gemm.cu runs B17 at `key` with xt of
    strides `xt_stride` (default (1, k): the transpose of a contiguous
    (m, k) tensor, as the MoE training backward passes it):
      "wgmma"  bf16 or f16 operands, bm a multiple of 64 (no 64-row slice
               straddles two groups), n a multiple of 8 (TMA takes dY's row
               stride), xt with one unit stride and the other a 16-byte
               multiple (TMA's MN-major or K-major A tile): the pipelined
               TMA + wgmma tile; every key of the MoE slice;
      "wmma"   f32 operands ("default" and "highest"), a bm of 16 or 32,
               strides TMA cannot take: the WMMA (bf16 or f16) / f32-FMA
               tile staged through shared memory, which reads any strides
               and any bm."""
    xs0, xs1 = xt_stride if xt_stride is not None else (1, key.k)
    if key.dtype in ("bf16", "f16") and key.bm % 64 == 0 and \
            tma_aligned(2, key.n) and \
            ((xs0 == 1 and tma_aligned(2, xs1)) or
             (xs1 == 1 and tma_aligned(2, xs0))):
        return "wgmma"
    return "wmma"


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


def flash_train_fwd_route(key: FlashTrainKey) -> str:
    """Which kernel runs B14 at `key`:
      "wgmma"  bf16 or f16 operands: csrc/attention.cu's wgmma kernel in its
               training mode (TMA K/V ring, accumulators in registers;
               products of the operands' type);
      "fma"    f32 operands: csrc/flash_train.cu's f32-FMA forward (no
               tensor cores: the TPU's f32 B14 is true f32)."""
    return "fma" if key.dtype == "f32" else "wgmma"


def flash_train_bwd_route(key: FlashTrainKey) -> str:
    """Which kernel runs B18 at `key`:
      "wgmma"  bf16 or f16 operands: csrc/flash_train.cu's two wgmma passes
               (TMA rings, S/dP and the dK/dV/dQ accumulators in
               registers; products of the operands' type);
      "fma"    f32 operands: csrc/flash_train.cu's f32-FMA passes (no
               tensor cores: the TPU's f32 B18 is true f32)."""
    return "fma" if key.dtype == "f32" else "wgmma"


def flash_train_pv_dtype(key: FlashTrainKey) -> torch.dtype:
    """The dtype B14/B18 round P and dS to and store O, dQ, dK and dV in:
    bf16 for bf16 and f16 operands, f32 for f32 (the JAX package's
    `_pv_dtype` and `odt`, tpp_mlir_tpu/xsmm/flash_train.py:141, :154,
    :199)."""
    return torch.float32 if key.dtype == "f32" else torch.bfloat16


def flash_train_fwd_reference(key: FlashTrainKey):
    """B14's function (tpp_mlir_tpu/xsmm/flash_train.py:156-171) on the
    (B, S, H, D) layout: fn(q, k, v) -> (o, lse2). O = (P V) / l with
    P = exp2(s2 - m2) rounded to flash_train_pv_dtype (bf16 for bf16 and
    f16 operands) before the product, l the f32 row sum of P; the products
    exact in f32 on the operands as stored; o in flash_train_pv_dtype,
    (B, S, H, D); lse2 = m2 + log(l) log2(e), (B, H, S) f32, the base-2
    log-sum-exp with the scale folded in, private to B14 and B18."""
    check_slice(key)
    pv = flash_train_pv_dtype(key)

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
    (B, S, H, D) layout: fn(q, k, v, do, lse2, delta) -> (dq, dk, dv) in
    flash_train_pv_dtype (bf16 for bf16 and f16 operands), with lse2 and
    delta = rowsum(dO * O) as (B, H, S) f32. P = exp2(s2 - lse2);
    dV = P'^T dO; dP = dO V^T; dS = (P (dP - delta) scale)'; dQ = dS K;
    dK = dS^T Q, where ' rounds to flash_train_pv_dtype; products exact in
    f32 on the operands as stored, sums in f32."""
    check_slice(key)
    pv = flash_train_pv_dtype(key)

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
               ConvBrgemmKey: conv_brgemm_reference,
               UnaryKey: unary_reference, BinaryKey: binary_reference}


def reference_kernel(key):
    """The plain version for any key of the slice."""
    check_slice(key)   # raises for keys outside it, naming the ROADMAP item
    return _REFERENCES[type(key)](key)
