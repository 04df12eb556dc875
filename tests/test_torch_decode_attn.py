"""The plain versions of the serving kernels against the JAX package's:
DecodeAttnKey (B13, `tpp_mlir_tpu/xsmm/decode_attn.py`) and Int8GemmKey
(B15, `tpp_mlir_tpu/xsmm/kernels.py:1365`), both run in interpret mode, on
the same seeded numpy inputs. The wrappers reach these plain versions for
CPU tensors; on the card, `tests/test_torch_cuda.py` and `chip_smoke.py`
hold the CUDA kernels to them.

Tolerance 1e-5 (max |port - JAX|, relative to max |JAX|): both sides compute
in f32 from the same rounded operands, so only the summation order differs;
the int8 GEMM's integer product is exact on both sides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpp_mlir_tpu.serving.quant import quantize_tokens as jax_quantize_tokens
from tpp_mlir_tpu.xsmm import build_kernel as jax_build_kernel
from tpp_mlir_tpu.xsmm.decode_attn import (DecodeAttnKey as JaxDecodeKey,
                                           build_decode_attn)
from tpp_mlir_tpu.xsmm.flags import Int8GemmKey as JaxInt8Key
from tpp_mlir_tpu_torch.xsmm import (DecodeAttnKey, Int8GemmKey,
                                     build_kernel, reference_kernel)

TOL = 1e-5
L, LI = 2, 1     # a stacked cache of two layers, read at the second


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / \
        max(np.abs(want).max(), 1e-30)


def _bf16_round(a):
    return np.asarray(torch.from_numpy(a).bfloat16().float())


@pytest.mark.parametrize("key,pos", [
    (DecodeAttnKey(2, 4, 32, 16, "f32", stacked=L), 9),
    (DecodeAttnKey(2, 4, 32, 64, "bf16", stacked=L), 31),
    (DecodeAttnKey(2, 4, 32, 32, "f32", slotted=True, stacked=L), [5, 32]),
    (DecodeAttnKey(2, 2, 32, 16, "f32", groups=2, stacked=L), 12),
    (DecodeAttnKey(2, 4, 32, 16, "bf16", kv_quant=True, stacked=L), 20),
    (DecodeAttnKey(2, 4, 32, 32, "f32", pack2=True, stacked=L), 17),
], ids=["mha-f32-d16", "mha-bf16-d64", "slotted-sentinel", "gqa-g2",
        "int8-kv", "pack2"])
def test_decode_attn_plain_matches_jax(key, pos):
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    rng = np.random.default_rng(0)
    if key.pack2:
        q_shape, slab = (B, H // 2, 2 * D), (L, B, H // 2, S, 2 * D)
    else:
        q_shape = (B, H, D) if G == 1 else (B, H, G, D)
        slab = (L, B, H, S, D)
    q = rng.standard_normal(q_shape, np.float32)
    k = rng.standard_normal(slab, np.float32)
    v = rng.standard_normal(slab, np.float32)
    if key.dtype == "bf16":
        q, k, v = _bf16_round(q), _bf16_round(k), _bf16_round(v)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[key.dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    scales = {}
    if key.kv_quant:
        jk, ks = jax_quantize_tokens(jnp.asarray(k))
        jv, vs = jax_quantize_tokens(jnp.asarray(v))
        k, v = np.array(jk), np.array(jv)
        scales = {"k_s": np.array(ks), "v_s": np.array(vs)}
    pos = np.asarray(pos, np.int32)
    want = build_decode_attn(
        JaxDecodeKey(**dataclasses.asdict(key)), interpret=True)(
        jq, jk, jv, jnp.asarray(pos), LI,
        **{n: jnp.asarray(s) for n, s in scales.items()})
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    tq = torch.from_numpy(q).to(tdt)
    if key.kv_quant:
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    kern = build_kernel(key)        # CPU tensors: the wrapper's plain path
    got = kern(tq, tk, tv, torch.from_numpy(pos), LI,
               **{n: torch.from_numpy(s) for n, s in scales.items()})
    assert kern.launches == 0
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL


def test_decode_attn_reads_only_live_rows():
    """Rows past pos do not enter the result: garbage there changes
    nothing (the kernel never reads them)."""
    key = DecodeAttnKey(2, 2, 16, 32, "f32", slotted=True, stacked=L)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 32, generator=g)
    k = torch.randn(L, 2, 2, 16, 32, generator=g)
    v = torch.randn(L, 2, 2, 16, 32, generator=g)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    fn = reference_kernel(key)
    want = fn(q, k, v, pos, LI)
    k2, v2 = k.clone(), v.clone()
    k2[LI, 0, :, 4:] = 1e4
    v2[LI, 1, :, 10:] = -1e4
    torch.testing.assert_close(fn(q, k2, v2, pos, LI), want, rtol=0, atol=0)


@pytest.mark.parametrize("key", [
    DecodeAttnKey(2, 4, 32, 16, "bf16", groups=2, pack2=True),
    DecodeAttnKey(2, 4, 32, 16, "bf16", kv_quant=True, pack2=True),
    DecodeAttnKey(2, 3, 32, 16, "bf16", pack2=True),
    DecodeAttnKey(2, 4, 32, 16, "f16"),
], ids=["pack2-gqa", "pack2-int8", "pack2-odd-heads", "f16"])
def test_decode_attn_refuses_what_the_reference_refuses(key):
    if key.dtype == "f16":
        # refused until ROADMAP A14 item 8; the JAX package's Pallas body
        # takes f16 K/V (tests/test_torch_f16_attention.py holds the plain
        # version to it): f32 out, finite
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float16)) for s in ((2, 4, 16), (2, 4, 32, 16),
                                   (2, 4, 32, 16)))
        out = reference_kernel(key)(q, k, v, torch.tensor(20,
                                                          dtype=torch.int32))
        assert out.dtype == torch.float32 and out.shape == (2, 4, 16)
        assert torch.isfinite(out).all()
        return
    with pytest.raises((ValueError, NotImplementedError)):
        reference_kernel(key)


@pytest.mark.parametrize("m,bias,unary,out", [
    (32, True, None, "f32"), (32, True, "gelu", "f32"),
    (64, False, None, "f32"), (64, True, "gelu", "bf16"),
    (32, False, None, "bf16"),
], ids=["m32-bias", "m32-bias-gelu", "m64-plain", "m64-gelu-bf16",
        "m32-plain-bf16"])
def test_int8_gemm_plain_matches_jax(m, bias, unary, out):
    k, n = 64, 128
    rng = np.random.default_rng(m + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.random(m) * 0.02).astype(np.float32)
    ws = (rng.random((1, n)) * 0.02).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    args = (xq, wq, xs, ws) + ((b,) if bias else ())
    key = Int8GemmKey(m=m, n=n, k=k, out_dtype=out, has_bias=bias,
                      unary_kind=unary)
    want = jax_build_kernel(JaxInt8Key(**dataclasses.asdict(key)),
                            interpret=True)(*map(jnp.asarray, args))
    got = build_kernel(key)(*map(torch.from_numpy, args))
    assert str(got.dtype) == {"f32": "torch.float32",
                              "bf16": "torch.bfloat16"}[out]
    assert _rel(got.float().numpy(), want) <= TOL


def test_int8_gemm_plain_is_exact_integer_product():
    """The s32 sum is exact: a product far beyond f32's 24-bit mantissa for
    a single term still matches int64 arithmetic before the one rounding."""
    key = Int8GemmKey(m=33, n=48, k=4096)
    g = torch.Generator().manual_seed(1)
    xq = torch.randint(-127, 128, (33, 4096), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (4096, 48), generator=g, dtype=torch.int8)
    ones_m, ones_n = torch.ones(33), torch.ones(48)
    got = reference_kernel(key)(xq, wq, ones_m, ones_n)
    exact = (xq.long() @ wq.long()).float()
    assert torch.equal(got, exact)
