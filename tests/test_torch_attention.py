"""Attention of the port against the JAX package, on the CPU.

The plain version of FlashMhaKey (tpp_mlir_tpu_torch/xsmm/reference.py,
the oracle csrc/attention.cu is held to on the card) against the Pallas B7
kernel `_build_flash_mha_tokens` in interpret mode (strategy "tokens" forces
it: under "auto" a D < 128, S < 1024 key takes the XLA route), and the
executor's tl.attention against the JAX evaluator.

Error measure: max|port - jax| / max|jax|. Tolerances: f32 "highest" 1e-5
(same math, sum order only); bf16 1e-2 (both sides round the scaled Q and
the normalized P to bf16, where a sum-order difference can flip a rounding:
measured up to 3e-3); the tl.attention oracle in f32 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import tpp_mlir_tpu.ir as jax_ir
import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu.runtime.executor import interpret as jax_interpret
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
import tpp_mlir_tpu_torch.ir as port_ir
from tpp_mlir_tpu_torch.runtime import compile as port_compile
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.xsmm import FlashMhaKey, build_kernel, reference_kernel
from tpp_mlir_tpu_torch.xsmm.reference import attention_loader, tma_aligned


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _arr(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bf16" else a


def _cases():
    out = {}
    for dtype, prec in (("bf16", "default"), ("f32", "highest")):
        for d, h in ((64, 2), (128, 1)):       # hp 2 at D 64, 1 at D 128
            for causal in (True, False):
                for packed in (True, False):
                    name = (f"{dtype}-d{d}-{'causal' if causal else 'full'}"
                            f"-{'packed' if packed else 'split'}")
                    out[name] = FlashMhaKey(
                        batch=2, seq=128, seq_kv=128, head_dim=d,
                        dtype=dtype, scale=d ** -0.5, causal=causal,
                        precision=prec, strategy="tokens", heads=h,
                        qkv_packed=packed)
    return out


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_attention_plain_matches_pallas_tokens_interpret(name):
    key = CASES[name]
    rng = np.random.default_rng(7)
    E = key.heads * key.head_dim
    if key.qkv_packed:
        args = [_arr(rng, (key.batch, key.seq, 3 * E), key.dtype)] * 3
    else:
        args = [_arr(rng, (key.batch, key.seq, E), key.dtype)
                for _ in range(3)]
    ref_key = ref_flags.FlashMhaKey(**dataclasses.asdict(key))
    want = jax_build_kernel(ref_key, interpret=True)(*map(jnp.asarray, args))
    got = reference_kernel(key)(*map(to_torch, args))
    tol = 1e-5 if key.precision == "highest" else 1e-2
    assert _err(got, want) <= tol


def test_wrapper_takes_the_plain_version_on_cpu():
    key = CASES["bf16-d64-causal-packed"]
    x = to_torch(_arr(np.random.default_rng(1), (2, 128, 384), "bf16"))
    kern = build_kernel(key)
    assert (kern(x, x, x) == reference_kernel(key)(x, x, x)).all()
    assert kern.launches == 0


def _attention_module(B, S, E, H, causal, dtype, ir=port_ir):
    """One tl.attention, built with `ir`: the port's IR, or jax_ir for the
    JAX package's evaluator."""
    t = ir.TensorType((B, S, E), dtype)
    m = ir.Module()
    f = m.add(ir.Function("entry", [t, t, t], ["q", "k", "v"]))
    b = ir.TppBuilder(f)
    attrs = {"causal": causal, "scale": 0.125}
    if H:
        attrs["heads"] = H
    o = b.create("tl.attention", list(f.args), [t], attrs)
    f.returns = [o.result]
    m.verify()
    return m


@pytest.mark.parametrize("heads,causal", [(2, True), (4, False), (0, True)],
                         ids=["tokens-causal", "tokens-full", "flat-causal"])
def test_tl_attention_oracle_matches_jax_evaluator(heads, causal):
    rng = np.random.default_rng(3)
    args = [_arr(rng, (2, 32, 64), "f32") for _ in range(3)]
    m = _attention_module(2, 32, 64, heads, causal, "f32")
    mj = _attention_module(2, 32, 64, heads, causal, "f32", jax_ir)
    want, = jax_interpret(mj, "entry", *map(jnp.asarray, args))
    got = port_compile(m, device="cpu")(*map(to_torch, args))
    assert _err(got, want) <= 1e-5


# csrc/attention.cu's loader, chosen from the key (xsmm/reference.py
# attention_loader): TMA for bf16 operands whose strides and column offsets
# are 16-byte multiples, the register loader for f32 operands at "default"
# (and bf16 ones TMA cannot take), the f32-FMA kernel at "highest"
LOADERS = {
    "bf16-packed-d64": (dict(dtype="bf16", heads=12, qkv_packed=True), "tma"),
    "bf16-split-d32": (dict(dtype="bf16", head_dim=32, heads=4), "tma"),
    "bf16-flat-d128": (dict(dtype="bf16", head_dim=128), "tma"),
    "bf16-bench": (dict(dtype="bf16", heads=2, repeats=3), "tma"),
    "f32-default-packed-d128": (dict(dtype="f32", head_dim=128, heads=8,
                                     qkv_packed=True), "convert"),
    "f32-default-flat": (dict(dtype="f32"), "convert"),
    "f32-highest": (dict(dtype="f32", precision="highest", heads=3), "fma"),
    "f32-highest-bench": (dict(dtype="f32", precision="highest",
                               repeats=2), "fma"),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_attention_loader_follows_the_key(name):
    fields, want = LOADERS[name]
    key = FlashMhaKey(**{"batch": 2, "seq": 128, "seq_kv": 128,
                         "head_dim": 64, "scale": 0.125, **fields})
    assert attention_loader(key) == want


@pytest.mark.parametrize("itemsize,elements,want", [
    (2, (3 * 768, 768, 64), True),      # GPT-2's packed [Q|K|V]: 3E, E, D
    (2, (3 * 96, 96, 32), True),        # a packed E of 96 at D 32
    (2, (3 * 36, 36, 12), False),       # E 36: 72-byte offsets
    (2, (100,), False),                 # a row stride of 200 bytes
    (4, (100,), True),                  # 400 bytes in f32
])
def test_tma_alignment_gate(itemsize, elements, want):
    assert tma_aligned(itemsize, *elements) is want
