"""The port's plain versions (tpp_mlir_tpu_torch/xsmm/reference.py) against
the JAX package's Pallas kernels in interpret mode, on the same seeded
numpy inputs.

Error measure: max|port - jax| / max|jax|. Tolerances:
  * f32 at precision "highest": 1e-5 (sum order only);
  * the LayerNorm prologue in bf16: 1e-2 (both sides normalize in f32 and
    round the result to bf16 before the product; measured 1e-4); at f32
    "default" the port rounds the normalized rows to bf16 and interpret
    mode does not, and pre-rounding A on the JAX side is not the same
    thing, so f32 prologue cases run at "highest";
  * single GEMMs at f32 "default": the port rounds operands to bf16 (the
    compiled TPU meaning), interpret mode keeps f32, so the JAX side gets
    operands pre-rounded to bf16: 1e-5;
  * chains at f32 "default", and everything bf16: 1e-2 (bench.py:88-91).
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu.xsmm.kernels import _BINARY_FNS, _UNARY_FNS
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.xsmm import (BinaryKey, BrgemmKey, ChainKey,
                                     FlashMhaKey, UnaryKey, build_kernel,
                                     reference_kernel)
from tpp_mlir_tpu_torch.xsmm.reference import BINARY_FNS, UNARY_FNS

TIGHT, LOOSE = 1e-5, 1e-2


def _ref_key(key):
    return getattr(ref_flags, type(key).__name__)(**dataclasses.asdict(key))


def _np(shape, rng, dtype, scale=1.0):
    arr = (rng.standard_normal(shape) * scale).astype(np.float32)
    return arr.astype(ml_dtypes.bfloat16) if dtype == "bf16" else arr


def _bf16_round(arr):
    return arr.astype(ml_dtypes.bfloat16).astype(np.float32)


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _tol(key, chain=False):
    if key.dtype == "f32" and (key.precision == "highest" or not chain):
        return TIGHT
    return LOOSE


M, N, K = 32, 64, 128
BRGEMM_CASES = {
    "gemm-f32-beta0": BrgemmKey(1, M, N, K, "f32", beta0=True),
    "gemm-f32-C": BrgemmKey(1, M, N, K, "f32"),
    "fc-f32-bias-relu": BrgemmKey(1, M, N, K, "f32", beta0=True,
                                  binary_kind="add", unary_kind="relu"),
    "gemm-f32-highest": BrgemmKey(1, M, N, K, "f32", beta0=True,
                                  precision="highest"),
    "gemm-bf16-beta0": BrgemmKey(1, M, N, K, "bf16", beta0=True),
    "gemm-bf16-C": BrgemmKey(1, M, N, K, "bf16"),
    "fc-bf16-bias-relu": BrgemmKey(1, M, N, K, "bf16", beta0=True,
                                   binary_kind="add", unary_kind="relu"),
    "bf16-in-f32-out": BrgemmKey(1, M, N, K, "bf16", out_dtype="f32",
                                 beta0=True, binary_kind="add"),
    "bcast-row-mul": BrgemmKey(1, M, N, K, "bf16", beta0=True,
                               binary_kind="mul", binary_bcast="bcast_row"),
    "bcast-scalar-sub-gelu": BrgemmKey(1, M, N, K, "bf16", beta0=True,
                                       binary_kind="sub",
                                       binary_bcast="bcast_scalar",
                                       unary_kind="gelu"),
    "full-add-tanh": BrgemmKey(1, M, N, K, "f32", binary_kind="add",
                               binary_bcast="none", unary_kind="tanh"),
    "transpose-b": BrgemmKey(1, M, N, K, "bf16", beta0=True,
                             transpose_b=True),
    "batch-4": BrgemmKey(4, M, N, K, "bf16", beta0=True),
    "vnni-2": BrgemmKey(1, M, N, K, "bf16", beta0=True, vnni=2,
                        binary_kind="add", unary_kind="relu"),
    "ragged-40x24x40": BrgemmKey(1, 40, 24, 40, "f32", beta0=True,
                                 binary_kind="add", unary_kind="relu"),
    "ln-bf16-bias-gelu": BrgemmKey(1, M, N, K, "bf16", beta0=True,
                                   binary_kind="add", unary_kind="gelu",
                                   prologue="layer_norm"),
    "ln-bf16-C-no-affine": BrgemmKey(1, M, N, K, "bf16",
                                     prologue="layer_norm",
                                     prologue_affine=False),
    "ln-f32-highest-bias": BrgemmKey(1, M, N, K, "f32", beta0=True,
                                     binary_kind="add", precision="highest",
                                     prologue="layer_norm",
                                     prologue_eps=1e-6),
}


def _brgemm_inputs(key, seed=0):
    rng = np.random.default_rng(seed)
    a = _np((key.batch, key.m, key.k), rng, key.dtype)
    if key.vnni:
        b = _np((key.batch, key.k // key.vnni, key.n, key.vnni), rng,
                key.dtype, 0.1)
    elif key.transpose_b:
        b = _np((key.batch, key.n, key.k), rng, key.dtype, 0.1)
    else:
        b = _np((key.batch, key.k, key.n), rng, key.dtype, 0.1)
    c = None if key.beta0 else _np((key.m, key.n), rng, "f32")
    d = None
    if key.binary_kind:
        shape = {"bcast_col": (key.n,), "bcast_row": (key.m, 1),
                 "bcast_scalar": (), "none": (key.m, key.n)}[key.binary_bcast]
        d = _np(shape, rng, "f32")
    return a, b, c, d


def _ln_inputs(key, seed=1):
    """gamma/beta of a LayerNorm prologue (f32), else (None, None); A gets
    a mean and scale away from 0 and 1 so the normalization shows."""
    if not (key.prologue and key.prologue_affine):
        return None, None
    rng = np.random.default_rng(seed)
    return (_np((key.k,), rng, "f32"), _np((key.k,), rng, "f32"))


@pytest.mark.parametrize("name", list(BRGEMM_CASES))
def test_brgemm_plain_matches_pallas_interpret(name):
    key = BRGEMM_CASES[name]
    a, b, c, d = _brgemm_inputs(key)
    if key.prologue:
        a = (a.astype(np.float32) * 3 + 0.5).astype(a.dtype)
    gamma, beta = _ln_inputs(key)
    ja, jb = a, b
    if key.dtype == "f32" and key.precision == "default":
        ja, jb = _bf16_round(a), _bf16_round(b)
    jargs = [jnp.asarray(x) if x is not None else None
             for x in (ja, jb, c, d)]
    kw = {} if gamma is None else {"gamma": jnp.asarray(gamma),
                                   "beta": jnp.asarray(beta)}
    want = jax_build_kernel(_ref_key(key), interpret=True)(*jargs, **kw)
    got = reference_kernel(key)(*[to_torch(x) if x is not None else None
                                  for x in (a, b, c, d, gamma, beta)])
    assert got.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[
        key.out_dtype or key.dtype]
    assert _err(got, want) <= _tol(key)


CHAIN_CASES = {
    "bf16-relu": ChainKey(m=M, dims=(64, 128, 64, 64), dtype="bf16"),
    "f32-default-relu": ChainKey(m=M, dims=(64, 128, 64, 64)),
    "f32-highest-relu": ChainKey(m=M, dims=(64, 128, 64, 64),
                                 precision="highest"),
    "f32-highest-gelu-nobias": ChainKey(m=M, dims=(64, 64, 128),
                                        has_bias=False, unary_kind="gelu",
                                        last_unary=None,
                                        precision="highest"),
    "bf16-repeats-4": ChainKey(m=M, dims=(64, 64, 64), dtype="bf16",
                               repeats=4),
    "f32-highest-repeats-4": ChainKey(m=M, dims=(64, 64, 64),
                                      precision="highest", repeats=4),
}


def _chain_inputs(key, seed=0):
    rng = np.random.default_rng(seed)
    out = [_np((key.m, key.dims[0]), rng, key.dtype)]
    for i in range(len(key.dims) - 1):
        out.append(_np((key.dims[i], key.dims[i + 1]), rng, key.dtype,
                       key.dims[i] ** -0.5))
        if key.has_bias:
            out.append(_np((key.dims[i + 1],), rng, key.dtype, 0.1))
    return out


@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_chain_plain_matches_pallas_interpret(name):
    """B3, and with repeats the in-kernel bench B4 (_build_chain_bench)."""
    key = CHAIN_CASES[name]
    arrs = _chain_inputs(key)
    want = jax_build_kernel(_ref_key(key), interpret=True)(
        *map(jnp.asarray, arrs))
    got = reference_kernel(key)(*map(to_torch, arrs))
    assert _err(got, want) <= _tol(key, chain=True)


def test_chain_repeats_feed_back_in_the_mxu_dtype():
    # B4 holds the fed-back state in bf16 at f32 "default": a repeats=2
    # chain equals two repeats=1 applications with a bf16 rounding between
    key = ChainKey(m=8, dims=(16, 16), dtype="f32")
    x, w, b = map(to_torch, _chain_inputs(key))
    one = reference_kernel(key)
    two = reference_kernel(dataclasses.replace(key, repeats=2))
    step = one(one(x, w, b).bfloat16().float(), w, b)
    assert torch.equal(two(x, w, b), step.bfloat16().float())


@pytest.mark.parametrize("kind", sorted(UNARY_FNS))
def test_unary_table_matches_reference(kind):
    rng = np.random.default_rng(1)
    lo = 0.1 if kind in ("sqrt", "rsqrt") else -4.0
    x = rng.uniform(lo, 4.0, 4096).astype(np.float32)
    want = np.asarray(_UNARY_FNS[kind](jnp.asarray(x)), np.float32)
    got = UNARY_FNS[kind](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(BINARY_FNS))
def test_binary_table_matches_reference(kind):
    rng = np.random.default_rng(2)
    a = rng.standard_normal(1024).astype(np.float32)
    b = rng.uniform(0.5, 2.0, 1024).astype(np.float32)
    want = np.asarray(_BINARY_FNS[kind](jnp.asarray(a), jnp.asarray(b)))
    got = BINARY_FNS[kind](torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    key = BRGEMM_CASES["fc-bf16-bias-relu"]
    args = [to_torch(x) if x is not None else None
            for x in _brgemm_inputs(key)]
    kern = build_kernel(key)
    assert torch.equal(kern(*args), reference_kernel(key)(*args))
    assert kern.launches == 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kern(*[t.to("meta") if t is not None else None for t in args])


@pytest.mark.parametrize("key", [
    BrgemmKey(1, 8, 16, 16, beta0=True, prologue="ln_stats"),
    BrgemmKey(1, 8, 16, 16, beta0=True, ln_stats_out=True)],
    ids=["ln_stats", "ln_stats_out"])
def test_ln_stats_keys_are_in_the_slice(key):
    """B2's LN-stats pair, once refused (queue A6), builds and runs its
    plain version on CPU tensors (tests/test_torch_ln_stats.py holds it to
    the JAX package)."""
    rng = np.random.default_rng(0)
    a, b = (to_torch(_np(s, rng, "f32")) for s in ((1, 8, 16), (1, 16, 16)))
    kw = {}
    if key.prologue:
        kw = dict(gamma=torch.ones(16), beta=torch.zeros(16),
                  mu=a[0].mean(1, keepdim=True),
                  var=a[0].var(1, unbiased=False, keepdim=True))
    out = build_kernel(key)(a, b, **kw)
    y = out[0] if key.ln_stats_out else out
    assert y.shape == (8, 16) and torch.isfinite(y).all()
    if key.ln_stats_out:
        assert out[1].shape == out[2].shape == (8, 1)


@pytest.mark.parametrize("key,item", [
    (BrgemmKey(1, 8, 16, 16, dtype="f16"), "A14"),
    (ChainKey(m=8, dims=(16, 32), repeats=4, pingpong=True,
              dtype="f16"), "A14"),
    (UnaryKey(kind="relu", shape=(8, 16), dtype="f32"), "A3"),
    (BinaryKey(kind="add", shape_a=(8, 16), shape_b=(16,), dtype="f32"),
     "A3"),
])
def test_keys_outside_the_slice_name_their_roadmap_item(key, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue {item}"):
        build_kernel(key)
