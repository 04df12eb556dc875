"""The port's libxsmm-shaped GEMM dispatch functions (`tpp_mlir_tpu_torch/
xsmm/cache.py`: gemm_dispatch, brgemm_dispatch, fused_brgemm_dispatch)
against the JAX package's functions of the same names with
interpret="reference", on the same seeded numpy inputs, on the CPU (where
each runs the key's plain version); the JAX package's blocked_matmul,
unary and binary dispatch functions against the port's kernel cache
dispatching the same key (the port has no pass-through for them); and the
kernel cache's hits.

Error measure: max|port - jax| / max|jax|. Tolerances: f32 at precision
"highest" 1e-5 (sum order only); f32 at "default" 1e-5 with the JAX
operands rounded to bf16 (the port's products take bf16 operands there, the
JAX reference keeps f32: ROADMAP "f32 at precision default"); bf16 1e-2;
the eltwise ops, the same PyTorch and jnp functions, 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import tpp_mlir_tpu.xsmm as J
import tpp_mlir_tpu_torch.xsmm as P
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch

TIGHT, LOOSE = 1e-5, 1e-2


def _np(rng, shape, dtype="f32", scale=1.0):
    arr = (rng.standard_normal(shape) * scale).astype(np.float32)
    return arr.astype(ml_dtypes.bfloat16) if dtype == "bf16" else arr


def _jax_args(arrs, bf16_round):
    """The JAX side's operands: the products' operands (the first two)
    rounded to bf16 where the port's products take bf16 (f32 "default")."""
    out = []
    for i, a in enumerate(arrs):
        if a is not None and i < 2 and bf16_round:
            a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        out.append(None if a is None else jnp.asarray(a))
    return out


def _err(port, ref) -> float:
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _both(port_fn, jax_fn, arrs, dtype, precision):
    port = port_fn(*(None if a is None else to_torch(a) for a in arrs))
    ref = jax_fn(*_jax_args(arrs, dtype == "f32" and precision == "default"))
    assert _err(port, ref) <= (LOOSE if dtype == "bf16" else TIGHT)


FORMS = [("f32", "highest"), ("f32", "default"), ("bf16", "default")]


@pytest.mark.parametrize("dtype,precision", FORMS)
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("beta0", [True, False])
def test_gemm_dispatch(dtype, precision, transpose_b, beta0):
    M, N, K = 32, 48, 64
    rng = np.random.default_rng(1)
    a = _np(rng, (M, K), dtype)
    b = _np(rng, (N, K) if transpose_b else (K, N), dtype, 0.1)
    c = None if beta0 else _np(rng, (M, N))
    kw = dict(dtype=dtype, beta0=beta0, transpose_b=transpose_b,
              precision=precision)
    _both(P.gemm_dispatch(M, N, K, **kw),
          J.gemm_dispatch(M, N, K, interpret="reference", **kw),
          (a, b, c), dtype, precision)


@pytest.mark.parametrize("dtype,precision,vnni",
                         [(*f, 0) for f in FORMS] + [("bf16", "default", 2)])
def test_brgemm_dispatch(dtype, precision, vnni):
    B, M, N, K = 4, 32, 48, 64
    rng = np.random.default_rng(2)
    a = _np(rng, (B, M, K), dtype)
    b = _np(rng, (B, K // 2, N, 2) if vnni else (B, K, N), dtype, 0.1)
    c = _np(rng, (M, N))
    kw = dict(dtype=dtype, vnni=vnni, precision=precision)
    _both(P.brgemm_dispatch(B, M, N, K, **kw),
          J.brgemm_dispatch(B, M, N, K, interpret="reference", **kw),
          (a, b, c), dtype, precision)


@pytest.mark.parametrize("dtype,precision", FORMS)
@pytest.mark.parametrize("epilogue", [
    {}, dict(binary_kind="mul", binary_bcast="bcast_row", unary_kind="gelu"),
    dict(binary_kind="add", binary_bcast="none", unary_kind="tanh")],
    ids=["bias-relu", "row-mul-gelu", "full-add-tanh"])
def test_fused_brgemm_dispatch(dtype, precision, epilogue):
    B, M, N, K = 2, 32, 48, 64
    rng = np.random.default_rng(3)
    a = _np(rng, (B, M, K), dtype)
    b = _np(rng, (B, K, N), dtype, 0.1)
    bcast = epilogue.get("binary_bcast", "bcast_col")
    d = _np(rng, {"bcast_col": (N,), "bcast_row": (M, 1),
                  "none": (M, N)}[bcast], dtype)
    kw = dict(dtype=dtype, beta0=True, precision=precision, **epilogue)
    _both(lambda a, b, d: P.fused_brgemm_dispatch(B, M, N, K, **kw)(
              a, b, None, d),
          lambda a, b, d: J.fused_brgemm_dispatch(
              B, M, N, K, interpret="reference", **kw)(a, b, None, d),
          (a, b, d), dtype, precision)


@pytest.mark.parametrize("dtype,precision", FORMS)
def test_blocked_matmul_dispatch(dtype, precision):
    key = P.BlockedMatmulKey(Mb=2, Nb=3, Kb=2, mb=16, nb=16, kb=32,
                             dtype=dtype, binary_kind="add",
                             unary_kind="relu", precision=precision)
    rng = np.random.default_rng(4)
    a = _np(rng, (2, 2, 16, 32), dtype)
    b = _np(rng, (3, 2, 32, 16), dtype, 0.1)
    c = _np(rng, (2, 3, 16, 16))
    d = _np(rng, (3, 16))
    jkey = J.BlockedMatmulKey(**dataclasses.asdict(key))
    _both(P.global_cache().dispatch(key),
          J.blocked_matmul_dispatch(jkey, interpret="reference"),
          (a, b, c, d), dtype, precision)


@pytest.mark.parametrize("kind,shape,kw", [
    ("relu", (16, 24), {}),
    ("identity", (16, 24), {}),
    ("transpose", (16, 24), dict(out_shape=(24, 16))),
    ("exp", (16, 24), {}),
])
def test_unary_dispatch(kind, shape, kw):
    x = _np(np.random.default_rng(5), shape)
    fn = P.global_cache().dispatch(P.UnaryKey(kind, tuple(shape), "f32",
                                              **kw))
    assert fn.launches == 0 and fn.source is None      # no kernel
    assert _err(fn(to_torch(x)), J.unary_dispatch(
        kind, shape, interpret="reference", **kw)(jnp.asarray(x))) <= 1e-6


@pytest.mark.parametrize("kind,shape_b,kw", [
    ("add", (24,), {}),
    ("mul", (16, 24), {}),
    ("sub", (16, 1), dict(bcast_b="bcast_row")),
    ("max", (24,), {}),
])
def test_binary_dispatch(kind, shape_b, kw):
    rng = np.random.default_rng(6)
    a, b = _np(rng, (16, 24)), _np(rng, shape_b)
    fn = P.global_cache().dispatch(P.BinaryKey(kind, (16, 24),
                                               tuple(shape_b), "f32", **kw))
    assert fn.launches == 0 and fn.source is None
    assert _err(fn(to_torch(a), to_torch(b)), J.binary_dispatch(
        kind, (16, 24), shape_b, interpret="reference", **kw)(
            jnp.asarray(a), jnp.asarray(b))) <= 1e-6


def test_repeated_key_is_a_cache_hit():
    cache = P.global_cache()
    first = P.brgemm_dispatch(3, 8, 8, 8, beta0=True)
    hits, misses = cache.stats.hits, cache.stats.misses
    assert P.brgemm_dispatch(3, 8, 8, 8, beta0=True) is first
    assert P.fused_brgemm_dispatch(3, 8, 8, 8, beta0=True, binary_kind=None,
                                   unary_kind=None) is first
    key = P.BrgemmKey(batch=3, m=8, n=8, k=8, beta0=True)
    assert cache.dispatch(key) is first and first.key == key
    assert (cache.stats.hits, cache.stats.misses) == (hits + 3, misses)
    P.gemm_dispatch(8, 8, 8, beta0=True)
    P.gemm_dispatch(8, 8, 8, beta0=True)
    assert (cache.stats.hits, cache.stats.misses) == (hits + 4, misses + 1)


def test_interpret_has_no_counterpart():
    """The operands' device picks the kernel or its plain version: the JAX
    functions' `interpret` argument is not taken."""
    with pytest.raises(TypeError):
        P.gemm_dispatch(8, 8, 8, interpret="reference")
    with pytest.raises(TypeError):
        P.brgemm_dispatch(2, 8, 8, 8, interpret=True)


def test_exported_as_in_the_jax_package():
    names = ("gemm_dispatch", "brgemm_dispatch", "fused_brgemm_dispatch")
    assert set(names) <= set(P.__all__) and set(names) <= set(J.__all__)

