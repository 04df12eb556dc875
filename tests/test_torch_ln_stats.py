"""B2's LayerNorm-statistics pair in the port against the JAX package.

The producer (`ln_stats_out=True`) returns (y, mean, var) of its stored
output's rows; the consumer (`prologue="ln_stats"`) normalizes A's rows
with a producer's (mean, var) before its product. The port's plain
versions (xsmm/reference.py, what the wrapper runs on CPU tensors) are held
to `_build_brgemm_wres(key, interpret=True)` of the JAX package on the same
seeded numpy inputs, at `test_wres_ln_stats_pair`'s shapes
(tests/xsmm/test_kernels.py) and in bf16.

Error measure: max|port - jax| / max|jax|. Tolerances (ROADMAP queue C:
f32 "default" means bf16 operands and f32 sums):
  * f32 "highest": 1e-5 (sum order only), outputs and statistics;
  * f32 "default", producer: the JAX side gets its operands pre-rounded
    to bf16 (interpret mode keeps f32), so 1e-5;
  * f32 "default", consumer: the port rounds the normalized rows to bf16
    before the product and interpret mode does not, and pre-rounding A on
    the JAX side is not the same thing: 1e-2;
  * bf16: 1e-2 for outputs (a sum-order difference can flip a rounding);
    the statistics of the bf16 outputs, 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu.xsmm.kernels import _build_brgemm, _build_brgemm_wres
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.xsmm import BrgemmKey, build_kernel, reference_kernel
from tpp_mlir_tpu_torch.xsmm.reference import ln_stats_out

TIGHT, LOOSE = 1e-5, 1e-2
M, N, K = 1024, 256, 256          # test_wres_ln_stats_pair's shapes


def _ref_key(key):
    return getattr(ref_flags, type(key).__name__)(**dataclasses.asdict(key))


def _keys(dtype, precision):
    common = dict(batch=1, m=M, n=N, k=K, dtype=dtype, precision=precision,
                  beta0=True, binary_kind="add", binary_bcast="bcast_col")
    return (BrgemmKey(**common, unary_kind="relu", ln_stats_out=True),
            BrgemmKey(**common, unary_kind="gelu", prologue="ln_stats"))


def _inputs(dtype, seed=0):
    """test_wres_ln_stats_pair's operands and scales, from numpy."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale, offset=0.0):
        x = (rng.standard_normal(shape) * scale + offset).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if dtype == "bf16" else x
    a = arr((1, M, K), 0.5)
    w0, w1 = arr((1, K, N), 0.05), arr((1, K, N), 0.05)
    d0 = (rng.standard_normal(N) * 0.1).astype(np.float32)
    d1 = (rng.standard_normal(N) * 0.1).astype(np.float32)
    g = (rng.standard_normal(K) * 0.2 + 1.0).astype(np.float32)
    be = (rng.standard_normal(K) * 0.1).astype(np.float32)
    return a, w0, d0, w1, d1, g, be


def _bf16_round(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16) \
        .astype(np.float32)


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _t(x):
    return to_torch(np.asarray(x))


CASES = [("f32", "highest"), ("f32", "default"), ("bf16", "default")]
IDS = ["f32-highest", "f32-default", "bf16"]


@pytest.mark.parametrize("dtype,precision", CASES, ids=IDS)
def test_producer_matches_pallas_interpret(dtype, precision):
    kp, _ = _keys(dtype, precision)
    a, w0, d0, *_ = _inputs(dtype)
    ja, jw = a, w0
    if dtype == "f32" and precision == "default":
        ja, jw = _bf16_round(a), _bf16_round(w0)
    fn = _build_brgemm_wres(_ref_key(kp), True)
    assert fn is not None
    jy, jmu, jvar = fn(jnp.asarray(ja), jnp.asarray(jw), None,
                       jnp.asarray(d0))
    y, mu, var = reference_kernel(kp)(_t(a), _t(w0), None, _t(d0))
    assert mu.shape == var.shape == (M, 1) and mu.dtype == torch.float32
    assert _err(y, jy) <= (LOOSE if dtype == "bf16" else TIGHT)
    stat_tol = 1e-4 if dtype == "bf16" else TIGHT
    assert _err(mu, jmu) <= stat_tol and _err(var, jvar) <= stat_tol


@pytest.mark.parametrize("dtype,precision", CASES, ids=IDS)
def test_consumer_matches_pallas_interpret(dtype, precision):
    """The consumer on the same A, mu and var on both sides (the JAX
    producer's), so only the prologue and product are compared."""
    kp, kc = _keys(dtype, precision)
    a, w0, d0, w1, d1, g, be = _inputs(dtype)
    fp = _build_brgemm_wres(_ref_key(kp), True)
    jy, jmu, jvar = fp(jnp.asarray(a), jnp.asarray(w0), None,
                       jnp.asarray(d0))
    y = np.asarray(jy).reshape(1, M, N)
    fc = _build_brgemm_wres(_ref_key(kc), True)
    assert fc is not None
    want = fc(jnp.asarray(y), jnp.asarray(w1), None, jnp.asarray(d1),
              gamma=jnp.asarray(g), beta=jnp.asarray(be), mu=jmu, var=jvar)
    got = reference_kernel(kc)(_t(y), _t(w1), None, _t(d1), _t(g), _t(be),
                               _t(jmu), _t(jvar))
    tight = dtype == "f32" and precision == "highest"
    assert _err(got, want) <= (TIGHT if tight else LOOSE)


def test_pair_matches_the_unfused_oracle():
    """The JAX test's oracle in f32 "highest": producer -> full LayerNorm
    -> consumer in numpy, with the emitted statistics against numpy's."""
    kp, kc = _keys("f32", "highest")
    a, w0, d0, w1, d1, g, be = _inputs("f32")
    y, mu, var = reference_kernel(kp)(_t(a), _t(w0), None, _t(d0))
    got = reference_kernel(kc)(y.reshape(1, M, N), _t(w1), None, _t(d1),
                               _t(g), _t(be), mu, var)
    yref = np.maximum(a[0].astype(np.float64) @ w0[0] + d0, 0)
    np.testing.assert_allclose(mu.numpy()[:, 0], yref.mean(1), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(var.numpy()[:, 0], yref.var(1), atol=1e-5,
                               rtol=1e-5)
    ln = ((yref - yref.mean(1, keepdims=True))
          / np.sqrt(yref.var(1, keepdims=True) + 1e-5) * g + be)
    want = torch.nn.functional.gelu(torch.from_numpy(ln @ w1[0] + d1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_statistics_are_those_of_the_stored_output():
    """A bf16 producer's (mean, var) are the one-pass statistics of the
    bf16 values it returns, not of its f32 accumulators."""
    kp, _ = _keys("bf16", "default")
    a, w0, d0, *_ = _inputs("bf16")
    y, mu, var = reference_kernel(kp)(_t(a), _t(w0), None, _t(d0))
    assert y.dtype == torch.bfloat16
    wmu, wvar = ln_stats_out(y)
    assert torch.equal(mu, wmu) and torch.equal(var, wvar)
    yf = y.float()
    assert torch.equal(mu, yf.sum(1, keepdim=True) / N)


@pytest.mark.parametrize("which", ["producer", "consumer"])
def test_wrapper_runs_the_pair_on_cpu_without_launching(which):
    kp, kc = _keys("f32", "highest")
    a, w0, d0, w1, d1, g, be = _inputs("f32")
    kern = build_kernel(kp if which == "producer" else kc)
    if which == "producer":
        args = (_t(a), _t(w0), None, _t(d0))
        got = kern(*args)
        want = reference_kernel(kp)(*args)
        assert len(got) == 3
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    else:
        mu, var = (torch.full((M, 1), 0.1), torch.full((M, 1), 2.0))
        kw = dict(gamma=_t(g), beta=_t(be), mu=mu, var=var)
        got = kern(_t(a), _t(w1), None, _t(d1), **kw)
        assert torch.equal(got, reference_kernel(kc)(_t(a), _t(w1), None,
                                                     _t(d1), **kw))
    assert kern.launches == 0


@pytest.mark.parametrize("change", [
    dict(batch=4), dict(vnni=2, dtype="bf16"), dict(transpose_b=True)],
    ids=["batch-4", "vnni", "transpose-b"])
@pytest.mark.parametrize("form", [dict(prologue="ln_stats"),
                                  dict(ln_stats_out=True)],
                         ids=["consumer", "producer"])
def test_shapes_the_weights_resident_kernel_refuses_raise(change, form):
    """What the JAX package refuses by shape (kernels.py:596-601 there:
    batch > 1, VNNI, transpose_b never take the weights-resident path)
    raises a ValueError naming ln_stats here too."""
    key = BrgemmKey(**{**dict(batch=1, m=256, n=256, k=256, beta0=True),
                       **form, **change})
    with pytest.raises(ValueError, match="ln_stats"):
        build_kernel(key)
    with pytest.raises(ValueError, match="ln_stats"):
        _build_brgemm(_ref_key(key), True)
