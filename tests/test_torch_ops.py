"""The port's functional ops (tpp_mlir_tpu_torch.ops) against the JAX
package's (tpp_mlir_tpu.ops, its Pallas kernels in interpret mode), on the
same seeded numpy inputs, on the CPU (where the port runs the kernels'
plain versions).

Tolerances, max|port - jax| / max|jax|: f32 "highest" against interpret
mode's exact f32 1e-5 (sum order only); f32 "default" 1e-5 with the JAX
side's operands rounded to bf16 first (the port's products see bf16
operands, as the compiled TPU kernels do, and interpret mode keeps f32);
bf16 operands and a bf16 output 1e-2 (one bf16 rounding of the result,
taken at other places in the two frameworks).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpp_mlir_tpu import ops as jax_ops
from tpp_mlir_tpu_torch import ops

TOL = {"highest": 1e-5, "default": 1e-5, "bf16": 1e-2}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _pair(x: np.ndarray, form: str):
    """(port tensor, JAX array) of the same values in the form's dtype; for
    f32 "default" the JAX side's values rounded to bf16 (kept f32)."""
    if form == "bf16":
        return torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)
    j = x.astype(ml_dtypes.bfloat16).astype(np.float32) \
        if form == "default" else x
    return torch.from_numpy(x), jnp.asarray(j)


def _err(got, want) -> float:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def _prec(form):
    return "highest" if form == "highest" else "default"


FORMS = ["highest", "default", "bf16"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("with_c,out_dtype,transpose_b", [
    (False, None, False), (True, None, False), (True, "f32", False),
    (False, None, True), (False, "bf16", False)])
def test_gemm_matches_jax(form, with_c, out_dtype, transpose_b):
    m, n, k = 48, 80, 96
    a, ja = _pair(_np((m, k), 0), form)
    b, jb = _pair(_np((n, k) if transpose_b else (k, n), 1, 0.1), form)
    c = jc = None
    if with_c:
        c = torch.from_numpy(_np((m, n), 2))
        jc = jnp.asarray(c.numpy())
    got = ops.gemm(a, b, c, out_dtype=out_dtype, transpose_b=transpose_b,
                   precision=_prec(form))
    want = jax_ops.gemm(ja, jb, jc, out_dtype=out_dtype,
                        transpose_b=transpose_b, interpret=True)
    want_dt = out_dtype or ("bf16" if form == "bf16" else "f32")
    assert got.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[
        want_dt]
    tol = 1e-2 if want_dt == "bf16" else TOL[form]
    assert _err(got, want) <= tol


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("with_c", [False, True])
def test_brgemm_matches_jax(form, with_c):
    bt, m, n, k = 3, 32, 64, 48
    a, ja = _pair(_np((bt, m, k), 3), form)
    b, jb = _pair(_np((bt, k, n), 4, 0.1), form)
    c = jc = None
    if with_c:
        c = torch.from_numpy(_np((m, n), 5))
        jc = jnp.asarray(c.numpy())
    got = ops.brgemm(a, b, c, precision=_prec(form))
    want = jax_ops.brgemm(ja, jb, jc, interpret=True)
    assert _err(got, want) <= TOL[form]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bias,activation,out_dtype", [
    (True, "relu", None), (False, "relu", None), (True, None, None),
    (True, "gelu", "f32"), (False, "relu", "bf16")])
def test_fused_mlp_layer_matches_jax(form, bias, activation, out_dtype):
    m, k, n = 40, 64, 72
    x, jx = _pair(_np((m, k), 6), form)
    w, jw = _pair(_np((k, n), 7, 0.1), form)
    b = jb = None
    if bias:
        b, jb = _pair(_np((n,), 8), "bf16" if form == "bf16" else "highest")
    got = ops.fused_mlp_layer(x, w, b, activation=activation,
                              out_dtype=out_dtype, precision=_prec(form))
    want = jax_ops.fused_mlp_layer(jx, jw, jb, activation=activation,
                                   out_dtype=out_dtype, interpret=True)
    want_dt = out_dtype or ("bf16" if form == "bf16" else "f32")
    tol = 1e-2 if want_dt == "bf16" else TOL[form]
    assert _err(got, want) <= tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_relu_matches_jax(dtype):
    x = _np((7, 33), 9)
    t, j = _pair(x, "bf16" if dtype == "bf16" else "highest")
    got, want = ops.relu(t), jax_ops.relu(j)
    assert got.dtype == t.dtype
    assert _err(got, want) == 0.0
