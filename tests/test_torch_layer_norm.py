"""LayerNorm of the port against the JAX package, on the CPU.

The plain version of LayerNormKey (the oracle csrc/layer_norm.cu is held to
on the card) against the Pallas B12 kernel `_build_layer_norm` in interpret
mode, and the executor's tl.layer_norm against the JAX evaluator.

Error measure: max|port - jax| / max|jax|. Tolerances: 1e-5 for an f32
output (two-pass f32 statistics on both sides, sum order only); a bf16
output is the same f32 value rounded once, so it is held to one bf16 step,
4e-3 (measured: equal).
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
from tpp_mlir_tpu_torch.xsmm import (LayerNormKey, build_kernel,
                                     reference_kernel)
from tpp_mlir_tpu_torch.xsmm.reference import DTYPES


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _inputs(key, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((key.m, key.n)) * 3 + 1).astype(np.float32)
    if key.dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    gamma = rng.standard_normal(key.n).astype(np.float32)
    beta = rng.standard_normal(key.n).astype(np.float32)
    return x, gamma, beta


CASES = {
    "f32-affine": LayerNormKey(m=64, n=96, dtype="f32"),
    "f32-plain": LayerNormKey(m=64, n=96, dtype="f32", affine=False),
    "bf16-affine": LayerNormKey(m=48, n=768, dtype="bf16"),
    "bf16-plain": LayerNormKey(m=48, n=768, dtype="bf16", affine=False),
    "f32-eps": LayerNormKey(m=16, n=1024, dtype="f32", eps=1e-6),
}


@pytest.mark.parametrize("name", list(CASES))
def test_layer_norm_plain_matches_pallas_interpret(name):
    key = CASES[name]
    x, gamma, beta = _inputs(key)
    ref_key = ref_flags.LayerNormKey(**dataclasses.asdict(key))
    want = jax_build_kernel(ref_key, interpret=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    got = reference_kernel(key)(to_torch(x), to_torch(gamma),
                                to_torch(beta))
    assert got.dtype == DTYPES[key.dtype]
    assert _err(got, want) <= (1e-5 if key.dtype == "f32" else 4e-3)


def test_wrapper_takes_the_plain_version_on_cpu():
    key = CASES["bf16-affine"]
    args = [to_torch(a) for a in _inputs(key)]
    kern = build_kernel(key)
    assert (kern(*args) == reference_kernel(key)(*args)).all()
    assert kern.launches == 0


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tl_layer_norm_oracle_matches_jax_evaluator(dtype, affine):
    key = LayerNormKey(m=32, n=80, dtype=dtype)
    x, gamma, beta = _inputs(key, seed=4)

    def module(ir):       # each package evaluates IR of its own classes
        t, v = ir.TensorType((32, 80), dtype), ir.TensorType((80,), "f32")
        m = ir.Module()
        f = m.add(ir.Function("entry", [t, v, v], ["x", "g", "b"]))
        b = ir.TppBuilder(f)
        operands = list(f.args) if affine else [f.args[0]]
        f.returns = [b.create("tl.layer_norm", operands, [t],
                              {"eps": 1e-5}).result]
        m.verify()
        return m
    m = module(port_ir)
    want, = jax_interpret(module(jax_ir), "entry",
                          *map(jnp.asarray, (x, gamma, beta)))
    got = port_compile(m, device="cpu")(*map(to_torch, (x, gamma, beta)))
    assert _err(got, want) <= (1e-5 if dtype == "f32" else 4e-3)
