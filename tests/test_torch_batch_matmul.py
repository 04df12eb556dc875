"""The batched matmul (B21/B22) of the port against the JAX package, on the
CPU.

The plain version of BatchMatmulKey (tpp_mlir_tpu_torch/xsmm/reference.py,
the oracle csrc/batch_matmul.cu is held to on the card) against the Pallas
kernels in interpret mode: B22 (`_build_batch_matmul_grouped`, which the
reference picks for problems of one block, as the MHA suite's 32x32x64
and 32x64x32 are) and B21 (`_build_batch_matmul`, m*k above 128*128), with
softmax_lhs, lhs_shared and a C accumulator.

Error measure: max|port - jax| / max|jax|. Tolerances: f32 "highest" 1e-5
(the same math, sum order only); bf16 1e-2 (a bf16 output). f32 "default":
the port rounds every product operand to bf16 (its f32 "default" rule),
softmax_lhs's P too, where the JAX wrapper leaves an f32 A's softmax in f32
and its interpret mode keeps f32 operands. So the JAX side is run on operands
rounded to bf16 (for softmax_lhs: the softmax taken outside in f32 and
rounded to bf16, through the same kernel without softmax_lhs) and held at
1e-5, and the unrounded JAX result at 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, build_kernel,
                                     reference_kernel)


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16) \
        .astype(np.float32)


def _inputs(key, seed=5):
    rng = np.random.default_rng(seed)
    dt = ml_dtypes.bfloat16 if key.dtype == "bf16" else np.float32
    a_shape = (key.m, key.k) if key.lhs_shared else (key.batch, key.m, key.k)
    a = (2 * rng.standard_normal(a_shape)).astype(np.float32).astype(dt)
    b = rng.standard_normal((key.batch, key.k, key.n)).astype(np.float32) \
        .astype(dt)
    c = None if key.beta0 else rng.standard_normal(
        (key.batch, key.m, key.n)).astype(np.float32)
    return a, b, c


def _jax(key, a, b, c):
    ref_key = ref_flags.BatchMatmulKey(**dataclasses.asdict(key))
    args = [jnp.asarray(a), jnp.asarray(b)]
    if c is not None:
        args.append(jnp.asarray(c))
    return jax_build_kernel(ref_key, interpret=True)(*args)


def _port(key, a, b, c):
    return reference_kernel(key)(to_torch(a), to_torch(b),
                                 None if c is None else to_torch(c))


SMALL = dict(batch=8, m=32, n=32, k=64)          # mha_qk's problem (B22)
SMALL_SV = dict(batch=8, m=32, n=64, k=32)       # mha_softmax_v's (B22)
LARGE = dict(batch=2, m=192, n=128, k=128)       # m*k > 128*128 (B21)

CASES = {
    "b22-qk-highest": BatchMatmulKey(**SMALL, beta0=True,
                                     precision="highest"),
    "b22-softmax-v-highest": BatchMatmulKey(**SMALL_SV, beta0=True,
                                            softmax_lhs=True,
                                            precision="highest"),
    "b22-softmax-v-bf16": BatchMatmulKey(**SMALL_SV, dtype="bf16",
                                         beta0=True, softmax_lhs=True),
    "b22-C-bf16": BatchMatmulKey(**SMALL, dtype="bf16"),
    "b22-lhs-shared-highest": BatchMatmulKey(**SMALL, beta0=True,
                                             lhs_shared=True,
                                             precision="highest"),
    "b21-highest-C": BatchMatmulKey(**LARGE, precision="highest"),
    "b21-softmax-highest-C": BatchMatmulKey(**LARGE, softmax_lhs=True,
                                            precision="highest"),
    "b21-softmax-bf16": BatchMatmulKey(**LARGE, dtype="bf16", beta0=True,
                                       softmax_lhs=True),
    "b21-lhs-shared-bf16-C": BatchMatmulKey(**LARGE, dtype="bf16",
                                            lhs_shared=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_batch_matmul_plain_matches_pallas_interpret(name):
    key = CASES[name]
    a, b, c = _inputs(key)
    tol = 1e-5 if key.precision == "highest" else 1e-2
    assert _err(_port(key, a, b, c), _jax(key, a, b, c)) <= tol


@pytest.mark.parametrize("fields", [
    dict(SMALL, beta0=True), dict(SMALL_SV, softmax_lhs=True),
    dict(LARGE, softmax_lhs=True, beta0=True), dict(LARGE, lhs_shared=True),
], ids=["b22-qk", "b22-softmax-C", "b21-softmax", "b21-lhs-shared-C"])
def test_f32_default_rounds_products_and_p_to_bf16(fields):
    key = BatchMatmulKey(**fields)
    a, b, c = _inputs(key)
    got = _port(key, a, b, c)
    # the JAX side on bf16-rounded operands, P rounded outside the kernel
    p = a
    if key.softmax_lhs:
        p = np.asarray(jax.nn.softmax(jnp.asarray(a), axis=-1))
    plain = dataclasses.replace(key, softmax_lhs=False)
    rounded = _jax(plain, _bf16(p), _bf16(b), c)
    assert _err(got, rounded) <= 1e-5
    assert _err(got, _jax(key, a, b, c)) <= 1e-2


def test_wrapper_takes_the_plain_version_on_cpu():
    key = CASES["b22-softmax-v-bf16"]
    a, b, c = (None if x is None else to_torch(x) for x in _inputs(key))
    kern = build_kernel(key)
    assert torch.equal(kern(a, b, c), reference_kernel(key)(a, b, c))
    assert kern.launches == 0


ROUTES = {
    # the MHA suite's two keys (f32 "default": bf16 products)
    "mha_qk": (BatchMatmulKey(1024, 32, 32, 64, beta0=True), "multi"),
    "mha_softmax_v": (BatchMatmulKey(1024, 32, 64, 32, beta0=True,
                                     softmax_lhs=True), "multi"),
    "bf16-small-C": (BatchMatmulKey(7, 64, 64, 64, "bf16"), "multi"),
    "bf16-lhs-shared": (BatchMatmulKey(9, 10, 16, 24, "bf16",
                                       lhs_shared=True), "multi"),
    "f32-highest-small": (BatchMatmulKey(1024, 32, 32, 64, beta0=True,
                                         precision="highest"), "tiled"),
    "m-over-64": (BatchMatmulKey(8, 65, 32, 32, "bf16"), "tiled"),
    "n-over-64": (BatchMatmulKey(8, 32, 72, 32, "bf16"), "tiled"),
    "k-over-64": (BatchMatmulKey(8, 32, 32, 72, "bf16"), "tiled"),
    "n-off-8": (BatchMatmulKey(8, 32, 36, 32, "bf16"), "tiled"),
    "k-off-8": (BatchMatmulKey(8, 32, 32, 20, "bf16"), "tiled"),
    "softmax-default-over-64": (BatchMatmulKey(5, 70, 90, 100, "f32",
                                               softmax_lhs=True), "tiled"),
    "softmax-bf16-k-over-64": (BatchMatmulKey(4, 32, 32, 96, "bf16",
                                              softmax_lhs=True), "tiled"),
    # chip_smoke's two large keys
    "lhs-shared-64x256x196x128": (BatchMatmulKey(
        64, 256, 196, 128, "bf16", beta0=True, lhs_shared=True), "tiled"),
    "C-16x256x256x512-highest": (BatchMatmulKey(
        16, 256, 256, 512, precision="highest"), "tiled"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_batch_matmul_route_table(name):
    # csrc/batch_matmul.cu's kernel by key (xsmm/reference.py
    # batch_matmul_route): "multi" for bf16 products with m, n, k <= 64
    # and k, n multiples of 8, else "tiled"
    from tpp_mlir_tpu_torch.xsmm.reference import batch_matmul_route
    key, want = ROUTES[name]
    assert batch_matmul_route(key) == want
