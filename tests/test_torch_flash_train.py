"""Training attention of the port (B14 forward + LSE, B18 backward) against
the JAX package, on the CPU.

The plain versions (tpp_mlir_tpu_torch/xsmm/reference.py, the oracles
csrc/flash_train.cu is held to on the card) against the Pallas kernels
`build_flash_train_fwd` / `build_flash_train_bwd` in interpret mode, and the
gradients of the port's `flash_attention_train` (an autograd Function whose
wrappers run the plain versions on CPU tensors) against `jax.grad` of the
JAX `flash_attention_train(..., interpret=True)`.

Error measure: max|port - jax| / max|jax|. Tolerances: 1e-5 for f32 operands
(the same f32 math, sum order only); 1e-2 for bf16 operands (P and dS are
rounded to bf16 on both sides, where a sum-order difference can flip a
rounding, and outputs are bf16).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpp_mlir_tpu.xsmm.flash_train import FlashTrainKey as JaxKey
from tpp_mlir_tpu.xsmm.flash_train import (build_flash_train_bwd,
                                           build_flash_train_fwd)
from tpp_mlir_tpu.xsmm.flash_train import \
    flash_attention_train as jax_flash_attention_train
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.xsmm import (FlashTrainBwdKey, FlashTrainKey,
                                     build_kernel, global_cache,
                                     reference_kernel)
from tpp_mlir_tpu_torch.xsmm.flash_train import flash_attention_train

TOL = {"f32": 1e-5, "bf16": 1e-2}
NP_DT = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def _err(port, ref):
    p = port.detach().float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _arr(rng, shape, dtype, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(
        NP_DT[dtype])


# (dtype, causal, head_dim, kv_heads): B 2, S 24, H 4
CASES = {
    "f32-causal-d16": ("f32", True, 16, 4),
    "f32-full-d32": ("f32", False, 32, 4),
    "bf16-causal-d32": ("bf16", True, 32, 4),
    "bf16-full-d16": ("bf16", False, 16, 4),
    "f32-causal-d32-gqa": ("f32", True, 32, 2),
    "bf16-causal-d16-gqa": ("bf16", True, 16, 1),
}
B, S, H = 2, 24, 4


def _t(x):          # (B, S, H, D) <-> (B, H, S, D)
    return np.ascontiguousarray(np.swapaxes(np.asarray(x), 1, 2))


@pytest.mark.parametrize("name", [n for n in CASES if "gqa" not in n])
def test_plain_forward_matches_jax_kernel(name):
    dt, causal, D, _ = CASES[name]
    rng = np.random.default_rng(0)
    q, k, v = (_arr(rng, (B, S, H, D), dt) for _ in range(3))
    scale = D ** -0.5
    jo, jl = build_flash_train_fwd(JaxKey(B, H, S, D, dt, causal, scale),
                                   True)(*(jnp.asarray(_t(x))
                                           for x in (q, k, v)))
    o, lse2 = reference_kernel(FlashTrainKey(B, H, S, D, dt, causal, scale))(
        *map(to_torch, (q, k, v)))
    assert o.shape == (B, S, H, D) and lse2.shape == (B, H, S)
    assert o.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)
    assert _err(o, _t(jo)) <= TOL[dt]
    # lse2 is f32 on both sides whatever the operand dtype: sum order only
    assert _err(lse2, np.asarray(jl)[..., 0]) <= 1e-5


@pytest.mark.parametrize("name", [n for n in CASES if "gqa" not in n])
def test_plain_backward_matches_jax_kernel(name):
    dt, causal, D, _ = CASES[name]
    rng = np.random.default_rng(1)
    q, k, v, do = (_arr(rng, (B, S, H, D), dt) for _ in range(4))
    scale = D ** -0.5
    jkey = JaxKey(B, H, S, D, dt, causal, scale)
    jq, jk, jv, jdo = (jnp.asarray(_t(x)) for x in (q, k, v, do))
    jo, jl = build_flash_train_fwd(jkey, True)(jq, jk, jv)
    delta = jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), -1,
                    keepdims=True)
    want = build_flash_train_bwd(jkey, True)(jq, jk, jv, jdo, jl, delta)
    got = reference_kernel(FlashTrainBwdKey(B, H, S, D, dt, causal, scale))(
        *map(to_torch, (q, k, v, do)), to_torch(np.array(jl)[..., 0]),
        to_torch(np.array(delta)[..., 0]))
    for g, w in zip(got, want):
        assert _err(g, _t(w)) <= TOL[dt]


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax_grad(name):
    dt, causal, D, kvh = CASES[name]
    rng = np.random.default_rng(2)
    q = _arr(rng, (B, S, H, D), dt)
    k, v = (_arr(rng, (B, S, kvh, D), dt) for _ in range(2))
    w = rng.standard_normal((B, S, H, D)).astype(np.float32)
    scale = D ** -0.5

    def jloss(q, k, v):
        o = jax_flash_attention_train(q, k, v, scale, causal, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w)
    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (to_torch(x).requires_grad_(True) for x in (q, k, v))
    o = flash_attention_train(tq, tk, tv, scale, causal)
    loss = (o.float() * torch.from_numpy(w)).sum()
    loss.backward()
    assert abs(loss.item() - float(jl)) <= TOL[dt] * max(abs(float(jl)), 1)
    for g, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert g.dtype == tq.dtype
        assert _err(g, want) <= TOL[dt]


def test_cpu_tensors_take_the_plain_versions():
    key = FlashTrainKey(1, 2, 16, 32, "f32")
    rng = np.random.default_rng(3)
    q, k, v = (to_torch(_arr(rng, (1, 16, 2, 32), "f32")) for _ in range(3))
    kern = build_kernel(key)
    got, want = kern(q, k, v), reference_kernel(key)(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kern.launches == 0
    # the op goes through the cache's wrappers, which launch nothing here
    global_cache().reset_launches()
    flash_attention_train(q.requires_grad_(True), k, v, 0.2).sum().backward()
    counts = global_cache().launches_by_kind()
    assert counts.get("FlashTrainKey", 0) == counts.get(
        "FlashTrainBwdKey", 0) == 0


def test_flash_train_key_rejects_f16():
    with pytest.raises(NotImplementedError, match="A14"):
        reference_kernel(FlashTrainKey(1, 2, 16, 32, "f16"))
