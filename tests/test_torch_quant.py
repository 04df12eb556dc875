"""The port's quantizers and weight carrier against the JAX package's:
int8 payloads and scales bit-identical on the same f32 (or bf16) input,
and params trees carried across bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.serving as J
from tpp_mlir_tpu.serving.quant import quantize_tokens as jax_quantize_tokens
import tpp_mlir_tpu_torch.serving as P

BASE = dict(vocab=96, embed=64, heads=4, layers=2, mlp_ratio=4, max_seq=24)


def to_numpy(tree):
    """A JAX params tree as numpy arrays, QTensors as (q, scale) pairs."""
    return jax.tree.map(np.asarray, tree)


def _same(t, a):
    """torch tensor t holds exactly the bits of numpy/JAX array a."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return t.dtype == torch.bfloat16 and np.array_equal(
            t.view(torch.int16).numpy(), a.view(np.int16))
    return np.array_equal(t.numpy(), a) and t.numpy().dtype == a.dtype


def test_quantize_bit_identical():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.3
    w[:, 5] = 0.0                       # a zero column takes scale 1
    w[3, 7] = 2.5 * np.abs(w[:, 7]).max()
    for axis in (-2, -1):
        jq = J.quantize(jnp.asarray(w), axis=axis)
        pq = P.quantize(torch.from_numpy(w), axis=axis)
        assert _same(pq.q, jq.q) and _same(pq.scale, jq.scale)
    # bf16 weights: both quantize the f32 upcast
    wb = jnp.asarray(w, jnp.bfloat16)
    jq = J.quantize(wb)
    pq = P.quantize(torch.from_numpy(np.array(wb).view(np.int16))
                    .view(torch.bfloat16))
    assert _same(pq.q, jq.q) and _same(pq.scale, jq.scale)


def test_quantize_tokens_bit_identical():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    x[0, 1, 2] = 0.0
    x[1, 0, 0] = np.float32(0.5)        # ties round half to even
    for axis in (-1, 2):
        jq, js = jax_quantize_tokens(jnp.asarray(x), axis=axis)
        pq, ps = P.quantize_tokens(torch.from_numpy(x), axis=axis)
        assert _same(pq, jq) and _same(ps, js)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_params_bit_identical(dtype):
    cfg = J.GptConfig(dtype=dtype, **BASE)
    jp = J.init_params(cfg, seed=0)
    pp = P.params_from_numpy(to_numpy(jp), P.GptConfig(dtype=dtype, **BASE),
                             device="cpu")
    jq = J.quantize_params(jp, include_embed=True)
    pq = P.quantize_params(pp, include_embed=True)
    for name in ("wte", "wpe", "lm_head"):
        assert _same(pq[name].q, jq[name].q)
        assert _same(pq[name].scale, jq[name].scale)
    for jb, pb in zip(jq["blocks"], pq["blocks"]):
        assert jb.keys() == pb.keys()
        for name, leaf in jb.items():
            if isinstance(leaf, J.QTensor):
                assert _same(pb[name].q, leaf.q), name
                assert _same(pb[name].scale, leaf.scale), name
            else:
                assert _same(pb[name], leaf), name
    assert P.quantized_bytes(pq) == J.quantized_bytes(jq)
    # and the quantized tree itself carries across bit for bit
    carried = P.params_from_numpy(to_numpy(jq), P.GptConfig(dtype=dtype,
                                                            **BASE),
                                  device="cpu")
    assert _same(carried["lm_head"].q, jq["lm_head"].q)
    assert _same(carried["blocks"][1]["w2"].scale, jq["blocks"][1]["w2"].scale)
    deq = P.dequantize_params(pq)
    assert torch.equal(deq["lm_head"],
                       torch.from_numpy(np.array(J.dequantize(
                           jq["lm_head"]))))


def test_int4_raises_naming_the_roadmap_item():
    params = P.init_params(P.GptConfig(**BASE), device="cpu")
    with pytest.raises(NotImplementedError, match="A7.*packed int4"):
        P.quantize_params(params, bits=4)
    with pytest.raises(NotImplementedError, match="A7"):
        P.quantize(torch.ones(4, 4), bits=4)


@pytest.mark.parametrize("dtype,stacked,bits_view", [
    ("f32", False, False), ("bf16", False, False), ("bf16", True, True),
], ids=["f32", "bf16", "bf16-stacked-uint16"])
def test_params_from_numpy_carries_jax_leaves_bit_for_bit(dtype, stacked,
                                                          bits_view):
    cfg = J.GptConfig.llama(kv_heads=2, dtype=dtype, **BASE)
    jp = J.init_params(cfg, seed=3)
    tree = to_numpy(J.stack_params(jp) if stacked else jp)
    if bits_view:       # bf16 as a uint16 bit view, as a loader gives it
        tree = jax.tree.map(lambda a: a.view(np.uint16), tree)
    pp = P.params_from_numpy(tree, P.GptConfig.llama(kv_heads=2, dtype=dtype,
                                                     **BASE), device="cpu")
    assert len(pp["blocks"]) == cfg.layers
    for name in ("wte", "lnf_g", "lm_head"):
        assert _same(pp[name], jp[name]), name
    for jb, pb in zip(jp["blocks"], pp["blocks"]):
        assert jb.keys() == pb.keys()
        assert all(_same(pb[k], jb[k]) for k in jb)


def test_params_from_numpy_refuses_inexact_bf16():
    tree = to_numpy(J.init_params(J.GptConfig(**BASE), seed=0))  # f32
    with pytest.raises(ValueError, match="bf16-exact"):
        P.params_from_numpy(tree, P.GptConfig(dtype="bf16", **BASE),
                            device="cpu")


def test_stack_params_loads_a_stacked_tree():
    pp = P.init_params(P.GptConfig(**BASE), seed=0, device="cpu")
    qp = P.quantize_params(pp)
    stacked = dict(qp)
    stacked["blocks"] = {
        k: (P.QTensor(torch.stack([b[k].q for b in qp["blocks"]]),
                      torch.stack([b[k].scale for b in qp["blocks"]]))
            if isinstance(v, P.QTensor)
            else torch.stack([b[k] for b in qp["blocks"]]))
        for k, v in qp["blocks"][0].items()}
    back = P.stack_params(stacked)
    assert P.stack_params(qp) is qp
    for b0, b1 in zip(qp["blocks"], back["blocks"]):
        assert torch.equal(b0["w1"].q, b1["w1"].q)
        assert torch.equal(b0["w1"].scale, b1["w1"].scale)
        assert torch.equal(b0["ln1_g"], b1["ln1_g"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_params_from_torch_matches_jax(dtype):
    from tpp_mlir_tpu.models.gpt import GptTorch

    torch.manual_seed(0)
    model = GptTorch(BASE["vocab"], BASE["embed"], BASE["heads"],
                     BASE["layers"], BASE["mlp_ratio"],
                     max_seq=BASE["max_seq"]).eval()
    jp = J.params_from_torch(model, J.GptConfig(dtype=dtype, **BASE))
    pp = P.params_from_torch(model, P.GptConfig(dtype=dtype, **BASE),
                             device="cpu")
    for name in ("wte", "wpe", "lnf_g", "lnf_b", "lm_head"):
        assert _same(pp[name], jp[name]), name
    for jb, pb in zip(jp["blocks"], pp["blocks"]):
        assert all(_same(pb[k], jb[k]) for k in jb)
