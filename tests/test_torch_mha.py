"""The MHA suite on the port against the JAX package, on the CPU.

Flat-layout attention (tpp_mlir_tpu_torch/xsmm/reference.py, the oracle
csrc/attention.cu is held to on the card) against the Pallas kernels in
interpret mode: B6 (the blocked form, forced by bq/bk), B8 (qblock), B9
(grouped, and auto at these sizes), B10a (twocall), B10b (twocall2), and
B11's warm bench at repeats 1-3; the strategy routing table, row by row;
every builder of models/mha.py through both packages' pipelines and
run_module; the seeded constants of the suite.

Error measure: max|port - jax| / max|jax|. Tolerances: f32 "highest" 1e-5
(the same math; the port divides by the row sum after P.V as B6/B8/B9/B11
do, sum order only); bf16 1e-2 (both sides round the scaled Q and P to
bf16, where a sum-order difference can flip a rounding). B11 at bf16 also
1e-2: the port and the TPU kernel both round P and the fed-back output to
bf16 (they differ only for f32 "default", where the TPU rounds P to the
key's dtype and the port to bf16, its f32 "default" rule). run_module: modules at
precision "highest" 1e-5, bf16 modules 1e-2.
"""

import dataclasses
import io
import json
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu.models import mha as jax_mha
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.runtime.tensor_init import tensor_init as jax_tensor_init
from tpp_mlir_tpu.tools.tpp_run import init_args as jax_init_args
from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch.models import mha
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime.executor import _eval_constant
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.tools import bench_driver
from tpp_mlir_tpu_torch.tools.tpp_run import init_args, run_module
from tpp_mlir_tpu_torch.xsmm import (FlashMhaKey, build_kernel,
                                     reference_kernel)
from tpp_mlir_tpu_torch.xsmm.reference import attention_route

ROOT = Path(__file__).resolve().parents[1]


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _arr(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bf16" else a


def _tol(key):
    return 1e-5 if key.precision == "highest" else 1e-2


def _against_jax(key, seed=7):
    """(port plain version, JAX interpret-mode kernel) on the same seeded
    operands: (B*H, S, D) flat, (B, S, H*D) token, or the packed operand."""
    rng = np.random.default_rng(seed)
    if key.heads:
        E = key.heads * key.head_dim
        if key.qkv_packed:
            args = [_arr(rng, (key.batch, key.seq, 3 * E), key.dtype)] * 3
        else:
            args = [_arr(rng, (key.batch, s, E), key.dtype)
                    for s in (key.seq, key.seq_kv, key.seq_kv)]
    else:
        args = [_arr(rng, (key.batch, s, key.head_dim), key.dtype)
                for s in (key.seq, key.seq_kv, key.seq_kv)]
    ref_key = ref_flags.FlashMhaKey(**dataclasses.asdict(key))
    want = jax_build_kernel(ref_key, interpret=True)(*map(jnp.asarray, args))
    got = reference_kernel(key)(*map(to_torch, args))
    return got, want


def _flat(dtype, **kw):
    prec = "highest" if dtype == "f32" else "default"
    base = dict(batch=4, seq=128, seq_kv=128, head_dim=32, dtype=dtype,
                scale=32 ** -0.5, precision=prec)
    return FlashMhaKey(**{**base, **kw})


def _flat_cases():
    out = {}
    for dt in ("f32", "bf16"):
        for causal in (False, True):
            c = "causal" if causal else "full"
            out[f"auto-{dt}-{c}"] = _flat(dt, causal=causal)
            out[f"b6-{dt}-{c}"] = _flat(dt, causal=causal, bq=64, bk=64)
            out[f"grouped-{dt}-{c}"] = _flat(dt, causal=causal,
                                             strategy="grouped")
            out[f"qblock-{dt}-{c}"] = _flat(dt, causal=causal, seq=256,
                                            seq_kv=256, strategy="qblock")
        for strategy in ("twocall", "twocall2"):
            out[f"{strategy}-{dt}-causal"] = _flat(
                dt, causal=True, seq=256, seq_kv=256, strategy=strategy)
    # causal with S != S_kv: both mask rows >= cols, aligned top-left (the
    # reference's grouped kernel blocks K/V with S rows, so qblock and B6)
    out["qblock-f32-causal-s128-kv256"] = _flat("f32", causal=True,
                                                seq_kv=256,
                                                strategy="qblock")
    out["b6-bf16-causal-s256-kv128"] = _flat("bf16", causal=True, seq=256,
                                             bq=64, bk=64)
    return out


FLAT = _flat_cases()


@pytest.mark.parametrize("name", list(FLAT))
def test_flat_plain_matches_pallas_interpret(name):
    key = FLAT[name]
    got, want = _against_jax(key)
    assert _err(got, want) <= _tol(key)


BENCH = {
    **{f"flat-{dt}-r{r}": _flat(dt, repeats=r)
       for dt in ("f32", "bf16") for r in (1, 2, 3)},
    "flat-bf16-causal-r2": _flat("bf16", causal=True, repeats=2),
    # the token layout: the reference splits heads into the flat bench
    "tokens-bf16-causal-r2": FlashMhaKey(2, 128, 128, 32, "bf16",
                                         scale=32 ** -0.5, causal=True,
                                         heads=2, repeats=2),
    "tokens-f32-packed-r3": FlashMhaKey(2, 128, 128, 32, "f32",
                                        scale=32 ** -0.5, heads=2,
                                        precision="highest", repeats=3,
                                        qkv_packed=True),
}


@pytest.mark.parametrize("name", list(BENCH))
def test_warm_bench_plain_matches_pallas_interpret(name):
    key = BENCH[name]
    got, want = _against_jax(key)
    assert _err(got, want) <= _tol(key)


def _token(**kw):
    base = dict(batch=2, seq=128, seq_kv=128, head_dim=32, dtype="bf16",
                scale=32 ** -0.5, heads=2)
    return FlashMhaKey(**{**base, **kw})


# the routing table: (key, what runs, or the error it raises)
ROUTES = {
    **{f"flat-{s}": (_flat("bf16", causal=True, strategy=s), "kernel")
       for s in ("auto", "grouped", "qblock", "twocall", "twocall2")},
    **{f"flat-{s}-repeats": (_flat("bf16", causal=True, strategy=s,
                                   repeats=2), "bench")
       for s in ("auto", "grouped", "qblock", "twocall", "twocall2")},
    "flat-b6-blocks": (_flat("bf16", bq=64, bk=32), "kernel"),
    "flat-twocall-not-causal": (_flat("bf16", strategy="twocall"),
                                (ValueError, "twocall causal attention "
                                 "does not apply")),
    "flat-twocall2-s-ne-skv": (_flat("bf16", causal=True, seq_kv=256,
                                     strategy="twocall2"),
                               (ValueError, "twocall2 causal attention "
                                "does not apply")),
    "flat-twocall-odd-s": (_flat("bf16", causal=True, seq=127, seq_kv=127,
                                 strategy="twocall"),
                           (ValueError, "does not apply")),
    "flat-bq-not-dividing": (_flat("bf16", bq=48),
                             (ValueError, "bq override 48 must divide")),
    "flat-bk-not-dividing": (_flat("bf16", bk=100),
                             (ValueError, "bk override 100 must divide")),
    **{f"flat-{s}": (_flat("bf16", strategy=s),
                     (NotImplementedError, "ADVICE.md #2"))
       for s in ("tokens", "xla", "flash_heads")},
    "flat-unknown": (_flat("bf16", strategy="fast"),
                     (ValueError, "unknown attention strategy")),
    "tokens-auto": (_token(), "kernel"),
    "tokens-tokens": (_token(strategy="tokens"), "kernel"),
    "tokens-auto-repeats": (_token(repeats=3), "bench"),
    "tokens-packed-repeats": (_token(qkv_packed=True, repeats=2), "bench"),
    "tokens-flash-heads": (_token(strategy="flash_heads", causal=True),
                           "flash_heads"),
    "tokens-flash-heads-packed": (_token(strategy="flash_heads",
                                         causal=True, qkv_packed=True),
                                  "flash_heads"),
    "tokens-flash-heads-not-causal": (_token(strategy="flash_heads"),
                                      (NotImplementedError, "ADVICE.md")),
    "tokens-flash-heads-highest": (_token(strategy="flash_heads",
                                          causal=True, dtype="f32",
                                          precision="highest"),
                                   (NotImplementedError, "ADVICE.md")),
    "tokens-flash-heads-repeats": (_token(strategy="flash_heads",
                                          causal=True, repeats=2),
                                   (NotImplementedError, "ADVICE.md")),
    "tokens-xla": (_token(strategy="xla"), "xla"),
    "tokens-xla-repeats": (_token(strategy="xla", repeats=2),
                           (NotImplementedError, "ADVICE.md")),
    **{f"tokens-{s}": (_token(strategy=s, causal=True),
                       (NotImplementedError, "ADVICE.md #2"))
       for s in ("grouped", "qblock", "twocall", "twocall2")},
    "flat-packed": (_flat("bf16", qkv_packed=True),
                    (ValueError, "qkv_packed needs the token layout")),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_strategy_routing_table(name):
    key, want = ROUTES[name]
    if isinstance(want, str):
        assert attention_route(key) == want
        build_kernel(key)           # the wrapper builds for every route
        return
    err, match = want
    with pytest.raises(err, match=match):
        attention_route(key)
    with pytest.raises(err, match=match):
        build_kernel(key)


@pytest.mark.parametrize("key", [
    _token(strategy="flash_heads", causal=True, seq=256, seq_kv=256),
    _token(strategy="flash_heads", causal=True, dtype="f32",
           qkv_packed=True),
    _token(strategy="xla", causal=True),
    _token(strategy="xla", dtype="f32", precision="highest"),
], ids=["flash-heads-bf16", "flash-heads-f32-packed", "xla-bf16-causal",
        "xla-f32-highest"])
def test_token_strategies_match_the_reference_kernels(key):
    """flash_heads against the JAX B14 route, xla against the JAX composed
    route. f32 flash_heads is at "default", where B14 and its JAX
    counterpart both run in f32: 1e-5."""
    got, want = _against_jax(key)
    assert _err(got, want) <= (1e-5 if key.dtype == "f32" else 2e-2)


def test_kernel_wrappers_take_the_plain_versions_on_cpu():
    for key in (FLAT["twocall-bf16-causal"], BENCH["flat-bf16-r2"],
                ROUTES["tokens-xla"][0]):
        x = to_torch(_arr(np.random.default_rng(1),
                          (key.batch, key.seq, key.head_dim * (key.heads
                                                               or 1)),
                          key.dtype))
        kern = build_kernel(key)
        assert torch.equal(kern(x, x, x), reference_kernel(key)(x, x, x))
        assert kern.launches == 0


# every builder of models/mha.py at a small size: (builder, kwargs)
BUILDERS = {
    "qk": ("build_qk", dict(batch=2, heads=2, seq=32, head_dim=64)),
    "softmax_v": ("build_softmax_v", dict(batch=2, heads=2, seq=32,
                                          head_dim=64)),
    "projection": ("build_projection", dict(batch=2, seq=32, model_dim=64)),
    "mha_full": ("build_mha", dict(batch=1, heads=4, seq=128, head_dim=32,
                                   scale=0.25)),
    "mha_fused_causal": ("build_mha", dict(batch=1, heads=4, seq=128,
                                           head_dim=32, causal=True,
                                           scale=0.125)),
    "mha_fused_bf16": ("build_mha", dict(batch=1, heads=4, seq=128,
                                         head_dim=32, fused=True,
                                         dtype="bf16", scale=0.125)),
    "mha_block": ("build_mha_block", dict(batch=2, heads=2, seq=32,
                                          head_dim=32)),
}


def _build(name, ref=False):
    fn, kw = BUILDERS[name]
    m = getattr(jax_mha if ref else mha, fn)(**kw)
    if kw.get("dtype", "f32") == "f32":
        m.attrs["precision"] = "highest"
    return m


def _dispatches(module):
    """Each dispatch op's name and attributes, tile hints left out (the port
    writes Hopper tiles, the reference TPU blocks)."""
    return [(op.opname, {k: v for k, v in op.attrs.items()
                         if not k.startswith("tile_")})
            for op in module["entry"].ops if op.opname.endswith("_dispatch")]


@pytest.mark.parametrize("name", list(BUILDERS))
def test_mha_builders_lower_and_run_as_the_reference(name):
    port, ref = _build(name), _build(name, ref=True)
    assert str(port) == str(ref)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    assert _dispatches(port) == _dispatches(ref)
    got = run_module(_build(name), seed=2, device="cpu",
                     out_stream=io.StringIO())["outputs"][0]
    want = jax_run_module(_build(name, ref=True), seed=2,
                          out_stream=io.StringIO())["outputs"][0]
    tol = 1e-5 if port.attrs.get("precision") == "highest" else 1e-2
    assert _err(got, want) <= tol


def test_mha_lowerings_hold_the_suite_kernels():
    """attention-fusion forms one flat xsmm.attention from the unfused
    chain; Q.K^T is a transpose and a batch GEMM; softmax.V one batch GEMM
    with softmax_lhs; all accumulators fold into beta_0."""
    def ops(name):
        m = _build(name)
        run_pipeline(m, "default-tpp-passes")
        return _dispatches(m)
    full = ops("mha_full")
    assert [o for o, _ in full] == ["xsmm.attention_dispatch"]
    assert full[0][1]["scale"] == 0.25 and "heads" not in full[0][1]
    qk = ops("qk")
    assert [o for o, _ in qk] == ["xsmm.unary_dispatch",
                                  "xsmm.batch_gemm_dispatch"]
    assert qk[0][1]["kind"] == "transpose" and \
        qk[1][1]["flags"] == ("beta_0",)
    (op, attrs), = ops("softmax_v")
    assert op == "xsmm.batch_gemm_dispatch" and attrs["softmax_lhs"]


def test_unabsorbed_softmax_names_a3():
    from tpp_mlir_tpu_torch.ir import Function, Module, TensorType, TppBuilder
    m = Module()
    t = TensorType((2, 8, 8), "f32")
    f = m.add(Function("entry", [t], ["x"]))
    f.returns = [TppBuilder(f).softmax(f.args[0], axis=2)]
    m.verify()
    with pytest.raises(NotImplementedError, match="queue A3"):
        run_pipeline(m, "default-tpp-passes")


@pytest.mark.parametrize("name", ["mha_block", "mha_full", "qk"])
def test_seeded_constants_and_args_equal_the_reference(name):
    """The suite's weights are tl.constant tensors made from seeds and its
    inputs init_args' seeded tensors: element for element the JAX
    package's."""
    port, ref = _build(name), _build(name, ref=True)
    consts = [op for op in port["entry"].ops if op.opname == "tl.constant"]
    for op in consts:
        a = op.attrs
        want = jax_tensor_init(a.get("init", "zero"),
                               a.get("orig_shape", op.result.type.shape),
                               op.result.type.dtype, a.get("seed", 0),
                               a.get("value", 1.0))
        got = _eval_constant(op, "cpu")
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    for got, want in zip(init_args(port, "entry", "normal", 4, "cpu"),
                         jax_init_args(ref, "entry", "normal", 4)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_chip_smoke_runs_the_mha_suite_as_configured():
    """chip_smoke.py's MHA entries are mha.json's thirteen rows of the
    flat attention, the batched matmul, the projection and the MHA block,
    with their own sizes and bench_mode."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = json.loads((ROOT / "benchmarks/configs/mha.json").read_text())
    want = [{k: e[k] for k in ("name", "model", "bench_mode") if k in e}
            for e in cfg["benchmarks"]
            if e.get("model", "").split(":")[0] in
            ("mha_qk", "mha_softmax_v", "mha_projection", "mha_block",
             "mha_full")]
    assert len(want) == 13
    assert [dict(e) for e in smoke.MHA_SUITE] == want


def test_bench_driver_honours_bench_mode_on_cpu():
    entry = {"model": 'mha_full:{"batch": 1, "heads": 2, "seq": 128, '
                      '"head_dim": 32, "fused": true}', "bench_mode": "scan"}
    res = bench_driver.run_entry(entry, n=2, device="cpu",
                                 out_stream=io.StringIO())
    assert res["lowered"]["bench"] == "loop"
    got = res["lowered"]["outputs"][0]
    want = res["baseline"]["outputs"][0]
    assert _err(got, want.numpy()) <= 3e-2
    with pytest.raises(ValueError, match="bench_mode"):
        bench_driver.run_entry({**entry, "bench_mode": "warm"}, n=2,
                               device="cpu", out_stream=io.StringIO())
