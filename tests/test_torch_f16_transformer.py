"""f16 keys (ROADMAP A14 items 1, 2, 3 and 5) on the transformer family:
B2's LayerNorm prologue and LN-stats pair (BrgemmKey), B12 (LayerNormKey),
attention (FlashMhaKey: B6, B8, B9, B10a, B10b, B11 and B7) and the MHA
suite's batched matmul (BatchMatmulKey: B21/B22).

On the CPU the port runs the kernels' plain versions; each is held here to
the JAX package on the same seeded numpy inputs cast to float16, the JAX
side through `build_kernel(key, interpret=True)` (its Pallas bodies) or its
own `run_module`. Error measure: max|port - jax| / max|jax|. Tolerances:
  * one kernel: 2e-3, tests/xsmm/test_kernels.py:677's f16 rtol (f16
    operands, f32 sums in another order, the f16 roundings of a normalized
    row, of attention's scaled Q and P or of a softmax_lhs P at other
    places, one rounding of the output; measured up to 6.4e-4);
  * the LN-stats pair's statistics: 1e-4 (f32 sums of the same f16
    outputs);
  * GPT, the encoder block and the MHA suite's f16 rows through both
    executors, lowered and --linalg-to-loops: 1e-2 (a model's roundings
    add up; mha_block at seq 32 reads 5.6e-3).
The route test holds what the card would run: no f16 key's launch passes a
loader, route or product code that rounds to bf16 (the launch arguments
read from a recording stand-in for the kernel library, since the CPU has
none). The card's own check that the products are f16 (A = 1 + 2^-10) is
tests/test_torch_cuda.py's test_f16_products_are_not_bf16.
"""

import dataclasses
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu.models.gpt import build_gpt as jax_build_gpt
from tpp_mlir_tpu.models.transformer_block import \
    build_transformer_block as jax_build_block
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.tools import bench_driver as jax_bench_driver
from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch.models.gpt import build_gpt
from tpp_mlir_tpu_torch.models.transformer_block import \
    build_transformer_block
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.tools import bench_driver
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BrgemmKey, FlashMhaKey,
                                     LayerNormKey, build_kernel)
from tpp_mlir_tpu_torch.xsmm import build as kbuild
from tpp_mlir_tpu_torch.xsmm import kernels, reference

F16 = torch.float16
TOL_KERNEL, TOL_STATS, TOL_MODEL = 2e-3, 1e-4, 1e-2


def _f16(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float16)


def _err(got, want) -> float:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def _ref_key(key):
    return getattr(ref_flags, type(key).__name__)(**dataclasses.asdict(key))


def _jax(key, *args, **kw):
    return jax_build_kernel(_ref_key(key), interpret=True)(
        *(None if a is None else jnp.asarray(a) for a in args),
        **{k: jnp.asarray(v) for k, v in kw.items()})


def _port(key, *args, **kw):
    kern = build_kernel(key)
    out = kern(*(None if a is None else to_torch(a) for a in args),
               **{k: to_torch(np.asarray(v)) for k, v in kw.items()})
    assert kern.launches == 0
    return out


# ---- one kernel at a time, against the Pallas bodies in interpret mode --

LN = dict(beta0=True, binary_kind="add", prologue="layer_norm")
B2 = {
    "qkv-bias": BrgemmKey(1, 64, 192, 128, "f16", **LN),
    "fc1-bias-gelu": BrgemmKey(1, 64, 256, 96, "f16", unary_kind="gelu",
                               **LN),
    "no-affine-f32-out": BrgemmKey(1, 48, 128, 64, "f16", out_dtype="f32",
                                   prologue_affine=False, **LN),
    "ragged-k-eps": BrgemmKey(1, 40, 64, 100, "f16", prologue_eps=1e-6,
                              **LN),
}


@pytest.mark.parametrize("name", list(B2))
def test_b2_layer_norm_prologue_matches_pallas_interpret(name):
    key = B2[name]
    rng = np.random.default_rng(1)
    a = _f16(rng, (1, key.m, key.k), 3.0, 0.5)
    b = _f16(rng, (1, key.k, key.n), key.k ** -0.5)
    d = _f16(rng, (key.n,))
    kw = dict(gamma=_f16(rng, (key.k,)), beta=_f16(rng, (key.k,))) \
        if key.prologue_affine else {}
    got = _port(key, a, b, None, d, **kw)
    want = _jax(key, a, b, None, d, **kw)
    assert got.dtype == reference.DTYPES[key.out_dtype or "f16"]
    assert _err(got, want) <= TOL_KERNEL


def _pair_keys():
    # m 1024: the JAX pair is its weights-resident kernel, which takes two
    # m blocks or more (tests/xsmm/test_kernels.py test_wres_ln_stats_pair)
    common = dict(batch=1, m=1024, n=128, k=128, dtype="f16", beta0=True,
                  binary_kind="add")
    return (BrgemmKey(**common, unary_kind="relu", ln_stats_out=True),
            BrgemmKey(**common, unary_kind="gelu", prologue="ln_stats"))


def test_b2_ln_stats_pair_matches_pallas_interpret():
    """The producer's (y, mean, var) and the consumer fed the JAX
    producer's y, mean and var, each against the Pallas bodies."""
    kp, kc = _pair_keys()
    rng = np.random.default_rng(2)
    a = _f16(rng, (1, 1024, 128), 0.5)
    w0, w1 = _f16(rng, (1, 128, 128), 0.1), _f16(rng, (1, 128, 128), 0.1)
    d0, d1 = _f16(rng, (128,), 0.1), _f16(rng, (128,), 0.1)
    g, be = _f16(rng, (128,), 0.2, 1.0), _f16(rng, (128,), 0.1)
    jy, jmu, jvar = _jax(kp, a, w0, None, d0)
    y, mu, var = _port(kp, a, w0, None, d0)
    assert y.dtype == F16 and mu.dtype == var.dtype == torch.float32
    assert _err(y, jy) <= TOL_KERNEL
    assert _err(mu, jmu) <= TOL_STATS and _err(var, jvar) <= TOL_STATS
    yj = np.asarray(jy).reshape(1, 1024, 128)
    want = _jax(kc, yj, w1, None, d1, gamma=g, beta=be, mu=jmu, var=jvar)
    got = _port(kc, yj, w1, None, d1, g, be, np.asarray(jmu),
                np.asarray(jvar))
    assert got.dtype == F16
    assert _err(got, want) <= TOL_KERNEL


B12 = {
    "gpt-ln-f": LayerNormKey(48, 768, "f16"),
    "no-affine": LayerNormKey(32, 256, "f16", affine=False),
    "f32-out-ragged": LayerNormKey(16, 100, "f16", out_dtype="f32"),
}


@pytest.mark.parametrize("name", list(B12))
def test_b12_matches_pallas_interpret(name):
    key = B12[name]
    rng = np.random.default_rng(3)
    x = _f16(rng, (key.m, key.n), 3.0, 1.0)
    g, be = _f16(rng, (key.n,)), _f16(rng, (key.n,))
    got = _port(key, x, g, be)
    want = _jax(key, x, g, be)
    assert got.dtype == reference.DTYPES[key.out_dtype or "f16"]
    assert _err(got, want) <= TOL_KERNEL


def _flat(**kw):
    base = dict(batch=4, seq=128, seq_kv=128, head_dim=64, dtype="f16",
                scale=0.125)
    return FlashMhaKey(**{**base, **kw})


ATTENTION = {
    "b6-blocked": _flat(bq=64, bk=64),
    "b6-auto-causal": _flat(causal=True),
    "b8-qblock": _flat(seq=256, seq_kv=256, strategy="qblock"),
    "b9-grouped-causal": _flat(causal=True, strategy="grouped"),
    "b10a-twocall": _flat(seq=256, seq_kv=256, causal=True,
                          strategy="twocall"),
    "b10b-twocall2": _flat(seq=256, seq_kv=256, causal=True,
                           strategy="twocall2"),
    "b11-repeats-3": _flat(repeats=3),
    "b11-tokens-causal-repeats-2": FlashMhaKey(
        2, 128, 128, 32, "f16", scale=32 ** -0.5, causal=True, heads=2,
        repeats=2),
    "b7-packed-causal": FlashMhaKey(2, 128, 128, 32, "f16",
                                    scale=32 ** -0.5, causal=True, heads=4,
                                    qkv_packed=True),
    "b7-split-f32-out": FlashMhaKey(2, 96, 160, 64, "f16", out_dtype="f32",
                                    scale=0.125, heads=2),
}


@pytest.mark.parametrize("name", list(ATTENTION))
def test_attention_matches_pallas_interpret(name):
    key = ATTENTION[name]
    rng = np.random.default_rng(4)
    E = (key.heads or 1) * key.head_dim
    if key.qkv_packed:
        args = [_f16(rng, (key.batch, key.seq, 3 * E))] * 3
    else:
        args = [_f16(rng, (key.batch, s, E))
                for s in (key.seq, key.seq_kv, key.seq_kv)]
    got = _port(key, *args)
    want = _jax(key, *args)
    assert got.dtype == reference.DTYPES[key.out_dtype or "f16"]
    assert _err(got, want) <= TOL_KERNEL


BMM = {
    "b22-mha-qk": BatchMatmulKey(8, 32, 32, 64, "f16", beta0=True),
    "b22-softmax-v": BatchMatmulKey(8, 32, 64, 32, "f16", beta0=True,
                                    softmax_lhs=True),
    "b21-softmax-c": BatchMatmulKey(2, 192, 128, 128, "f16",
                                    softmax_lhs=True),
    "b21-lhs-shared-c": BatchMatmulKey(3, 96, 64, 80, "f16",
                                       lhs_shared=True),
    "b22-f32-out": BatchMatmulKey(8, 32, 32, 64, "f16", out_dtype="f32",
                                  beta0=True),
}


@pytest.mark.parametrize("name", list(BMM))
def test_batch_matmul_matches_pallas_interpret(name):
    key = BMM[name]
    rng = np.random.default_rng(5)
    a = _f16(rng, (key.m, key.k) if key.lhs_shared
             else (key.batch, key.m, key.k), 2.0)
    b = _f16(rng, (key.batch, key.k, key.n))
    c = None if key.beta0 else rng.standard_normal(
        (key.batch, key.m, key.n)).astype(np.float32)
    got = _port(key, a, b, c)
    want = _jax(key, a, b) if c is None else _jax(key, a, b, c)
    assert got.dtype == reference.DTYPES[key.out_dtype or "f16"]
    assert _err(got, want) <= TOL_KERNEL


# ---- the models: lowered IR and both executors against the JAX package --

def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


MODELS = {
    "gpt": (build_gpt, jax_build_gpt,
            dict(batch=2, seq=64, vocab=256, embed=128, heads=2, layers=2,
                 dtype="f16")),
    "encoder": (build_transformer_block, jax_build_block,
                dict(batch=2, seq=64, embed=128, heads=2, dtype="f16")),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_f16_models_lower_like_the_jax_package(name):
    build, jax_build, kw = MODELS[name]
    port, ref = build(**kw), jax_build(**kw)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    for key, arr in ref.literals.items():
        assert (port.literals[key] == arr).all()
    invokes = {op.opname for op in port["entry"].ops
               if op.opname.startswith("xsmm.")
               and not op.opname.endswith("_dispatch")}
    assert "xsmm.attention" in invokes and "xsmm.fused_brgemm" in invokes
    prologues = [op.attrs.get("prologue") for op in port["entry"].ops
                 if op.opname == "xsmm.fused_brgemm_dispatch"]
    assert "layer_norm" in prologues


@pytest.mark.parametrize("l2l", [False, True], ids=["lowered", "l2l"])
@pytest.mark.parametrize("name", list(MODELS))
def test_f16_models_run_like_the_jax_package(name, l2l):
    build, jax_build, kw = MODELS[name]
    want = jax_run_module(jax_build(**kw), seed=1,
                          out_stream=io.StringIO())["outputs"][0]
    got = run_module(build(**kw), seed=1, device="cpu", linalg_to_loops=l2l,
                     out_stream=io.StringIO())["outputs"][0]
    assert got.dtype == F16 and str(np.asarray(want).dtype) == "float16"
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= TOL_MODEL


# the MHA suite's builders at "dtype": "f16", at small sizes
MHA = {
    "mha_qk": 'mha_qk:{"batch": 2, "heads": 2, "seq": 32, "head_dim": 64, '
              '"dtype": "f16"}',
    "mha_softmax_v": 'mha_softmax_v:{"batch": 2, "heads": 2, "seq": 32, '
                     '"head_dim": 64, "dtype": "f16"}',
    "mha_block": 'mha_block:{"batch": 2, "heads": 2, "seq": 32, '
                 '"head_dim": 32, "dtype": "f16"}',
    "mha_full_fused": 'mha_full:{"batch": 1, "heads": 4, "seq": 128, '
                      '"head_dim": 32, "fused": true, "dtype": "f16", '
                      '"scale": 0.125}',
    "mha_full_causal": 'mha_full:{"batch": 1, "heads": 4, "seq": 128, '
                       '"head_dim": 32, "causal": true, "dtype": "f16", '
                       '"scale": 0.125}',
}


@pytest.mark.parametrize("name", list(MHA))
def test_f16_mha_rows_run_like_the_jax_driver(name):
    entry = {"model": MHA[name]}
    port, ref = bench_driver.build_module(entry), \
        jax_bench_driver.build_module(entry)
    assert str(port) == str(ref)
    got = run_module(port, seed=2, device="cpu",
                     out_stream=io.StringIO())["outputs"][0]
    want = jax_run_module(ref, seed=2,
                          out_stream=io.StringIO())["outputs"][0]
    assert got.dtype == F16
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= TOL_MODEL


# ---- routes and launch arguments ----------------------------------------

class _Recorder:
    """A stand-in for the kernel library: records each C entry's
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


# each f16 key, the route its launcher takes, and the place of the operand
# dtype, product code and route code in its C entry's arguments
# (xsmm/build.py): the product code 2 (f16) and the f16 route codes, never
# bf16's (1, the convert loader's rounding; attention's loaders 0 and 2)
ROUTED = {
    "b2-tma": (BrgemmKey(1, 64, 128, 64, "f16", **LN), "tma"),
    "b2-convert": (BrgemmKey(1, 64, 128, 60, "f16", **LN), "convert"),
    "b2-ln-stats": (BrgemmKey(1, 64, 128, 64, "f16", beta0=True,
                              prologue="ln_stats"), "tma"),
    "b2-stats-out": (BrgemmKey(1, 64, 128, 64, "f16", beta0=True,
                               ln_stats_out=True), "tma"),
    "b12-register": (LayerNormKey(16, 768, "f16"), "register"),
    "b12-strided": (LayerNormKey(16, 100, "f16"), "strided"),
    "attn-flat": (_flat(), "tma"),
    "attn-packed": (ATTENTION["b7-packed-causal"], "tma"),
    "attn-bench": (_flat(repeats=3), "tma"),
    "bmm-multi": (BMM["b22-softmax-v"], "multi"),
    "bmm-tiled": (BMM["b21-softmax-c"], "tiled"),
}


def _inputs(key):
    def t(*shape, dt=F16):
        return torch.zeros(shape, dtype=dt)
    if isinstance(key, BrgemmKey):
        args = [t(1, key.m, key.k), t(1, key.k, key.n), None,
                t(key.n) if key.binary_kind else None]
        if key.prologue:
            args += [t(key.k), t(key.k)]
        if key.prologue == "ln_stats":
            args += [t(key.m, 1, dt=torch.float32)] * 2
        return args
    if isinstance(key, LayerNormKey):
        return [t(key.m, key.n), t(key.n), t(key.n)]
    if isinstance(key, FlashMhaKey):
        E = (key.heads or 1) * key.head_dim
        if key.qkv_packed:
            return [t(key.batch, key.seq, 3 * E)] * 3
        return [t(key.batch, s, E) for s in (key.seq, key.seq_kv,
                                              key.seq_kv)]
    a = (key.m, key.k) if key.lhs_shared else (key.batch, key.m, key.k)
    return [t(*a), t(key.batch, key.k, key.n),
            None if key.beta0 else t(key.batch, key.m, key.n,
                                     dt=torch.float32)]


def _launch(build, key, monkeypatch):
    """The Kernel `build()` makes (the library stand-in bound first, as a
    launcher binds the library when it is built) and the C entry and
    arguments of its one launch on zeros of the key's shapes."""
    rec = _Recorder()
    monkeypatch.setattr(kbuild, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda: None)
    kern = build()
    if isinstance(key, BrgemmKey):
        kern._launch.work_bytes = 0     # no card: no workspace to size
    kern._launch(*_inputs(key))
    (entry, args), = rec.calls
    return kern, entry, args


@pytest.mark.parametrize("name", list(ROUTED))
def test_no_f16_key_reaches_a_bf16_rounding_loader(name, monkeypatch):
    key, route = ROUTED[name]
    kern, entry, args = _launch(lambda: build_kernel(key), key, monkeypatch)
    assert kern.route == route
    if entry == "tpp_brgemm":
        assert (args[10], args[11]) == (2, 2)
        assert args[21] == kernels._GEMM_ROUTE_CODE[route]
        assert args[20] == {None: 0, "layer_norm": 1, "ln_stats": 2}[
            key.prologue]
    elif entry == "tpp_layer_norm":
        assert (args[6], args[7], args[8]) == (2, 2, 2)
        assert args[9] == int(route == "register")
    elif entry == "tpp_attention":
        assert args[10] == 2 and args[11] == 4 and args[12] == 2
    else:
        assert entry == "tpp_batch_matmul"
        assert (args[11], args[12], args[13]) == (2, 2, 2)
        assert args[14] == int(route == "multi")


# f16 keys whose strides TMA cannot take: attention.cu has no f16 register
# loader (every head_dim it instantiates, 32, 64 and 128, gives strides TMA
# takes), so the key is refused, never run on bf16's register loader
UNALIGNED = {
    "flat-d36": FlashMhaKey(2, 64, 64, 36, "f16", scale=0.125),
    "packed-h3-d20": FlashMhaKey(2, 64, 64, 20, "f16", scale=0.125,
                                 heads=3, qkv_packed=True),
}


@pytest.mark.parametrize("name", list(UNALIGNED))
def test_f16_attention_keys_tma_cannot_take_are_refused(name):
    key = UNALIGNED[name]
    assert reference.attention_loader(
        dataclasses.replace(key, dtype="bf16")) == "convert"
    with pytest.raises(ValueError, match="no register loader for f16"):
        reference.attention_loader(key)
    with pytest.raises(ValueError, match="no register loader for f16"):
        build_kernel(key)


def test_f16_routes_follow_the_key():
    """f16 takes the same routes bf16 does: TMA where the strides allow it
    (2-byte elements), the multi route for 16-bit products, B12's
    register body up to 2,048 columns."""
    assert reference.attention_loader(_flat()) == "tma"
    assert reference.attention_loader(
        dataclasses.replace(_flat(), dtype="bf16")) == "tma"
    assert reference.brgemm_route(B2["ragged-k-eps"]) == "convert"
    for key in BMM.values():
        bf16 = dataclasses.replace(key, dtype="bf16")
        assert reference.batch_matmul_route(key) == \
            reference.batch_matmul_route(bf16)
    assert reference.layer_norm_route(LayerNormKey(8, 2048, "f16")) == \
        "register"
    assert reference.layer_norm_route(LayerNormKey(8, 2056, "f16")) == \
        "strided"


# keys mixing 16-bit types, refused naming A14 until its last item: each
# runs now, its plain version held to the Pallas body in interpret mode at
# its output type's tolerance (1e-2 bf16, TOL_KERNEL f16;
# tests/test_torch_f16_mixed.py holds every family's)
REFUSED = {
    "layer-norm-bf16-to-f16": LayerNormKey(8, 64, "bf16", out_dtype="f16"),
    "bmm-f16-to-bf16": BatchMatmulKey(4, 16, 16, 16, "f16",
                                      out_dtype="bf16"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_f16_keys_the_slice_refuses_name_a14(name):
    key = REFUSED[name]
    rng = np.random.default_rng(6)
    if isinstance(key, LayerNormKey):
        x = (rng.standard_normal((key.m, key.n)) * 3.0 + 1.0).astype(
            jnp.bfloat16)
        args = (x, _f16(rng, (key.n,)), _f16(rng, (key.n,)))
    else:
        args = (_f16(rng, (key.batch, key.m, key.k)),
                _f16(rng, (key.batch, key.k, key.n)),
                rng.standard_normal((key.batch, key.m, key.n))
                .astype(np.float32))
    got = _port(key, *args)
    want = _jax(key, *args)
    assert got.dtype == reference.DTYPES[key.out_dtype]
    assert _err(got, np.asarray(want.astype(jnp.float32))) <= \
        (1e-2 if key.out_dtype == "bf16" else TOL_KERNEL)
