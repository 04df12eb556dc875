"""f16 keys (ROADMAP A14 items 4, 6 and 7) on the conv family, the grouped
GEMMs and B15's output: csrc/conv.cu's B24/B25 (ConvNhwcKey) and B23
(ConvBrgemmKey), B16/B17 (GroupedGemmKey, GroupedWgradKey) and the int8
GEMM with an f16 output (Int8GemmKey), with the tl evaluators the conv
nets keep (tl.pad, the pools, a strided tl.blocked_conv2d).

On the CPU the port runs the kernels' plain versions; each is held here to
the JAX package on the same seeded numpy inputs cast to float16, the JAX
side through `build_kernel(key, interpret=True)` (its Pallas bodies) or its
own evaluator and `run_module`. Error measure: max|port - jax| / max|jax|.
Tolerances:
  * one kernel: 2e-3, tests/xsmm/test_kernels.py:677's f16 rtol (f16
    operands, exact f16 x f16 products, f32 sums in another order, one
    rounding of the output);
  * a tl evaluator: 2e-3 (a pad or a max pool moves values and is exact;
    an average pool and a strided conv sum in f32 and round once);
  * the conv nets, the imported ResNet block, a ViT and the conv-BN-pool
    stack through both executors, lowered and --linalg-to-loops: 1e-2 (a
    model's roundings add up).
The route test holds what the card would run: no f16 key's launch passes
conv.cu's "convert" route, a bf16 product code or a bf16 output code (the
launch arguments read from a recording stand-in for the kernel library,
since the CPU has none). The card's own check that the products are f16
(A = 1 + 2^-10) is tests/test_torch_cuda.py's
test_f16_products_are_not_bf16.
"""

import dataclasses
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.ir as jax_ir
import tpp_mlir_tpu.xsmm.flags as ref_flags
import tpp_mlir_tpu_torch.ir as port_ir
from tpp_mlir_tpu.frontend import import_torch as jax_import_torch
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.runtime import compile as jax_compile
from tpp_mlir_tpu.runtime.executor import _eval_tl as jax_eval_tl
from tpp_mlir_tpu.tools import bench_driver as jax_bench_driver
from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch.frontend import import_torch
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime import compile as port_compile
from tpp_mlir_tpu_torch.runtime.executor import _eval_tl
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.tools import bench_driver
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import (ConvBrgemmKey, ConvNhwcKey,
                                     GroupedGemmKey, GroupedWgradKey,
                                     Int8GemmKey, build_kernel)
from tpp_mlir_tpu_torch.xsmm import build as kbuild
from tpp_mlir_tpu_torch.xsmm import kernels, reference

F16 = torch.float16
TOL_KERNEL, TOL_MODEL = 2e-3, 1e-2


def _f16(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float16)


def _err(got, want) -> float:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def _ref_key(key):
    return getattr(ref_flags, type(key).__name__)(**dataclasses.asdict(key))


def _jax(key, *args):
    return jax_build_kernel(_ref_key(key), interpret=True)(
        *(None if a is None else jnp.asarray(a) for a in args))


def _port(key, *args):
    kern = build_kernel(key)
    out = kern(*(None if a is None else to_torch(np.asarray(a))
                 for a in args))
    assert kern.launches == 0
    return out


# ---- one kernel at a time, against the Pallas bodies in interpret mode --

def _conv(**kw):
    base = dict(N=2, H=10, W=10, C=64, K=64, R=3, S=3, dtype="f16")
    return ConvNhwcKey(**{**base, **kw})


# the epilogue forms conv-to-brgemm and xsmm-combine make of the f16 nets:
# a bias and relu, a same-padded residual on a C accumulator, an f32
# output, a 1x1 conv, and channel counts the tma route cannot take
CONV = {
    "bias-relu": _conv(beta0=True, binary_kind="add", unary_kind="relu"),
    "pad-c-residual-relu": _conv(pad=(1, 1, 1, 1), binary_kind="add",
                                 binary_bcast="none", unary_kind="relu"),
    "c-f32-out": _conv(out_dtype="f32"),
    "1x1-w14": _conv(H=14, W=14, R=1, S=1, beta0=True, binary_kind="add",
                     unary_kind="relu"),
    "ragged-c12-k20": _conv(C=12, K=20, pad=(1, 1, 1, 1), beta0=True,
                            binary_kind="add", unary_kind="relu"),
}


def _conv_operands(key, seed=3):
    """Seeded (i, w, c, d) in f16, as the f16 nets keep them; None where
    the key reads no such operand."""
    rng = np.random.default_rng(seed)
    out = (key.N, key.P, key.Q, key.K)
    d = None
    if key.binary_kind:
        d = _f16(rng, out if key.binary_bcast == "none" else (key.K,))
    return (_f16(rng, (key.N, key.H, key.W, key.C)),
            _f16(rng, (key.R, key.S, key.C, key.K),
                 (key.R * key.S * key.C) ** -0.5),
            None if key.beta0 else _f16(rng, out), d)


# strategy "auto" at stride 1 is the reference's XLA conv, not a Pallas
# body (xsmm/reference.py conv_route): the Pallas bodies are window (B24)
# and fullrow (B25)
@pytest.mark.parametrize("strategy", ["window", "fullrow"])
@pytest.mark.parametrize("name", list(CONV))
def test_conv_nhwc_matches_pallas_interpret(name, strategy):
    key = dataclasses.replace(CONV[name], strategy=strategy)
    args = _conv_operands(key)
    got = _port(key, *args)
    want = _jax(key, *args)
    assert got.dtype == reference.DTYPES[key.out_dtype or "f16"]
    assert _err(got, want) <= TOL_KERNEL


def _blocked(**kw):
    base = dict(N=2, H=8, W=8, Cb=1, c=32, Kb=1, k=32, R=3, S=3,
                dtype="f16")
    return ConvBrgemmKey(**{**base, **kw})


B23 = {
    "cb1-c": _blocked(),
    "cb2-kb2-bias-relu": _blocked(Cb=2, Kb=2, beta0=True, binary_kind="add",
                                  unary_kind="relu"),
    "c-f32-out": _blocked(Cb=2, out_dtype="f32"),
}


@pytest.mark.parametrize("name", list(B23))
def test_conv_blocked_matches_pallas_interpret(name):
    key = B23[name]
    rng = np.random.default_rng(4)
    out = (key.N, key.Kb, key.P, key.Q, key.k)
    args = (_f16(rng, (key.N, key.Cb, key.H, key.W, key.c)),
            _f16(rng, (key.Kb, key.Cb, key.R, key.S, key.c, key.k),
                 (key.R * key.S * key.Cb * key.c) ** -0.5),
            None if key.beta0 else _f16(rng, out),
            _f16(rng, (key.Kb, key.k)) if key.binary_kind else None)
    got = _port(key, *args)
    want = _jax(key, *args)
    assert got.shape == out
    assert got.dtype == reference.DTYPES[key.out_dtype or "f16"]
    assert _err(got, want) <= TOL_KERNEL


@pytest.mark.parametrize("with_c", [False, True], ids=["bias-relu", "c"])
def test_ops_conv2d_brgemm_f16_matches_jax(with_c):
    """ops.conv2d_brgemm on f16 tensors (B23's key) against the JAX op in
    interpret mode."""
    from tpp_mlir_tpu import ops as jax_ops
    from tpp_mlir_tpu_torch import ops
    rng = np.random.default_rng(8)
    i = _f16(rng, (2, 2, 8, 8, 16))
    w = _f16(rng, (2, 2, 3, 3, 16, 16), 0.08)
    c = _f16(rng, (2, 2, 6, 6, 16)) if with_c else None
    kw = {} if with_c else dict(bias=_f16(rng, (2, 16)), activation="relu")
    got = ops.conv2d_brgemm(to_torch(i), to_torch(w),
                            None if c is None else to_torch(c),
                            **{k: to_torch(v) if isinstance(v, np.ndarray)
                               else v for k, v in kw.items()})
    want = jax_ops.conv2d_brgemm(
        jnp.asarray(i), jnp.asarray(w), None if c is None else jnp.asarray(c),
        interpret=True, **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                           else v for k, v in kw.items()})
    assert got.dtype == F16 and got.shape == (2, 2, 6, 6, 16)
    assert _err(got, want) <= TOL_KERNEL


# B16 at tests/xsmm/test_kernels.py:441's shapes, with and without gelu,
# f16 and f32 outputs, a stacked table and transpose_b (the dgrad)
GEMM = {
    "basic": (dict(n_groups=4, m=48, n=128, k=64, bm=8), [0, 0, 1, 3, 3, 3]),
    "gelu": (dict(n_groups=2, m=48, n=128, k=256, bm=16, unary_kind="gelu"),
             [1, 0, 1]),
    "gelu-f32-out": (dict(n_groups=2, m=48, n=128, k=256, bm=16,
                          unary_kind="gelu", out_dtype="f32"), [1, 0, 1]),
    "layers-gelu": (dict(n_groups=4, m=48, n=128, k=64, bm=8, layers=3,
                         unary_kind="gelu"), [0, 2, 1, 3, 3, 1]),
    "transpose-b-f32-out": (dict(n_groups=4, m=64, n=128, k=64, bm=16,
                                 transpose_b=True, out_dtype="f32"),
                            [0, 0, 1, 3]),
}


@pytest.mark.parametrize("name", list(GEMM))
def test_grouped_gemm_matches_pallas_interpret(name):
    kw, ge = GEMM[name]
    key = GroupedGemmKey(dtype="f16", **kw)
    rng = np.random.default_rng(5)
    wk = (key.n, key.k) if key.transpose_b else (key.k, key.n)
    lead = (key.layers,) if key.layers else ()
    a = _f16(rng, (key.m, key.k))
    w = _f16(rng, (*lead, key.n_groups, *wk), key.k ** -0.5)
    ge = np.asarray(ge, np.int32)
    kern = build_kernel(key)
    for li in range(key.layers or 1):
        args = ((np.int32(li),) if key.layers else ()) + (ge, a, w)
        got = kern(*((li,) if key.layers else ()), torch.from_numpy(ge),
                   to_torch(a), to_torch(w))
        want = _jax(key, *args)
        assert got.dtype == reference.DTYPES[key.out_dtype or "f16"]
        assert _err(got, want) <= TOL_KERNEL
    assert kern.launches == 0


# every expert owns a block: the TPU kernel leaves an expert with none
# unwritten (the port writes zeros)
WGRAD = {
    "basic": (dict(n_groups=4, m=48, k=64, n=128, bm=8),
              [0, 0, 1, 2, 3, 3]),
    "split-n": (dict(n_groups=2, m=32, k=32, n=256, bm=8, bn=128),
                [0, 0, 0, 1]),
}


@pytest.mark.parametrize("name", list(WGRAD))
def test_grouped_wgrad_matches_pallas_interpret(name):
    kw, ge = WGRAD[name]
    key = GroupedWgradKey(dtype="f16", **kw)
    rng = np.random.default_rng(6)
    x, dy = _f16(rng, (key.m, key.k)), _f16(rng, (key.m, key.n))
    ge = np.asarray(ge, np.int32)
    want = _jax(key, ge, x.T, dy)
    kern = build_kernel(key)
    # xt as the transpose of the (m, k) rows, as the MoE backward passes it
    got = kern(torch.from_numpy(ge), to_torch(x).t(), to_torch(dy))
    assert got.dtype == torch.float32 and kern.launches == 0
    assert _err(got, want) <= TOL_KERNEL


@pytest.mark.parametrize("m,bias,unary", [(32, True, "gelu"),
                                          (64, False, None)],
                         ids=["m32-bias-gelu", "m64-plain"])
def test_int8_gemm_f16_out_matches_pallas_interpret(m, bias, unary):
    k, n = 64, 128
    rng = np.random.default_rng(m + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.random(m) * 0.02).astype(np.float32)
    ws = (rng.random((1, n)) * 0.02).astype(np.float32)
    args = (xq, wq, xs, ws) + \
        ((rng.standard_normal(n).astype(np.float32),) if bias else ())
    key = Int8GemmKey(m=m, n=n, k=k, out_dtype="f16", has_bias=bias,
                      unary_kind=unary)
    want = _jax(key, *args)
    got = build_kernel(key)(*map(torch.from_numpy, args))
    assert got.dtype == F16 and str(np.asarray(want).dtype) == "float16"
    assert _err(got, want) <= TOL_KERNEL


# ---- the tl evaluators the conv nets keep, in f16 -----------------------

EVAL = {
    "pad": (((2, 3, 6, 6),), lambda b, x: b.pad(x, (0, 0, 1, 2),
                                                (0, 0, 2, 1))),
    "max_pool2d": (((2, 3, 8, 8),), lambda b, x: b.pool2d(
        "tl.max_pool2d", x, (2, 2))),
    "avg_pool2d": (((2, 3, 9, 9),), lambda b, x: b.pool2d(
        "tl.avg_pool2d", x, (3, 3), (2, 2))),
    "blocked_conv2d-stride2": (
        ((2, 2, 9, 9, 8), (2, 2, 3, 3, 8, 16), (2, 2, 4, 4, 16)),
        lambda b, i, w, o: b.blocked_conv2d(i, w, o, (2, 2))),
}


def _one_op(ir, shapes, build):
    m = ir.Module()
    f = m.add(ir.Function("entry", [ir.TensorType(s, "f16")
                                    for s in shapes],
                          [f"a{i}" for i in range(len(shapes))]))
    f.returns = [build(ir.TppBuilder(f), *f.args)]
    m.verify()
    return m


@pytest.mark.parametrize("name", list(EVAL))
def test_f16_evaluators_match_the_jax_evaluator(name):
    """Each evaluator gives an f16 result of the declared type, within
    2e-3 of the JAX evaluator's on the same op; the module passes
    verify-slice."""
    shapes, build = EVAL[name]
    port, ref = _one_op(port_ir, shapes, build), _one_op(jax_ir, shapes,
                                                         build)
    rng = np.random.default_rng(7)
    ins = [_f16(rng, s) for s in shapes]
    got = _eval_tl(port["entry"].ops[-1], [to_torch(a) for a in ins])
    want = jax_eval_tl(ref["entry"].ops[-1], [jnp.asarray(a) for a in ins],
                       False)
    assert got.dtype == F16 and str(np.asarray(want).dtype) == "float16"
    assert tuple(got.shape) == port["entry"].ops[-1].result.type.shape
    assert _err(got, want) <= TOL_KERNEL
    run_pipeline(port, "verify-slice")


# ---- the conv nets in f16: lowered IR and both executors ----------------

def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


_NET = '"batch": 2, "channels": 16, "filters": 16, "height": 10, ' \
    '"width": 10, "kernel": 3, "float_type": "f16"'
# conv.json's and vit.json's f16 twins at small widths: (model, pipeline)
MODELS = {
    "nchw": ("convnet:{%s}" % _NET, "default-tpp-passes"),
    "nchw-packed-b23": ("convnet:{%s}" % _NET, "default-tpp-passes-packed"),
    "nchw-2layer": ('convnet:{%s, "layers": 2}' % _NET,
                    "default-tpp-passes"),
    "nhwc": ('convnet:{%s, "layout": "nhwc"}' % _NET, "default-tpp-passes"),
    "nhwc-1x1": ('convnet:{"batch": 2, "channels": 32, "filters": 32, '
                 '"height": 7, "width": 7, "kernel": 1, "layout": "nhwc", '
                 '"float_type": "f16"}', "default-tpp-passes"),
    "nhwc-same-residual": ('convnet:{"batch": 2, "channels": 16, '
                           '"filters": 16, "height": 8, "width": 8, '
                           '"kernel": 3, "layers": 2, "layout": "nhwc", '
                           '"padding": "same", "residual": true, '
                           '"float_type": "f16"}', "default-tpp-passes"),
    "resnet-block-import": ('resnet_block:{"batch": 2, "channels": 16, '
                            '"hw": 8, "dtype": "f16"}', "default-tpp-passes"),
    "vit": ('vit:{"batch": 2, "image": 32, "patch": 8, "embed": 64, '
            '"heads": 2, "layers": 1, "dtype": "f16"}', "default-tpp-passes"),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_f16_nets_lower_like_the_jax_package(name):
    """The bench driver's module prints the JAX driver's, and its lowering
    the JAX package's with tile hints stripped; every conv dispatch is an
    f16 key of the kernel route it takes on the card."""
    model, pipeline = MODELS[name]
    port = bench_driver.build_module({"model": model})
    ref = jax_bench_driver.build_module({"model": model})
    assert str(port) == str(ref)
    run_pipeline(port, pipeline)
    jax_run_pipeline(ref, pipeline)
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    from tpp_mlir_tpu_torch.runtime.executor import _dispatch_key
    keys = [_dispatch_key(op.operands[0].owner, op)
            for op in port["entry"].ops
            if op.opname in ("xsmm.brgemm", "xsmm.fused_brgemm")
            and op.operands[0].owner.attrs.get("layout") in ("conv_nhwc",
                                                             "conv")]
    assert keys and all(k.dtype == "f16" for k in keys)
    for k in keys:
        reference.check_slice(k)
        if name != "vit":       # the ViT's patch conv: the xla route
            assert reference.conv_kernel_route(k) in ("tma", "wmma")


@pytest.mark.parametrize("l2l", [False, True], ids=["lowered", "l2l"])
@pytest.mark.parametrize("name", list(MODELS))
def test_f16_nets_run_like_the_jax_package(name, l2l):
    model, pipeline = MODELS[name]
    ref = jax_bench_driver.build_module({"model": model})
    want = jax_run_module(ref, seed=1, pipeline=pipeline,
                          out_stream=io.StringIO())["outputs"][0]
    got = run_module(bench_driver.build_module({"model": model}), seed=1,
                     device="cpu", pipeline=pipeline, linalg_to_loops=l2l,
                     out_stream=io.StringIO())["outputs"][0]
    assert got.dtype == F16 and str(np.asarray(want).dtype) == "float16"
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= TOL_MODEL


def _conv_bn_pool(channels=16, hw=8):
    """JAX tests/frontend/test_torch_import.py:88's stack."""
    torch.manual_seed(4)
    model = torch.nn.Sequential(
        torch.nn.Conv2d(channels, channels, 3, padding=1),
        torch.nn.BatchNorm2d(channels), torch.nn.ReLU(),
        torch.nn.MaxPool2d(2), torch.nn.AvgPool2d(2), torch.nn.Flatten(),
        torch.nn.Linear(channels * (hw // 4) ** 2, 10))
    model.eval()
    with torch.no_grad():
        model[1].running_mean.uniform_(-0.5, 0.5)
        model[1].running_var.uniform_(0.5, 1.5)
    return model


def test_f16_conv_bn_pool_stack():
    """The imported stack in f16 lowers as the JAX package's does (the
    conv on the NHWC kernel's f16 key, the pools on f16 NCHW tensors) and
    both executors match the JAX run."""
    model, shape = _conv_bn_pool(), (2, 16, 8, 8)
    x = torch.randn(*shape).half()
    port, ref = import_torch(model, shape, "f16"), \
        jax_import_torch(model, shape, "f16")
    loops = port_compile(import_torch(model, shape, "f16"),
                         device="cpu")(x)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    s = str(port)
    assert _strip_tiles(s) == _strip_tiles(str(ref))
    assert 'layout = "conv_nhwc"' in s and "tl.max_pool2d" in s \
        and "tl.avg_pool2d" in s
    got = port_compile(port, device="cpu")(x)
    want = jax_compile(ref, jit=False)(jnp.asarray(x.numpy()))
    assert got.dtype == loops.dtype == F16
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= TOL_MODEL
    assert _err(loops, want) <= TOL_MODEL


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


def _zeros(key):
    """CPU tensors of the shapes the key's launcher checks."""
    def t(*shape, dt=F16):
        return torch.zeros(shape, dtype=dt)
    if isinstance(key, ConvNhwcKey):
        out = (key.N, key.P, key.Q, key.K)
        d = t(*out) if key.binary_bcast == "none" else t(key.K)
        return (t(key.N, key.H, key.W, key.C), t(key.R, key.S, key.C, key.K),
                None if key.beta0 else t(*out),
                d if key.binary_kind else None)
    if isinstance(key, ConvBrgemmKey):
        return (t(key.N, key.Cb, key.H, key.W, key.c),
                t(key.Kb, key.Cb, key.R, key.S, key.c, key.k),
                None if key.beta0 else t(key.N, key.Kb, key.P, key.Q, key.k),
                t(key.Kb, key.k) if key.binary_kind else None)
    if isinstance(key, GroupedGemmKey):
        return (torch.zeros(key.m // key.bm, dtype=torch.int32),
                t(key.m, key.k), t(key.n_groups, key.k, key.n))
    if isinstance(key, GroupedWgradKey):
        return (torch.zeros(key.m // key.bm, dtype=torch.int32),
                t(key.m, key.k).t(), t(key.m, key.n))
    i8 = torch.int8
    return (t(key.m, key.k, dt=i8), t(key.k, key.n, dt=i8),
            t(key.m, dt=torch.float32), t(key.n, dt=torch.float32), None,
            t(key.n, key.k, dt=i8))


# the places of (operand dtype, product dtype, output dtype, route) in each
# C entry's arguments (xsmm/build.py), None where it has no such argument;
# then each f16 key, the body forced (or None) and the route or tile its
# launcher takes
ENTRY = {"tpp_conv_nhwc": (17, 18, 19, 26),
         "tpp_conv_blocked": (17, 18, 19, 26),
         "tpp_grouped_gemm": (11, 12, 13, 16),
         "tpp_grouped_wgrad": (11, 12, None, 13),
         "tpp_int8_gemm_wgmma": (None, None, 11, None),
         "tpp_int8_gemm": (None, None, 10, None)}
ROUTED = {
    "conv-tma": (CONV["pad-c-residual-relu"], None, "tma"),
    "conv-tma-f32-out": (CONV["c-f32-out"], None, "tma"),
    "conv-ragged-wmma": (CONV["ragged-c12-k20"], None, "wmma"),
    "conv-forced-wmma": (CONV["bias-relu"], "wmma", "wmma"),
    "b23-tma": (B23["cb2-kb2-bias-relu"], None, "tma"),
    "b16-wgmma": (GroupedGemmKey(n_groups=2, m=128, n=128, k=64, bm=64,
                                 dtype="f16", unary_kind="gelu"), None,
                  "wgmma"),
    "b16-wmma-bm16": (GroupedGemmKey(n_groups=2, m=64, n=128, k=64, bm=16,
                                     dtype="f16", out_dtype="f32"), None,
                      "wmma"),
    "b17-wgmma": (GroupedWgradKey(n_groups=2, m=128, k=64, n=128, bm=64,
                                  dtype="f16"), None, "wgmma"),
    "b17-wmma-bm16": (GroupedWgradKey(n_groups=2, m=64, k=64, n=128, bm=16,
                                      dtype="f16"), None, "wmma"),
    "b15-wgmma": (Int8GemmKey(m=64, n=128, k=64, out_dtype="f16"), None,
                  "wgmma"),
    "b15-wmma": (Int8GemmKey(m=64, n=128, k=64, out_dtype="f16"), "wmma",
                 "wmma"),
}


def _build(key, forced):
    if forced is None:
        return build_kernel(key)
    if isinstance(key, Int8GemmKey):
        return kernels.build_int8(key, forced)
    return kernels.build_conv(key, forced)


@pytest.mark.parametrize("name", list(ROUTED))
def test_no_f16_key_reaches_a_bf16_route(name, monkeypatch):
    """f16 operands and products (code 2), an f16 output code where the
    key's output is f16 (0 where f32), and never conv.cu's "convert" route
    (it rounds its stages to bf16) nor a bf16 code; the library stand-in
    is bound before the kernel is built, as a launcher binds it there."""
    key, forced, route = ROUTED[name]
    rec = _Recorder()
    monkeypatch.setattr(kbuild, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda: None)
    kern = _build(key, forced)
    kern._launch(*_zeros(key))
    (entry, args), = rec.calls
    assert kern.route == route
    i_in, i_mma, i_out, i_route = ENTRY[entry]
    if i_in is not None:
        assert (args[i_in], args[i_mma]) == (2, 2)
    if i_out is not None:
        assert args[i_out] == kernels._DT_CODE[
            reference.DTYPES[key.out_dtype or key.dtype]]
        assert args[i_out] != 1
    if entry.startswith("tpp_grouped"):
        assert args[i_route] == kernels._GROUPED_ROUTE_CODE[route]
    elif entry.startswith("tpp_conv"):
        assert args[i_route] == kernels._CONV_ROUTE_CODE[route] != \
            kernels._CONV_ROUTE_CODE["convert"]


def test_f16_routes_follow_the_key():
    """f16 takes bf16's routes and plans (2-byte elements): the conv's tma
    route where c and k are multiples of 8, else the wmma tile, never
    "convert"; its bf16 twin's conv_plan; B16/B17's wgmma tile under
    bf16's conditions."""
    for key in (*CONV.values(), *B23.values()):
        bf16 = dataclasses.replace(key, dtype="bf16")
        assert reference.conv_kernel_route(key) == \
            reference.conv_kernel_route(bf16) != "convert"
        if reference.conv_kernel_route(key) == "tma":
            assert reference.conv_plan(key) == reference.conv_plan(bf16)
    big = ConvNhwcKey(N=8, H=30, W=30, C=128, K=128, R=3, S=3, dtype="f16")
    assert reference.conv_plan(big) == reference.conv_plan(
        dataclasses.replace(big, dtype="bf16"))
    for bm, want in ((128, "wgmma"), (64, "wgmma"), (16, "wmma")):
        g = GroupedGemmKey(n_groups=8, m=9216, n=768, k=3072, bm=bm,
                           dtype="f16")
        w = GroupedWgradKey(n_groups=8, m=9216, k=768, n=3072, bm=bm,
                            dtype="f16")
        assert reference.grouped_gemm_route(g) == want
        assert reference.grouped_wgrad_route(w) == want
    assert reference.int8_gemm_route(
        Int8GemmKey(m=4096, n=768, k=768, out_dtype="f16")) == "wgmma"


# keys mixing 16-bit types, refused naming A14 until its last item: each
# runs now, its plain version held to the Pallas body in interpret mode at
# its output type's tolerance (1e-2 bf16, TOL_KERNEL f16;
# tests/test_torch_f16_mixed.py holds every family's)
REFUSED = {
    "conv-f16-to-bf16": _conv(out_dtype="bf16"),
    "conv-bf16-to-f16": _conv(dtype="bf16", out_dtype="f16"),
    "blocked-f16-to-bf16": _blocked(out_dtype="bf16"),
    "grouped-f16-to-bf16": GroupedGemmKey(n_groups=2, m=16, n=16, k=16,
                                          bm=8, dtype="f16",
                                          out_dtype="bf16"),
    "grouped-f32-to-f16": GroupedGemmKey(n_groups=2, m=16, n=16, k=16,
                                         bm=8, out_dtype="f16"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_f16_keys_mixing_16_bit_types_name_a14(name):
    key = REFUSED[name]
    rng = np.random.default_rng(9)
    dt = {"f32": np.float32, "bf16": jnp.bfloat16, "f16": np.float16}[
        key.dtype]

    def arr(*shape, scale=1.0):
        # f32 operands as bf16 values: the port's "default" products round
        # them, the JAX interpret mode keeps f32
        x = rng.standard_normal(shape) * scale
        return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(dt)
    if isinstance(key, ConvNhwcKey):
        args = (arr(key.N, key.H, key.W, key.C),
                arr(key.R, key.S, key.C, key.K,
                    scale=(key.R * key.S * key.C) ** -0.5),
                _f16(rng, (key.N, key.P, key.Q, key.K)), None)
    elif isinstance(key, ConvBrgemmKey):
        args = (arr(key.N, key.Cb, key.H, key.W, key.c),
                arr(key.Kb, key.Cb, key.R, key.S, key.c, key.k,
                    scale=(key.R * key.S * key.Cb * key.c) ** -0.5),
                _f16(rng, (key.N, key.Kb, key.P, key.Q, key.k)), None)
    else:
        args = (np.asarray([1, 0], np.int32), arr(key.m, key.k),
                arr(key.n_groups, key.k, key.n, scale=key.k ** -0.5))
    if isinstance(key, ConvNhwcKey):
        key = dataclasses.replace(key, strategy="window")
    got = _port(key, *args)
    want = _jax(key, *args)
    assert got.dtype == reference.DTYPES[key.out_dtype]
    assert _err(got, np.asarray(want.astype(jnp.float32))) <= \
        (1e-2 if key.out_dtype == "bf16" else TOL_KERNEL)
