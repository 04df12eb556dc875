"""The conv family on the port against the JAX package, on the CPU.

The NHWC conv's plain version (tpp_mlir_tpu_torch/xsmm/reference.py
conv_nhwc_reference, the oracle csrc/conv.cu is held to on the card)
against the reference's `_build_conv_nhwc` in interpret mode under each of
its strategies (window B24, fullrow B25, xla), with padding, a C
accumulator, a channel bias, a residual and relu, in f32 and bf16; the
"xla" route's F.conv2d version at a stride; the conv_route table, row by
row; the port's default-tpp-passes printing the reference's IR for the
conv suite's nets, the imported ResNet block and a ViT; and run_module on
each of them, lowered and at --linalg-to-loops, against the reference's.

Error measure: max|port - jax| / max|jax|. Tolerances: the plain version
1e-5 in f32 (the same products; f32 "default" compared with the JAX
operands rounded to bf16, since interpret mode keeps exact f32; sum order
only) and 1e-2 for a bf16 output (one rounding, which a sum-order
difference can flip). run_module: 1e-4 at precision "highest" (f32 on
both sides) and at --linalg-to-loops in f32; 1e-2 in f32 "default" (the
port's products see bf16 operands, interpret mode's exact f32) and in
bf16.
"""

import dataclasses
import io
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.ir as ref_ir
import tpp_mlir_tpu.xsmm.flags as ref_flags
import tpp_mlir_tpu_torch.ir as port_ir
from tpp_mlir_tpu.models.convnet import ConvConfig as JaxConvConfig
from tpp_mlir_tpu.models.convnet import build_convnet as jax_build_convnet
from tpp_mlir_tpu.models.resnet_block import \
    build_resnet_block as jax_build_resnet_block
from tpp_mlir_tpu.models.vit import build_vit_block as jax_build_vit
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch.models.convnet import ConvConfig, build_convnet
from tpp_mlir_tpu_torch.models.resnet_block import build_resnet_block
from tpp_mlir_tpu_torch.models.vit import build_vit_block
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.tools import bench_driver
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import (ConvBrgemmKey, ConvNhwcKey, build_kernel,
                                     reference_kernel)
from tpp_mlir_tpu_torch.xsmm.reference import (conv_nhwc_reference,
                                               conv_route)


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _key(**kw):
    base = dict(N=2, H=10, W=10, C=64, K=64, R=3, S=3, precision="highest")
    return ConvNhwcKey(**{**base, **kw})


# the epilogue forms conv-to-brgemm and xsmm-combine produce, at the
# reference test's shape (tests/xsmm/test_kernels.py:230-241)
PLAIN = {
    "acc": _key(),
    "acc-f32-default": _key(precision="default"),
    "pad-bias-relu": _key(pad=(1, 1, 1, 1), beta0=True, binary_kind="add",
                          unary_kind="relu"),
    "pad-residual-relu": _key(pad=(1, 1, 1, 1), binary_kind="add",
                              binary_bcast="none", unary_kind="relu"),
    "bias-relu-bf16": _key(dtype="bf16", precision="default", beta0=True,
                           binary_kind="add", unary_kind="relu"),
    "pad-residual-relu-bf16": _key(dtype="bf16", precision="default",
                                   pad=(1, 1, 1, 1), binary_kind="add",
                                   binary_bcast="none", unary_kind="relu"),
    "1x1-w14": _key(H=14, W=14, R=1, S=1, beta0=True, binary_kind="add",
                    unary_kind="relu"),
}


def _operands(key, seed=3):
    """Seeded (i, w, c, d) as numpy: i and w in the key's dtype, c and d in
    f32, None where the key reads no such operand."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0, dt=key.dtype):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if dt == "bf16" else a
    i = arr((key.N, key.H, key.W, key.C))
    w = arr((key.R, key.S, key.C, key.K), 0.05)
    c = None if key.beta0 else arr((key.N, key.P, key.Q, key.K), dt="f32")
    d = None
    if key.binary_kind:
        d = arr((key.N, key.P, key.Q, key.K) if key.binary_bcast == "none"
                else (key.K,), dt="f32")
    return i, w, c, d


def _jax_side(key, args):
    """The reference's interpret-mode kernel on the same operands; f32
    "default" operands rounded to bf16 first (interpret mode keeps f32)."""
    i, w, c, d = args
    if key.dtype == "f32" and key.precision == "default":
        i, w = (x.astype(ml_dtypes.bfloat16).astype(np.float32)
                for x in (i, w))
    ref_key = ref_flags.ConvNhwcKey(**dataclasses.asdict(key))
    fn = jax_build_kernel(ref_key, interpret=True)
    return fn(*(None if x is None else jnp.asarray(x) for x in (i, w, c, d)))


def _tol(key):
    return 1e-2 if (key.out_dtype or key.dtype) == "bf16" else 1e-5


@pytest.mark.parametrize("strategy", ["window", "fullrow", "xla"])
@pytest.mark.parametrize("name", list(PLAIN))
def test_conv_plain_matches_pallas_interpret(name, strategy):
    key = dataclasses.replace(PLAIN[name], strategy=strategy)
    args = _operands(key)
    want = _jax_side(key, args)
    got = conv_nhwc_reference(key)(*(None if x is None else to_torch(x)
                                     for x in args))
    assert got.dtype == {"f32": torch.float32,
                         "bf16": torch.bfloat16}[key.dtype]
    assert _err(got, want) <= _tol(key)


@pytest.mark.parametrize("name,kw", [
    ("patch-embed", dict(H=32, W=32, C=3, K=64, R=16, S=16, stride_h=16,
                         stride_w=16)),
    ("stride2-bias-relu", dict(H=9, W=9, R=1, S=1, stride_h=2, stride_w=2,
                               beta0=True, binary_kind="add",
                               unary_kind="relu")),
    ("stride2-pad-residual-bf16", dict(dtype="bf16", precision="default",
                                       stride_h=2, stride_w=2,
                                       pad=(1, 1, 1, 1), binary_kind="add",
                                       binary_bcast="none")),
])
def test_xla_route_matches_the_reference(name, kw):
    """Stride > 1 under auto: the route's F.conv2d version (the wrapper's
    plain version for such a key) and the per-tap plain version, both
    against the reference's xla strategy."""
    key = _key(**kw)
    assert conv_route(key) == "xla"
    args = _operands(key)
    want = _jax_side(key, args)
    targs = [None if x is None else to_torch(x) for x in args]
    kern = build_kernel(key)
    got = kern(*targs)
    assert kern.launches == 0
    assert _err(got, want) <= _tol(key)
    assert _err(conv_nhwc_reference(key)(*targs), want) <= _tol(key)


def test_wrapper_runs_the_plain_version_on_cpu():
    key = PLAIN["pad-residual-relu"]
    args = [None if x is None else to_torch(x) for x in _operands(key)]
    kern = build_kernel(key)
    assert torch.equal(kern(*args), reference_kernel(key)(*args))
    assert kern.launches == 0


@pytest.mark.parametrize("kw,route", [
    (dict(strategy="auto"), "kernel"),
    (dict(strategy="window"), "kernel"),
    (dict(strategy="fullrow"), "kernel"),
    (dict(strategy="xla"), "xla"),
    (dict(strategy="xla", stride_h=2, stride_w=2), "xla"),
    (dict(strategy="auto", stride_h=16, stride_w=16), "xla"),
    (dict(strategy="window", stride_h=2, stride_w=2), NotImplementedError),
    (dict(strategy="fullrow", stride_h=1, stride_w=2), NotImplementedError),
    (dict(strategy="im2col"), ValueError),
], ids=["auto", "window", "fullrow", "xla", "xla-stride2", "auto-stride16",
        "window-stride2", "fullrow-stride-w2", "unknown"])
def test_conv_route_table(kw, route):
    key = _key(**kw)
    if isinstance(route, str):
        assert conv_route(key) == route
        return
    with pytest.raises(route, match="stride>1 conv runs via strategy='xla'"
                       if route is NotImplementedError else "im2col"):
        conv_route(key)
    with pytest.raises(route):
        build_kernel(key)


def test_packed_conv_key_names_packed_mode():
    """Packed mode's channel-blocked conv key (B23) builds: on CPU tensors
    its wrapper runs the plain version and launches nothing."""
    key = ConvBrgemmKey(N=2, H=8, W=8, Cb=1, c=16, Kb=1, k=16, R=3, S=3)
    rng = np.random.default_rng(4)
    i = torch.from_numpy(rng.standard_normal((2, 1, 8, 8, 16), np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 1, 3, 3, 16, 16),
                                             np.float32))
    c = torch.from_numpy(rng.standard_normal((2, 1, 6, 6, 16), np.float32))
    kern = build_kernel(key)
    got = kern(i, w, c)
    assert got.shape == (2, 1, 6, 6, 16) and kern.launches == 0
    assert torch.equal(got, reference_kernel(key)(i, w, c))


def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


def _convnet(ref=False, **kw):
    base = dict(batch=2, channels=16, filters=16, height=8, width=8)
    cfg = (JaxConvConfig if ref else ConvConfig)(**{**base, **kw})
    return (jax_build_convnet if ref else build_convnet)(cfg)


MODELS = {
    "nchw": dict(),
    "nhwc": dict(layout="nhwc"),
    "nchw-2layer": dict(layers=2),
    "nhwc-same-residual": dict(layout="nhwc", padding="same", layers=2,
                               residual=True),
    "nchw-same-residual": dict(padding="same", layers=2, residual=True),
    "1x1-w14": dict(height=14, width=14, kernel=1),
    "1x1-w16": dict(height=16, width=16, kernel=1),
    "nhwc-bf16": dict(layout="nhwc", float_type="bf16"),
    "same-residual-bf16": dict(layout="nhwc", padding="same", layers=2,
                               residual=True, float_type="bf16"),
    "resnet_block": None,
    "vit": None,
}


def _build(name, ref=False):
    if name == "resnet_block":
        fn = jax_build_resnet_block if ref else build_resnet_block
        return fn(batch=2, channels=16, hw=6)
    if name == "vit":
        fn = jax_build_vit if ref else build_vit_block
        return fn(batch=2, image=32, patch=16, embed=64, heads=2,
                  layers=1)[0]
    return _convnet(ref, **MODELS[name])


def _ops(module):
    return [op.opname for op in module["entry"].ops
            if op.opname.startswith("xsmm.")
            and not op.opname.endswith("_dispatch")]


@pytest.mark.filterwarnings("ignore:enable_nested_tensor")
@pytest.mark.parametrize("name", list(MODELS))
def test_default_tpp_passes_match_the_reference(name):
    port, ref = _build(name), _build(name, ref=True)
    assert str(port) == str(ref)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    convs = [op.attrs for op in port["entry"].ops
             if op.attrs.get("layout") == "conv_nhwc"]
    # the gated 1x1 at a width of 16 rides the GEMM path; every other
    # net keeps its convs as conv_nhwc dispatches
    assert bool(convs) == (name != "1x1-w16")


def _biased_conv(ir, bias_shape):
    """An NHWC conv into a zero fill, plus a bias of `bias_shape`, built with
    `ir` (the port's or the reference's IR package)."""
    m = ir.Module()
    f = m.add(ir.Function("entry", [ir.TensorType((2, 8, 8, 16), "f32"),
                                    ir.TensorType((3, 3, 16, 16), "f32"),
                                    ir.TensorType(bias_shape, "f32")],
                          ["x", "w", "b"]))
    b = ir.TppBuilder(f)
    acc = b.constant(ir.TensorType((2, 6, 6, 16), "f32"), init="zero")
    b.ret(b.add(b.conv2d_nhwc_hwcf(*f.args[:2], acc, strides=(1, 1)),
                f.args[2]))
    m.verify()
    return m


@pytest.mark.parametrize("bias_shape,fused", [((16,), True),
                                              ((6, 16), False)],
                         ids=["channel-bias", "row-bias"])
def test_xsmm_combine_fuses_only_a_channel_bias(bias_shape, fused):
    """conv-init-simplify turns either bias into a broadcast accumulator;
    xsmm-combine takes only a channel bias[K] into the epilogue (beta_0,
    bcast_col) and leaves any other broadcast as the C operand, as the
    reference does."""
    port = _biased_conv(port_ir, bias_shape)
    ref = _biased_conv(ref_ir, bias_shape)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    disp = [op.attrs for op in port["entry"].ops
            if op.attrs.get("layout") == "conv_nhwc"]
    assert len(disp) == 1
    assert ("beta_0" in disp[0]["flags"]) == fused
    assert (disp[0].get("binary_bcast") == "bcast_col") == fused
    port.attrs["precision"] = ref.attrs["precision"] = "highest"
    got = run_module(port, seed=2, device="cpu",
                     out_stream=io.StringIO())["outputs"][0]
    want = jax_run_module(ref, seed=2,
                          out_stream=io.StringIO())["outputs"][0]
    assert _err(got, want) <= 1e-4


def _run_tol(name, precision, l2l):
    bf16 = "bf16" in name
    if l2l:
        return 1e-2 if bf16 else 1e-4
    return 1e-2 if bf16 or precision == "default" else 1e-4


# precision names f32 products only: a bf16 net runs at "default"
RUNS = [(name, precision) for name in MODELS
        for precision in (("default",) if "bf16" in name
                          else ("default", "highest"))]


@pytest.mark.filterwarnings("ignore:enable_nested_tensor")
@pytest.mark.parametrize("l2l", [False, True], ids=["lowered", "l2l"])
@pytest.mark.parametrize("name,precision", RUNS,
                         ids=[f"{n}-{p}" for n, p in RUNS])
def test_run_module_matches_the_reference(name, precision, l2l):
    port, ref = _build(name), _build(name, ref=True)
    port.attrs["precision"] = ref.attrs["precision"] = precision
    got = run_module(port, seed=2, device="cpu", linalg_to_loops=l2l,
                     out_stream=io.StringIO())["outputs"][0]
    want = jax_run_module(ref, seed=2, linalg_to_loops=l2l,
                          out_stream=io.StringIO())["outputs"][0]
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= _run_tol(name, precision, l2l)


def test_bench_driver_runs_a_conv_entry():
    entry = {"model": 'convnet:{"batch": 2, "channels": 16, "filters": 16, '
                      '"height": 10, "width": 10, "layout": "nhwc", '
                      '"padding": "same", "layers": 2, "residual": true}',
             "iters": 2}
    res = bench_driver.run_entry(entry, device="cpu",
                                 out_stream=io.StringIO())
    low, base = res["lowered"], res["baseline"]
    assert _ops(low["module"]) == ["xsmm.fused_brgemm"] * 2
    assert low["mean_seconds"] > 0 and res["flops"]
    assert _err(low["outputs"][0], base["outputs"][0].numpy()) <= 1e-2


def _conv_dispatch_module(**attrs):
    """A lowered conv as conv-to-brgemm writes it, with the dispatch's
    attributes overridden."""
    from tpp_mlir_tpu_torch.ir import I64, Function, Module, TensorType, \
        TppBuilder
    i, w = TensorType((2, 9, 9, 16), "f32"), TensorType((3, 3, 16, 16), "f32")
    o = TensorType((2, 4, 4, 16), "f32")
    m = Module()
    f = m.add(Function("entry", [i, w, o], ["x", "w", "c"]))
    b = TppBuilder(f)
    base = {"layout": "conv_nhwc", "N": 2, "H": 9, "W": 9, "C": 16, "K": 16,
            "R": 3, "S": 3, "m": 0, "n": 16, "k": 16, "batch": 144,
            "strides": (2, 2), "dtype": "f32", "flags": ()}
    d = b.create("xsmm.brgemm_dispatch", [], [I64], {**base, **attrs})
    f.returns = [b.create("xsmm.brgemm", [d.result, *f.args], [o]).result]
    return m


@pytest.mark.parametrize("attrs,err,why", [
    (dict(strategy="window"), NotImplementedError, "stride>1 conv"),
    # a strided channel-blocked conv: the reference's words
    # (kernels.py:2785-2788)
    (dict(layout="conv", Cb=1, c=16, Kb=1, kblk=16), NotImplementedError,
     "stride>1 conv stays on the XLA conv path"),
    (dict(strategy="im2col"), ValueError, "im2col"),
], ids=["window-stride2", "packed-layout", "unknown-strategy"])
def test_verify_slice_refuses_convs_outside_the_slice(attrs, err, why):
    with pytest.raises(err, match=why):
        run_pipeline(_conv_dispatch_module(**attrs), "verify-slice")


def test_verify_slice_admits_the_strided_xla_conv():
    m = _conv_dispatch_module()
    run_pipeline(m, "verify-slice")
    x, w, c = (torch.randn(t.shape) for t in
               (a.type for a in m["entry"].args))
    from tpp_mlir_tpu_torch.runtime import compile as tpp_compile
    got = tpp_compile(m, device="cpu")(x, w, c)
    key = ConvNhwcKey(N=2, H=9, W=9, C=16, K=16, R=3, S=3, stride_h=2,
                      stride_w=2)
    assert torch.equal(got, reference_kernel(key)(x, w, c))


def test_packed_ops_name_packed_mode_in_the_executor():
    """The executor runs packed mode's tl.pack: equal to the reference's
    `_pack_val`, bit for bit."""
    from tpp_mlir_tpu.runtime.executor import _pack_val
    from tpp_mlir_tpu_torch.ir import Function, Module, TensorType, \
        TppBuilder
    from tpp_mlir_tpu_torch.runtime import compile as tpp_compile
    m = Module()
    f = m.add(Function("entry", [TensorType((2, 32, 4, 4), "f32")], ["x"]))
    f.returns = [TppBuilder(f).pack(f.args[0], (1,), (16,))]
    x = np.random.default_rng(5).standard_normal((2, 32, 4, 4), np.float32)
    got = tpp_compile(m, device="cpu")(torch.from_numpy(x))
    want = np.asarray(_pack_val(jnp.asarray(x), {"inner_dims": (1,),
                                                 "inner_tiles": (16,)}))
    assert got.shape == (2, 2, 4, 4, 16)
    assert np.array_equal(got.numpy(), want)
