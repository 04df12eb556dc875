"""The compiler's general path on the port against the JAX package, on the
CPU: decompose-softmax, split-reduction-dim, convert-tl-to-xsmm's `skip`
option and zero-fill branch, the named bundles (tpp-mapping,
linalg-lowering, default-tpp-passes and its -flat/-packed forms,
default-pipeline), each printing the JAX package's IR on the same text
(tile hints stripped); the executor's tl evaluators against the JAX
package's `_eval_tl` one op at a time, and its host timers; and the
imported Conv2d-BN-ReLU-MaxPool2d-AvgPool2d-Linear stack against the
torch module and the JAX package.

Error measure: max|port - jax| / max|jax|. The evaluators: f32 1e-6 (the
same math, sum order only) and bf16 1e-2 (one rounding either side, which
an order difference can flip). The conv stack: 2e-3 against the JAX
package as its own test holds it (tests/frontend/test_torch_import.py:110)
at precision "highest" (true f32 on both sides), and 3e-2 (PERF.md's bound
for a model) at "default", where the port's conv rounds its operands to
bf16 (ROADMAP queue C).
"""

import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.ir as jax_ir
import tpp_mlir_tpu_torch.ir as port_ir
from tpp_mlir_tpu.frontend import import_torch as jax_import_torch
from tpp_mlir_tpu.passes import PassManager as JaxPassManager
from tpp_mlir_tpu.passes import make_pass as jax_make_pass
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.runtime import compile as jax_compile
from tpp_mlir_tpu.runtime.executor import _eval_tl as jax_eval_tl
from tpp_mlir_tpu_torch.frontend import import_torch
from tpp_mlir_tpu_torch.passes import (PassManager, available_pipelines,
                                       expand_pipeline, make_pass,
                                       run_pipeline)
from tpp_mlir_tpu_torch.runtime import compile as port_compile
from tpp_mlir_tpu_torch.runtime.executor import _eval_tl
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser, config_from_args,
                                               generate_text)


def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _np(shape, seed, dtype="f32", positive=False):
    a = np.asarray(np.random.default_rng(seed).standard_normal(shape),
                   np.float32)
    if positive:
        a = np.abs(a) + 0.5
    return a.astype(ml_dtypes.bfloat16) if dtype == "bf16" else a


def _both(text, precision="default"):
    port, ref = port_ir.parse_module(text), jax_ir.parse_module(text)
    if precision != "default":
        port.attrs["precision"] = ref.attrs["precision"] = precision
    return port, ref


SOFTMAX = """func @entry(%x: tensor<4x8x16xDT>) {
  %0 = tl.softmax %x {axis = AXIS} : tensor<4x8x16xDT>
  %1 = tl.relu %0 : tensor<4x8x16xDT>
  return %1 : tensor<4x8x16xDT>
}
"""


@pytest.mark.parametrize("axis", [-1, 1, 0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decompose_softmax(axis, dtype):
    """reduce max -> sub -> exp -> reduce sum -> div before the softmax, the
    JAX package's IR, and the decomposed softmax against the f32 one."""
    text = SOFTMAX.replace("AXIS", str(axis)).replace("DT", dtype)
    port, ref = _both(text)
    run_pipeline(port, "decompose-softmax")
    jax_run_pipeline(ref, "decompose-softmax")
    assert str(port) == str(ref)
    assert [op.opname for op in port["entry"].ops] == [
        "tl.reduce", "tl.sub", "tl.exp", "tl.reduce", "tl.div", "tl.relu"]
    x = to_torch(_np((4, 8, 16), 0, dtype))
    want = port_compile(port_ir.parse_module(text), device="cpu")(x)
    got = port_compile(port, device="cpu")(x)
    # f32: sum order only; bf16: four roundings against the f32 softmax
    assert _err(got, want.float().numpy()) <= (1e-6 if dtype == "f32"
                                               else 1e-2)


SPLIT = """func @entry(%a: tensor<64x512xf32>, %b: tensor<512x128xf32>, %c: tensor<64x128xf32>) {
  %0 = tl.matmul %a, %b, %c : tensor<64x128xf32>
  return %0 : tensor<64x128xf32>
}
"""


@pytest.mark.parametrize("lowered", [False, True], ids=["tl", "xsmm"])
def test_split_reduction_dim(lowered):
    """split-reduction-dim{tile=128}: tl.matmul -> tl.brgemm of batch 4 (the
    JAX package's IR), and default-tpp-passes after it lowers that to one
    xsmm.brgemm (B1); both run to a @ b + c."""
    port, ref = _both(SPLIT, "highest")
    PassManager([make_pass("split-reduction-dim", tile=128)]).run(port)
    JaxPassManager([jax_make_pass("split-reduction-dim", tile=128)]).run(ref)
    if lowered:
        run_pipeline(port, "default-tpp-passes")
        jax_run_pipeline(ref, "default-tpp-passes")
    s = _strip_tiles(str(port))
    assert s == _strip_tiles(str(ref))
    assert "tensor<4x64x128xf32>" in s and "tl.matmul" not in s
    assert ("xsmm.brgemm_dispatch" in s and "batch = 4" in s) if lowered \
        else "tl.brgemm" in s
    args = [_np((64, 512), 0), _np((512, 128), 1), _np((64, 128), 2)]
    got = port_compile(port, device="cpu")(*map(to_torch, args))
    want = jax_compile(ref, jit=False)(*map(jnp.asarray, args))
    assert _err(got, want) <= 1e-5
    np.testing.assert_allclose(got.numpy(), args[0] @ args[1] + args[2],
                               atol=1e-3, rtol=1e-4)


def test_split_reduction_dim_leaves_what_it_cannot_split():
    port, _ = _both(SPLIT)
    assert not make_pass("split-reduction-dim").run(port)          # tile 0
    assert not make_pass("split-reduction-dim", tile=512).run(port)  # K
    assert not make_pass("split-reduction-dim", tile=96).run(port)
    assert "tl.matmul" in str(port)


MATMUL = """func @entry(%a: tensor<64x64xbf16>, %b: tensor<64x64xbf16>) {
  %c = tl.constant {init = "zero"} : tensor<64x64xbf16>
  %0 = tl.matmul %a, %b, %c : tensor<64x64xbf16>
  return %0 : tensor<64x64xbf16>
}
"""


@pytest.mark.parametrize("skip", [("matmul",), ("unary", "binary"), ()])
def test_to_xsmm_skip_list(skip):
    """convert-tl-to-xsmm leaves the patterns its `skip` option names, as
    the JAX package's does."""
    text = MATMUL.replace(
        "  return %0", "  %1 = tl.relu %0 : tensor<64x64xbf16>\n"
        "  %2 = tl.add %1, %a : tensor<64x64xbf16>\n  return %2")
    port, ref = _both(text)
    make_pass("convert-tl-to-xsmm", skip=skip).run(port)
    jax_make_pass("convert-tl-to-xsmm", skip=skip).run(ref)
    s = str(port)
    assert s == str(ref)
    assert ("tl.matmul" in s) == ("matmul" in skip)
    assert ("tl.relu" in s) == ("unary" in skip)


ZERO_FILL = """func @entry(%a: tensor<32x64xf32>, %b: tensor<64x48xf32>, %d: tensor<32x48xf32>) {
  %c = tl.OP %d VALUE: tensor<32x48xf32>
  %0 = tl.matmul %a, %b, %c : tensor<32x48xf32>
  return %0 : tensor<32x48xf32>
}
"""


@pytest.mark.parametrize("op,value", [("zero", ""), ("fill", "0.0"),
                                      ("fill", "2.0")])
def test_zero_fill_folds_into_beta_0(op, value):
    """A tl.zero or a zero tl.fill lowers to xsmm.unary zero, which
    fold-xsmm-flags folds into the GEMM's BETA_0 flag; a non-zero fill
    stays a tl.fill accumulator. The JAX package's IR, and the right
    numbers."""
    text = ZERO_FILL.replace("OP", op).replace(
        "VALUE", f"{{value = {value}}} " if value else "")
    port, ref = _both(text, "highest")
    run_pipeline(port, "linalg-lowering")
    jax_run_pipeline(ref, "linalg-lowering")
    s = _strip_tiles(str(port))
    assert s == _strip_tiles(str(ref))
    zero = value != "2.0"
    assert ('"beta_0"' in s) == zero and "xsmm.unary" not in s
    assert ("tl.fill" in s) == (not zero)
    args = [_np((32, 64), 0), _np((64, 48), 1), _np((32, 48), 2)]
    got = port_compile(port, device="cpu")(*map(to_torch, args))
    want = args[0] @ args[1] + (0.0 if zero else 2.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_zero_unary_stands_alone():
    """convert-tl-to-xsmm's zero branch alone: one xsmm.unary zero whose
    plain version fills the dest's shape."""
    text = ZERO_FILL.replace("OP", "zero").replace("VALUE", "")
    port, ref = _both(text)
    make_pass("convert-tl-to-xsmm", skip=("matmul",)).run(port)
    jax_make_pass("convert-tl-to-xsmm", skip=("matmul",)).run(ref)
    assert str(port) == str(ref)
    assert 'kind = "zero"' in str(port)
    args = [_np((32, 64), 0), _np((64, 48), 1), _np((32, 48), 2)]
    got = port_compile(port, device="cpu")(*map(to_torch, args))
    np.testing.assert_allclose(got.numpy(), args[0] @ args[1], atol=1e-4,
                               rtol=1e-4)


# (label, tpp-gen flags) of the modules each bundle runs on
BUNDLE_MODULES = {
    "mlp": "--batch=16 --layers=64,64,64 --bias --relu",
    "softmax-bf16": "--batch=16 --layers=64,64 --bias --relu --softmax "
                    "--float-type=bf16",
    "generic": "--batch=16 --layers=64,64,64 --bias --relu --output=generic",
    "packable": "--batch=16 --layers=1024,1024 --bias --relu --tiles=8,512,512",
}
BUNDLES = ["tpp-mapping", "linalg-lowering", "default-tpp-passes",
           "default-tpp-passes-flat", "default-tpp-passes-packed",
           "default-pipeline"]


def _gen(flags):
    return generate_text(config_from_args(build_parser().parse_args(
        flags.split())))


@pytest.mark.parametrize("module", list(BUNDLE_MODULES))
@pytest.mark.parametrize("bundle", BUNDLES)
def test_bundles_print_the_reference_ir(bundle, module):
    """Each named bundle prints the JAX package's IR on tpp-gen's modules
    (the port's own verify-slice ends the default-tpp-passes family);
    linalg-lowering alone lowers a generic directly."""
    port, ref = _both(_gen(BUNDLE_MODULES[module]))
    run_pipeline(port, bundle)
    jax_run_pipeline(ref, bundle)
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))


def test_bundle_list_and_options():
    assert set(BUNDLES) <= set(available_pipelines())
    names = [p.name for p in expand_pipeline("default-tpp-passes")]
    assert names[:5] == ["degeneralize", "fold-add-into-dest",
                         "attention-fusion", "decompose-softmax", "cleanup"]
    assert names[-1] == "verify-slice"
    packed = [p.name for p in expand_pipeline("tpp-mapping", pack=True)]
    flat = [p.name for p in expand_pipeline("tpp-mapping", pack=False)]
    assert "pack-matmul" in packed and "pack-matmul" not in flat
    assert "conv-to-nhwc" in flat and "conv-to-nhwc" not in packed
    assert make_pass("split-reduction-dim", tile=64).options == {"tile": 64}
    with pytest.raises(KeyError, match="unknown pass"):
        make_pass("patchify-conv-to-matmul")


# the 20 tl evaluators the port took from the JAX executor: (op, operand
# shapes, builder of the op over the operands)
def _eval_cases():
    def unary(name):
        return ((8, 16),), lambda b, x: b.unary(name, x)

    def binary(name):
        return ((8, 16), (8, 1)), lambda b, x, y: b.binary(name, x, y)
    cases = {n: unary(f"tl.{n}") for n in (
        "identity", "exp", "negate", "square", "sqrt", "rsqrt", "tanh",
        "gelu_tanh")}
    cases.update({n: binary(f"tl.{n}") for n in ("sub", "div", "max")})
    cases.update({
        "fill": (((8, 16),), lambda b, x: b.fill(x, 1.5)),
        "zero": (((8, 16),), lambda b, x: b.zero(x)),
        "cast": (((8, 16),), lambda b, x: b.cast(
            x, "bf16" if x.type.dtype == "f32" else "f32")),
        "reduce-sum": (((4, 8, 16),), lambda b, x: b.reduce(
            x, "sum", (2,), keepdims=True)),
        "reduce-max": (((4, 8, 16),), lambda b, x: b.reduce(
            x, "max", (0, 2), keepdims=False)),
        "brgemm": (((3, 8, 32), (3, 32, 16), (8, 16)),
                   lambda b, x, w, c: b.brgemm(x, w, c)),
        "vnni_brgemm": (((3, 8, 32), (3, 16, 16, 2), (8, 16)),
                        lambda b, x, w, c: b.vnni_brgemm(x, w, c)),
        "max_pool2d": (((2, 3, 8, 8),), lambda b, x: b.pool2d(
            "tl.max_pool2d", x, (2, 2))),
        "avg_pool2d": (((2, 3, 9, 9),), lambda b, x: b.pool2d(
            "tl.avg_pool2d", x, (3, 3), (2, 2))),
        "generic": (((8, 16), (16,)), lambda b, x, v: b.generic(
            [x, v], x, [(0, 1), (1,), (0, 1)], ("parallel", "parallel"),
            ("mul", ("arg", 0), ("arg", 1)))),
    })
    return cases


EVAL_CASES = _eval_cases()


def _one_op(ir, shapes, build, dtype):
    m = ir.Module()
    f = m.add(ir.Function("entry", [ir.TensorType(s, dtype)
                                    for s in shapes],
                          [f"a{i}" for i in range(len(shapes))]))
    f.returns = [build(ir.TppBuilder(f), *f.args)]
    m.verify()
    return m["entry"].ops[-1]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_tl_evaluators_match_the_reference(name, dtype):
    shapes, build = EVAL_CASES[name]
    op = _one_op(port_ir, shapes, build, dtype)
    ref_op = _one_op(jax_ir, shapes, build, dtype)
    positive = name in ("sqrt", "rsqrt", "div")
    ins = [_np(s, i, dtype, positive) for i, s in enumerate(shapes)]
    got = _eval_tl(op, [to_torch(a) for a in ins])
    want = jax_eval_tl(ref_op, [jnp.asarray(a) for a in ins], False)
    assert str(got.dtype).split(".")[-1].replace("float32", "f32").replace(
        "bfloat16", "bf16") == op.result.type.dtype
    assert _err(got, want) <= (1e-6 if got.dtype == torch.float32
                               else 1e-2)


def _conv_bn_pool(channels=128, hw=8):
    """JAX tests/frontend/test_torch_import.py:88's stack."""
    torch.manual_seed(4)
    model = torch.nn.Sequential(
        torch.nn.Conv2d(channels, channels, 3, padding=1),
        torch.nn.BatchNorm2d(channels),
        torch.nn.ReLU(),
        torch.nn.MaxPool2d(2),
        torch.nn.AvgPool2d(2),
        torch.nn.Flatten(),
        torch.nn.Linear(channels * (hw // 4) ** 2, 10),
    )
    model.eval()
    with torch.no_grad():
        model[1].running_mean.uniform_(-0.5, 0.5)
        model[1].running_var.uniform_(0.5, 1.5)
    return model


@pytest.mark.parametrize("precision,tol", [("highest", 2e-3),
                                           ("default", 3e-2)])
def test_conv_bn_pool_stack(precision, tol):
    """The imported conv-BN-ReLU-pool-pool-Linear stack lowers as the JAX
    package's does (the conv on the NHWC kernel, the pools left on NCHW as
    their attrs say) and matches the torch module and the JAX run."""
    model = _conv_bn_pool()
    x = torch.randn(2, 128, 8, 8)
    with torch.no_grad():
        want = model(x).numpy()
    port = import_torch(model, (2, 128, 8, 8))
    ref = jax_import_torch(model, (2, 128, 8, 8))
    if precision != "default":
        port.attrs["precision"] = ref.attrs["precision"] = precision
    loops = port_compile(import_torch(model, (2, 128, 8, 8)),
                         device="cpu")(x)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    s = str(port)
    assert _strip_tiles(s) == _strip_tiles(str(ref))
    assert 'layout = "conv_nhwc"' in s and "tl.max_pool2d" in s \
        and "tl.avg_pool2d" in s
    got = port_compile(port, device="cpu")(x)
    jax_got = jax_compile(ref, jit=False)(jnp.asarray(x.numpy()))
    assert _err(loops, want) <= 1e-5
    assert _err(got, want) <= tol
    assert _err(got, jax_got) <= tol
    np.testing.assert_allclose(np.asarray(jax_got, np.float32), want,
                               atol=2e-3, rtol=2e-3)


TIMED = """func @entry(%x: tensor<8x16xf32>) {
  %t0 = perf.timer_start : tensor<i64>
  %0 = tl.relu %x : tensor<8x16xf32>
  perf.sink %0
  %e = perf.timer_stop %t0 : tensor<f32>
  return %0, %e : tensor<8x16xf32>, tensor<f32>
}
"""


def test_perf_timers_run_through_the_pipeline():
    """The reference's host timers (perf.timer_start/stop, perf.sink) pass
    default-tpp-passes and run: the port's executor evaluates every op of
    the IR, so verify-slice keeps no list of runnable ops."""
    m = port_ir.parse_module(TIMED)
    run_pipeline(m, "default-tpp-passes")
    x = torch.randn(8, 16)
    out, seconds = port_compile(m, device="cpu")(x)
    assert torch.equal(out, torch.relu(x))
    assert seconds.dtype == torch.float32 and 0 <= float(seconds) < 60
