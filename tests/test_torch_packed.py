"""Packed parity mode (default-tpp-passes-packed) on the port against the JAX
package, on the CPU.

  * data movement: the port's tl.pack / tl.unpack / tl.vnni_pack
    evaluators and apply_pack_recipe against the reference's `_pack_val`,
    `_unpack_val`, tl.vnni_pack evaluator and `apply_pack_recipe`, bit for
    bit, in f32 and bf16; every packed constant of a lowered module, made
    by both executors, bit for bit;
  * the pipeline: the port's default-tpp-passes-packed prints the
    reference's IR (tile hints stripped) for tpp-gen MLPs, convnets, the
    imported ResNet block, a ViT and the pack/unpack micro-kernels; tpp-gen
    --tiles under the default pipeline; NHWC nets lower as in flat mode;
  * the plain versions of B19, B20 and B23 (xsmm/reference.py) against the
    reference's Pallas kernels in interpret mode;
  * whole runs: run_module lowered and at --linalg-to-loops against the
    reference's run_module, through tpp_run and the bench driver (an
    entry's `pipeline`, and `file` entries); extract_bench_kernel's B20
    key where the reference's gives one, and None where the Hopper
    shared-memory gate refuses the row panel.

Error measure: max|port - jax| / max|jax|. Tolerances: the plain versions
1e-5 in f32 (the same products; f32 "default" compared with the JAX
operands rounded to bf16, since interpret mode keeps exact f32: sum order
only) and 1e-2 for a bf16 output (one rounding, which a sum-order
difference can flip). Whole runs: 1e-4 at precision "highest" and at
--linalg-to-loops in f32; 1e-2 in f32 "default" (the port's products see
bf16 operands, interpret mode's exact f32) and in bf16; the pack/unpack
rows bit-exact.
"""

import dataclasses
import io
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu.ir import parse_module as jax_parse
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.runtime.executor import _eval_tl as jax_eval_tl
from tpp_mlir_tpu.runtime.executor import _pack_val, _unpack_val
from tpp_mlir_tpu.runtime.executor import \
    extract_bench_kernel as jax_extract_bench_kernel
from tpp_mlir_tpu.runtime.tensor_init import \
    apply_pack_recipe as jax_apply_pack_recipe
from tpp_mlir_tpu.runtime.tensor_init import tensor_init as jax_tensor_init
from tpp_mlir_tpu.tools.bench_driver import build_module as jax_build_module
from tpp_mlir_tpu.tools.mlir_gen import build_parser as jax_gen_parser
from tpp_mlir_tpu.tools.mlir_gen import config_from_args as jax_gen_config
from tpp_mlir_tpu.tools.mlir_gen import generate_text as jax_generate
from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime.executor import (_eval_constant, _eval_tl,
                                                 extract_bench_kernel)
from tpp_mlir_tpu_torch.runtime.tensor_init import (apply_pack_recipe,
                                                    tensor_init, to_torch)
from tpp_mlir_tpu_torch.tools import bench_driver
from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser, config_from_args,
                                               generate_text)
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import (BlockedMatmulKey, ConvBrgemmKey,
                                     blocked_warm_fits_smem, build_kernel)
from tpp_mlir_tpu_torch.xsmm.reference import (blocked_matmul_reference,
                                               conv_brgemm_reference,
                                               mxu_dtype)

ROOT = Path(__file__).resolve().parents[1]
PACKED = "default-tpp-passes-packed"
MLIR = ROOT / "benchmarks" / "mlir"


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits (bf16 as int16), to compare with a numpy array's."""
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


# ---------------------------------------------------------------------------
# data movement and the packed constants
# ---------------------------------------------------------------------------

# (shape, pack attributes): a 1-D pack (a bias), the MLP's 2-D packs (A and
# C, and B with outer_perm), the conv's channel packs, the micro-kernels'
PACKS = {
    "1d-bias": ((1024,), dict(inner_dims=(0,), inner_tiles=(512,))),
    "2d-act": ((32, 64), dict(inner_dims=(0, 1), inner_tiles=(8, 32))),
    "2d-weight-outer-perm": ((64, 96), dict(inner_dims=(0, 1),
                                            inner_tiles=(32, 32),
                                            outer_perm=(1, 0))),
    "nchw-channels": ((2, 32, 5, 5), dict(inner_dims=(1,),
                                          inner_tiles=(16,))),
    "fchw-weight": ((32, 16, 3, 3), dict(inner_dims=(0, 1),
                                         inner_tiles=(16, 8),
                                         outer_perm=(0, 1, 2, 3))),
}


def _rand(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bf16" else a


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(PACKS))
def test_pack_and_unpack_match_the_reference_bit_for_bit(name, dtype):
    from tpp_mlir_tpu_torch.ir import Function, Module, TensorType, \
        TppBuilder
    shape, attrs = PACKS[name]
    x = _rand(shape, dtype)
    m = Module()
    f = m.add(Function("entry", [TensorType(shape, dtype)], ["x"]))
    b = TppBuilder(f)
    packed = b.pack(f.args[0], attrs["inner_dims"], attrs["inner_tiles"],
                    outer_perm=attrs.get("outer_perm"))
    f.returns = [packed, b.unpack(packed, attrs["inner_dims"],
                                  attrs["inner_tiles"], shape,
                                  outer_perm=attrs.get("outer_perm"))]
    pack_op, unpack_op = f.ops[-2:]
    xt = to_torch(x)
    got = _eval_tl(pack_op, [xt])
    want = _pack_val(jnp.asarray(x), attrs)
    assert np.array_equal(_bits(got), _np_bits(want))
    back = _eval_tl(unpack_op, [got])
    assert np.array_equal(_bits(back), _np_bits(
        _unpack_val(want, attrs, shape)))
    assert torch.equal(back, xt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 48), (2, 2, 32, 16)],
                         ids=["2d", "blocked"])
def test_vnni_pack_matches_the_reference_bit_for_bit(shape, dtype):
    from tpp_mlir_tpu.ir import Function as JF, Module as JM, \
        TensorType as JT, TppBuilder as JB
    from tpp_mlir_tpu_torch.ir import Function, Module, TensorType, \
        TppBuilder
    x = _rand(shape, dtype, seed=1)
    out = shape[:-2] + (shape[-2] // 2, shape[-1], 2)

    def vnni_op(F, M, T, B):
        m = M()
        f = m.add(F("entry", [T(shape, dtype)], ["x"]))
        x = f.args[0]
        f.returns = [B(f).create("tl.vnni_pack", [x],
                                 [x.type.with_shape(out)], {"vnni": 2})
                     .result]
        return f.ops[-1]
    got = _eval_tl(vnni_op(Function, Module, TensorType, TppBuilder),
                   [to_torch(x)])
    want = jax_eval_tl(vnni_op(JF, JM, JT, JB), [jnp.asarray(x)], True)
    assert got.shape == out
    assert np.array_equal(_bits(got), _np_bits(want))


RECIPES = {
    "weight-outer-perm": ((64, 96), dict(pack_inner_dims=(0, 1),
                                         pack_inner_tiles=(32, 32),
                                         pack_outer_perm=(1, 0))),
    "weight-vnni": ((64, 96), dict(pack_inner_dims=(0, 1),
                                   pack_inner_tiles=(32, 32),
                                   pack_outer_perm=(1, 0), pack_vnni=2)),
    "bias-1d": ((96,), dict(pack_inner_dims=(0,), pack_inner_tiles=(32,))),
    "conv-weight": ((32, 16, 3, 3), dict(pack_inner_dims=(0, 1),
                                         pack_inner_tiles=(16, 16),
                                         pack_outer_perm=(0, 1, 2, 3))),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(RECIPES))
def test_apply_pack_recipe_matches_the_reference_bit_for_bit(name, dtype):
    shape, attrs = RECIPES[name]
    got = apply_pack_recipe(tensor_init("normal", shape, dtype, seed=3),
                            attrs)
    want = jax_apply_pack_recipe(jax_tensor_init("normal", shape, dtype,
                                                 seed=3), attrs)
    assert np.array_equal(_bits(got), _np_bits(want))


def _gen(flags: str, ref=False):
    if ref:
        return jax_parse(jax_generate(jax_gen_config(
            jax_gen_parser().parse_args(flags.split()))))
    return parse_module(generate_text(config_from_args(
        build_parser().parse_args(flags.split()))))


# slice models at small size: tpp-gen flags, a bench-driver model entry, or
# an IR file of benchmarks/mlir
MODELS = {
    "mlp-f32-1": "--batch=16 --layers=1024,1024 --bias --relu",
    "mlp-bf16-1": "--batch=16 --layers=1024,1024 --bias --relu "
                  "--float-type=bf16",
    "mlp-f32-3": "--batch=16 --layers=1024,1024,1024,1024 --bias --relu",
    "mlp-bf16-3": "--batch=16 --layers=1024,1024,1024,1024 --bias --relu "
                  "--float-type=bf16",
    "conv3x3-cb1": 'convnet:{"batch": 2, "channels": 16, "filters": 16, '
                   '"height": 8, "width": 8}',
    "conv3x3-cb2": 'convnet:{"batch": 1, "channels": 256, "filters": 256, '
                   '"height": 5, "width": 5}',
    "conv3x3-bf16": 'convnet:{"batch": 2, "channels": 16, "filters": 16, '
                    '"height": 8, "width": 8, "float_type": "bf16"}',
    "conv-2layer": 'convnet:{"batch": 2, "channels": 16, "filters": 16, '
                   '"height": 8, "width": 8, "layers": 2}',
    "conv1x1": 'convnet:{"batch": 2, "channels": 32, "filters": 32, '
               '"height": 14, "width": 14, "kernel": 1}',
    "resnet_block": 'resnet_block:{"batch": 2, "channels": 16, "hw": 6}',
    "resnet_block-bf16": 'resnet_block:{"batch": 2, "channels": 16, '
                         '"hw": 6, "dtype": "bf16"}',
    "vit": 'vit:{"batch": 8, "image": 32, "patch": 4, "embed": 64, '
           '"heads": 2, "layers": 1}',
    "vit-bf16": 'vit:{"batch": 8, "image": 32, "patch": 4, "embed": 64, '
                '"heads": 2, "layers": 1, "dtype": "bf16"}',
    "pack-a": "fp32-pack-gemm-operand-a-512x1024.mlir",
    "pack-b": "fp32-pack-gemm-operand-b-512x1024.mlir",
    "unpack-a": "fp32-unpack-gemm-operand-a-512x512.mlir",
}


def _build(name, ref=False):
    spec = MODELS[name]
    if spec.startswith("--"):
        return _gen(spec, ref)
    if spec.endswith(".mlir"):
        text = (MLIR / spec).read_text()
        return jax_parse(text) if ref else parse_module(text)
    entry = {"model": spec}
    return jax_build_module(entry) if ref else \
        bench_driver.build_module(entry)


def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


def _invokes(module):
    return [op.opname for op in module["entry"].ops
            if op.opname.startswith("xsmm.")
            and not op.opname.endswith("_dispatch")]


def _layouts(module):
    return [op.attrs.get("layout", "flat") for op in module["entry"].ops
            if op.opname in ("xsmm.brgemm_dispatch",
                             "xsmm.fused_brgemm_dispatch")]


# what each model must lower to: the B19 and B23 invokes
LAYOUTS = {"mlp-f32-1": ["blocked"], "mlp-bf16-1": ["blocked"],
           "mlp-f32-3": ["blocked"] * 3, "mlp-bf16-3": ["blocked"] * 3,
           "conv3x3-cb1": ["conv"], "conv3x3-cb2": ["conv"],
           "conv3x3-bf16": ["conv"], "conv-2layer": ["conv"] * 2,
           "conv1x1": [], "resnet_block": ["conv"] * 2,
           "resnet_block-bf16": ["conv"] * 2, "vit": ["blocked"] * 6,
           "vit-bf16": ["blocked"] * 6, "pack-a": [], "pack-b": [],
           "unpack-a": []}


@pytest.mark.filterwarnings("ignore:enable_nested_tensor")
@pytest.mark.parametrize("name", list(MODELS))
def test_packed_pipeline_matches_the_reference(name):
    port, ref = _build(name), _build(name, ref=True)
    assert str(port) == str(ref)
    run_pipeline(port, PACKED)
    jax_run_pipeline(ref, PACKED)
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    layouts = _layouts(port)
    # every dispatch once: the invokes of one dispatch share it
    assert sorted(set(layouts)) == sorted(set(LAYOUTS[name]))


def test_mlp_chain_stays_blocked_end_to_end():
    """propagate-pack and simplify-pack keep the flagship's chain blocked:
    one tl.pack, three blocked GEMMs, one tl.unpack."""
    m = _build("mlp-bf16-3")
    run_pipeline(m, PACKED)
    ops = [op.opname for op in m["entry"].ops]
    assert ops.count("tl.pack") == 1 and ops.count("tl.unpack") == 1
    assert _invokes(m) == ["xsmm.fused_brgemm"] * 3
    disp = next(op.attrs for op in m["entry"].ops
                if op.opname == "xsmm.fused_brgemm_dispatch")
    assert (disp["Mb"], disp["Nb"], disp["batch"], disp["m"], disp["n"],
            disp["k"], disp["vnni"]) == (1, 2, 2, 16, 512, 512, 2)
    assert disp["flags"] == ("beta_0",) and disp["binary_bcast"] == \
        "bcast_col"


@pytest.mark.parametrize("flags", [
    "--batch=16 --layers=64,64,64 --bias --relu --tiles=8,32,32",
    "--batch=16 --layers=64,64 --tiles=8,32,32 --float-type=bf16"],
    ids=["f32-bias-relu", "bf16"])
def test_tiles_under_the_default_pipeline_match_the_reference(flags):
    """tpp-gen --tiles emits tl.blocked_matmul directly (models/mlp.py:68),
    another way into B19 under the default pipeline."""
    port, ref = _gen(flags), _gen(flags, ref=True)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    assert set(_layouts(port)) == {"blocked"}


@pytest.mark.parametrize("model", [
    'convnet:{"batch": 2, "channels": 16, "filters": 16, "height": 8, '
    '"width": 8, "layout": "nhwc"}',
    'convnet:{"batch": 2, "channels": 16, "filters": 16, "height": 8, '
    '"width": 8, "layout": "nhwc", "padding": "same", "layers": 2, '
    '"residual": true}'], ids=["nhwc", "nhwc-same-residual"])
def test_nhwc_nets_lower_as_in_flat_mode(model):
    flat, packed = (bench_driver.build_module({"model": model})
                    for _ in range(2))
    run_pipeline(flat, "default-tpp-passes")
    run_pipeline(packed, PACKED)
    assert str(flat) == str(packed)
    assert set(_layouts(packed)) == {"conv_nhwc"}


@pytest.mark.filterwarnings("ignore:enable_nested_tensor")
@pytest.mark.parametrize("name", ["mlp-bf16-1", "resnet_block-bf16",
                                  "vit-bf16", "conv3x3-cb2"])
def test_packed_constants_match_the_reference_bit_for_bit(name):
    """Every tl.constant of the lowered module (packed recipes, VNNI,
    packed literals) as both executors make it, bit for bit."""
    port, ref = _build(name), _build(name, ref=True)
    run_pipeline(port, PACKED)
    jax_run_pipeline(ref, PACKED)
    pc = [op for op in port["entry"].ops if op.opname == "tl.constant"]
    rc = [op for op in ref["entry"].ops if op.opname == "tl.constant"]
    assert len(pc) == len(rc) and any("pack_inner_dims" in op.attrs
                                      for op in pc)
    for p, r in zip(pc, rc):
        got = _eval_constant(p, "cpu")
        want = jax_eval_tl(r, [], True)
        assert np.array_equal(_bits(got), _np_bits(want)), p.attrs


# ---------------------------------------------------------------------------
# B19, B20 and B23: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _bkey(**kw):
    base = dict(Mb=2, Nb=2, Kb=2, mb=8, nb=32, kb=32, precision="highest")
    return BlockedMatmulKey(**{**base, **kw})


BLOCKED = {
    "bias-relu": _bkey(beta0=True, binary_kind="add", unary_kind="relu"),
    "c-acc-gelu": _bkey(binary_kind="add", unary_kind="gelu"),
    "c-acc-only": _bkey(Mb=1, Nb=3, Kb=1, mb=16, nb=24, kb=48),
    "f32-default-bias": _bkey(precision="default", beta0=True,
                              binary_kind="add", unary_kind="relu"),
    "bf16-vnni-bias-relu": _bkey(dtype="bf16", precision="default",
                                 beta0=True, vnni=2, binary_kind="add",
                                 unary_kind="relu"),
    "bf16-out-f32-gelu": _bkey(dtype="bf16", out_dtype="f32",
                               precision="default", vnni=2,
                               binary_kind="add", unary_kind="gelu"),
    "bf16-flat-b": _bkey(dtype="bf16", precision="default", beta0=True),
}
WARM = {f"{d}-r{r}": _bkey(dtype=d, vnni=2 if d == "bf16" else 0,
                           precision="highest" if d == "f32" else "default",
                           beta0=True, binary_kind="add", unary_kind="relu",
                           repeats=r)
        for d in ("f32", "bf16") for r in (1, 2, 3)}
# base.json's fc_fp32_packed_warm_1024 key: f32 operands on bf16 products,
# the state re-rounded to bf16 every repeat
WARM.update({f"f32-default-r{r}": _bkey(
    precision="default", beta0=True, binary_kind="add", unary_kind="relu",
    repeats=r) for r in (1, 2, 3)})


def _blocked_operands(key, seed=7):
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0, dt=key.dtype):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if dt == "bf16" else a
    K = key.Kb * key.kb
    a = arr((key.Mb, key.Kb, key.mb, key.kb))
    b = arr((key.Nb, key.Kb, key.kb, key.nb), K ** -0.5)
    if key.vnni:
        b = np.ascontiguousarray(np.moveaxis(b.reshape(
            key.Nb, key.Kb, key.kb // 2, 2, key.nb), -2, -1))
    c = None if key.beta0 else arr((key.Mb, key.Nb, key.mb, key.nb), dt="f32")
    d = arr((key.Nb, key.nb), dt="f32") if key.binary_kind else None
    return a, b, c, d


def _bf16_round(x):
    return np.asarray(x).astype(ml_dtypes.bfloat16).astype(np.float32)


def _jax_kernel(key, ref_type, args):
    """The reference's interpret-mode kernel on the same operands; f32
    "default" operands rounded to bf16 first (interpret mode keeps f32),
    and for B20 each repeat's state too: one repeat at a time."""
    a, b = args[:2]
    rounded = key.dtype == "f32" and key.precision == "default"
    if rounded:
        a, b = _bf16_round(a), _bf16_round(b)
    reps = getattr(key, "repeats", 0)
    fields = dataclasses.asdict(key)
    if rounded and reps:
        fields["repeats"] = 1
    fn = jax_build_kernel(ref_type(**fields), interpret=True)
    if rounded and reps:
        for _ in range(reps):
            a = _bf16_round(fn(*(None if x is None else jnp.asarray(x)
                                 for x in (a, b, *args[2:]))))
        return a
    return fn(*(None if x is None else jnp.asarray(x)
                for x in (a, b, *args[2:])))


def _tol(key):
    """A bf16 output, or a B20 state held in bf16 (where a sum-order
    difference can flip a rounding), 1e-2; else 1e-5."""
    bf16_state = getattr(key, "repeats", 0) and key.precision == "default"
    return 1e-2 if (key.out_dtype or key.dtype) == "bf16" or bf16_state \
        else 1e-5


@pytest.mark.parametrize("name", [*BLOCKED, *WARM])
def test_blocked_matmul_plain_matches_pallas_interpret(name):
    key = BLOCKED.get(name) or WARM[name]
    args = _blocked_operands(key)
    want = _jax_kernel(key, ref_flags.BlockedMatmulKey, args)
    targs = [None if x is None else to_torch(x) for x in args]
    got = blocked_matmul_reference(key)(*targs)
    assert got.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[
        key.out_dtype or key.dtype]
    assert _err(got, want) <= _tol(key)
    if key.repeats:                  # B20's state is held in the MXU dtype
        assert torch.equal(got, got.to(mxu_dtype(key.dtype, key.precision))
                           .to(got.dtype))
    kern = build_kernel(key)         # the wrapper on CPU tensors: the plain
    assert torch.equal(kern(*targs), got) and kern.launches == 0


def _ckey(**kw):
    base = dict(N=2, H=8, W=7, Cb=1, c=16, Kb=1, k=16, R=3, S=3,
                precision="highest")
    return ConvBrgemmKey(**{**base, **kw})


CONVS = {
    "cb1-3x3-c-acc": _ckey(),
    "cb2-1x1-bias-relu": _ckey(Cb=2, Kb=2, R=1, S=1, beta0=True,
                               binary_kind="add", unary_kind="relu"),
    "cb2-3x3-c-acc-relu": _ckey(Cb=2, Kb=2, c=8, k=24, unary_kind="relu"),
    "f32-default-bias": _ckey(precision="default", beta0=True,
                              binary_kind="add", unary_kind="relu"),
    "bf16-cb2-bias-relu": _ckey(dtype="bf16", precision="default", Cb=2,
                                Kb=2, beta0=True, binary_kind="add",
                                unary_kind="relu"),
}


def _conv_operands(key, seed=9):
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0, dt=key.dtype):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if dt == "bf16" else a
    i = arr((key.N, key.Cb, key.H, key.W, key.c))
    w = arr((key.Kb, key.Cb, key.R, key.S, key.c, key.k),
            (key.Cb * key.c * key.R * key.S) ** -0.5)
    c = None if key.beta0 else arr((key.N, key.Kb, key.P, key.Q, key.k),
                                   dt="f32")
    d = arr((key.Kb, key.k), dt="f32") if key.binary_kind else None
    return i, w, c, d


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_brgemm_plain_matches_pallas_interpret(name):
    key = CONVS[name]
    args = _conv_operands(key)
    want = _jax_kernel(key, ref_flags.ConvBrgemmKey, args)
    targs = [None if x is None else to_torch(x) for x in args]
    got = conv_brgemm_reference(key)(*targs)
    assert got.shape == (key.N, key.Kb, key.P, key.Q, key.k)
    assert _err(got, want) <= _tol(key)


@pytest.mark.parametrize("key,err,why", [
    (_ckey(stride_h=2, stride_w=2), NotImplementedError,
     "stride>1 conv stays on the XLA conv path"),
    (_bkey(binary_kind="add", binary_bcast="bcast_row"), ValueError,
     "bcast_col"),
    (_bkey(beta0=True, Nb=3, repeats=2), ValueError, "square feedback"),
], ids=["conv-stride2", "blocked-row-bias", "warm-not-square"])
def test_packed_keys_outside_the_kernels_raise(key, err, why):
    with pytest.raises(err, match=why):
        build_kernel(key)


# ---------------------------------------------------------------------------
# whole runs against the reference
# ---------------------------------------------------------------------------

def _run_tol(name, precision, l2l):
    if name.startswith(("pack", "unpack")):
        return 0.0
    bf16 = "bf16" in name
    if l2l:
        return 1e-2 if bf16 else 1e-4
    return 1e-2 if bf16 or precision == "default" else 1e-4


RUNS = [(name, precision) for name in MODELS
        for precision in (("default",) if "bf16" in name
                          or name.startswith(("pack", "unpack"))
                          else ("default", "highest"))
        if not name.endswith("-3")]


@pytest.mark.filterwarnings("ignore:enable_nested_tensor")
@pytest.mark.parametrize("l2l", [False, True], ids=["lowered", "l2l"])
@pytest.mark.parametrize("name,precision", RUNS,
                         ids=[f"{n}-{p}" for n, p in RUNS])
def test_run_module_matches_the_reference(name, precision, l2l):
    port, ref = _build(name), _build(name, ref=True)
    port.attrs["precision"] = ref.attrs["precision"] = precision
    pipeline = "default-tpp-passes" if name.startswith(("pack", "unpack")) \
        else PACKED
    got = run_module(port, seed=2, device="cpu", linalg_to_loops=l2l,
                     pipeline=pipeline, out_stream=io.StringIO())
    want = jax_run_module(ref, seed=2, linalg_to_loops=l2l,
                          pipeline=pipeline, out_stream=io.StringIO())
    got, want = got["outputs"][0], want["outputs"][0]
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= _run_tol(name, precision, l2l)


def test_run_module_times_a_packed_fc_in_a_loop_on_the_cpu():
    """The flagship through the packed pipeline with -n: one tl.pack,
    three blocked GEMMs, one tl.unpack; off the card the loop lowering
    times it."""
    res = run_module(_build("mlp-f32-3"), n=2, device="cpu",
                     pipeline=PACKED, out_stream=io.StringIO())
    assert res["bench"] == "loop" and res["mean_seconds"] > 0
    assert _invokes(res["module"]) == ["xsmm.fused_brgemm"] * 3


@pytest.mark.parametrize("flags,precision,port_gate", [
    ("--batch=256 --layers=1024,1024 --bias --relu", "default", True),
    ("--batch=256 --layers=1024,1024 --bias --relu --float-type=bf16",
     "default", True),
    ("--batch=16 --layers=1024,1024", "highest", True),
    # f32 "highest" at K = 1856: the reference's VMEM (16 MiB) holds it,
    # B20's two row panels (2 x 16 x 1864 x 4 B = 233 KB) do not fit a
    # Hopper block's 227 KB: the loop lowering
    ("--batch=16 --layers=1856,1856 --bias --relu", "highest", False),
    # not square: neither has a warm bench
    ("--batch=16 --layers=1024,512 --bias --relu", "default", None),
], ids=["fc-f32", "fc-bf16", "gemm-f32-highest", "gate-refuses", "nonsquare"])
def test_extract_bench_kernel_matches_the_reference(flags, precision,
                                                    port_gate):
    port, ref = _gen(flags), _gen(flags, ref=True)
    port.attrs["precision"] = ref.attrs["precision"] = precision
    run_pipeline(port, PACKED)
    jax_run_pipeline(ref, PACKED)
    got = extract_bench_kernel(port)
    want = jax_extract_bench_kernel(ref)
    if port_gate is None:
        assert got is None and want is None
        return
    assert want is not None
    assert isinstance(want[0], ref_flags.BlockedMatmulKey)
    if not port_gate:
        assert got is None
        assert not blocked_warm_fits_smem(BlockedMatmulKey(
            **dataclasses.asdict(want[0])))
        return
    assert dataclasses.astuple(got[0]) == dataclasses.astuple(want[0])
    assert hasattr(got[1], "post")      # the tl.unpack tail


def test_warm_bench_operands_and_post_match_the_unpacked_run():
    """B20's operands and its tl.unpack tail: one repeat through the
    plain version equals the module's own output."""
    from tpp_mlir_tpu_torch.tools.tpp_run import init_args
    m = _gen("--batch=16 --layers=1024,1024 --bias --relu")
    m.attrs["precision"] = "highest"
    run_pipeline(m, PACKED)
    key, get_operands = extract_bench_kernel(m)
    args = init_args(m, "entry", "normal", 0, "cpu")
    ops = get_operands(args)
    out = get_operands.post(build_kernel(dataclasses.replace(
        key, repeats=1))(*ops))
    want = run_module(m, device="cpu", linalg_to_loops=True,
                      out_stream=io.StringIO())["outputs"][0]
    assert out.shape == (16, 1024)
    assert _err(out, want.numpy()) <= 1e-4


def test_bench_driver_honours_the_entry_pipeline():
    """The repair: an entry's `pipeline` reaches the pass manager (it was
    ignored, so base.json's packed rows ran the flat pipeline)."""
    entry = {"gen": "--batch=16 --layers=1024,1024 --bias --relu",
             "pipeline": PACKED, "iters": 1}
    res = bench_driver.run_entry(entry, device="cpu",
                                 out_stream=io.StringIO())
    low = res["lowered"]
    assert _layouts(low["module"]) == ["blocked"]
    assert low["mean_seconds"] > 0
    assert _err(low["outputs"][0],
                res["baseline"]["outputs"][0].numpy()) <= 1e-2
    flat = bench_driver.run_entry({**entry, "pipeline": "default-tpp-passes"},
                                  device="cpu", out_stream=io.StringIO())
    assert _layouts(flat["lowered"]["module"]) == ["flat"]


@pytest.mark.parametrize("row", ["pack_gemm_operand_a_fp32",
                                 "pack_gemm_operand_b_fp32",
                                 "unpack_gemm_operand_a_fp32"])
def test_bench_driver_runs_the_file_entries(row):
    """mha.json's pack/unpack rows are `file` entries relative to the
    config's directory (they raised before); bit-exact against
    --linalg-to-loops and the reference's run."""
    entry = next(e for e in bench_driver.load_config(
        str(ROOT / "benchmarks" / "configs" / "mha.json")) if e["name"] == row)
    res = bench_driver.run_entry(entry, n=2, device="cpu",
                                 out_stream=io.StringIO())
    got = res["lowered"]["outputs"][0]
    assert torch.equal(got, res["baseline"]["outputs"][0])
    ref = jax_build_module(entry)
    want = jax_run_module(ref, seed=0, out_stream=io.StringIO())["outputs"][0]
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert res["lowered"]["bench"] == "loop"
