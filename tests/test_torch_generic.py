"""tl.generic on the port against the JAX package, on the CPU: the 11 tests
of tests/ir/test_generic.py, each on the port's copy (verifier, round trip,
classification, map-based broadcast flags, degeneralize and
generalize-named-ops, direct generic -> xsmm lowering, the generic-form
MLP, tpp-gen --output=generic), held to the JAX package.

`ir/affine.py eval_generic` against the JAX package's on the same seeded
numpy inputs: f32 1e-6 and bf16 1e-2 (max|port - jax| / max|jax|). The
passes print the same IR as the JAX package's (tile hints stripped).
Lowered runs take f32 "highest" where they are held to exact f32 (true f32
on both sides); the port's f32 "default" rounds operands to bf16, as
queue C of ROADMAP.md decides, and is held at 1e-2.
"""

import io
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.ir as jax_ir
from tpp_mlir_tpu.ir.affine import eval_generic as jax_eval_generic
from tpp_mlir_tpu.models.mlp import build_mlp as jax_build_mlp
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.runtime import compile as jax_compile
from tpp_mlir_tpu.tools.mlir_gen import generate_text as jax_generate_text
from tpp_mlir_tpu_torch.ir import parse_module, print_module
from tpp_mlir_tpu_torch.ir.affine import (classify_generic, eval_generic,
                                          infer_bcast_from_map)
from tpp_mlir_tpu_torch.models.mlp import MlpConfig, build_mlp
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime import compile as port_compile
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser, config_from_args,
                                               generate_text)
from tpp_mlir_tpu_torch.tools.tpp_run import run_module


def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


def _np(shape, seed, dtype="f32"):
    a = np.asarray(np.random.default_rng(seed).standard_normal(shape),
                   np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bf16" else a


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _both(text, precision="default"):
    """(port module, JAX module) parsed from the same text."""
    port, ref = parse_module(text), jax_ir.parse_module(text)
    if precision != "default":
        port.attrs["precision"] = ref.attrs["precision"] = precision
    return port, ref


def _generic(module):
    return next(o for o in module["entry"].ops if o.opname == "tl.generic")


GENERIC_MATMUL = """func @entry(%a: tensor<32x64xf32>, %b: tensor<64x48xf32>) {
  %0 = tl.constant {init = "zero"} : tensor<32x48xf32>
  %1 = tl.generic %a, %b, %0 {body = ["add", ["mul", ["arg", 0], ["arg", 1]], ["arg", 2]], indexing_maps = [[0, 2], [2, 1], [0, 1]], iterator_types = ["parallel", "parallel", "reduction"]} : tensor<32x48xf32>
  return %1 : tensor<32x48xf32>
}
"""

ROW_BCAST = """func @entry(%x: tensor<64x64xf32>, %v: tensor<64xf32>) {
  %1 = tl.generic %x, %v, %x {body = ["BODY", ["arg", 0], ["arg", 1]], indexing_maps = [[0, 1], [0], [0, 1]], iterator_types = ["parallel", "parallel"]} : tensor<64x64xf32>
  return %1 : tensor<64x64xf32>
}
"""

GENERIC_BRGEMM = """func @entry(%a: tensor<4x16x32xf32>, %b: tensor<4x32x24xf32>) {
  %0 = tl.constant {init = "zero"} : tensor<16x24xf32>
  %1 = tl.generic %a, %b, %0 {body = ["add", ["mul", ["arg", 0], ["arg", 1]], ["arg", 2]], indexing_maps = [[2, 0, 3], [2, 3, 1], [0, 1]], iterator_types = ["parallel", "parallel", "reduction", "reduction"]} : tensor<16x24xf32>
  return %1 : tensor<16x24xf32>
}
"""

NAMED_FC = """func @entry(%a: tensor<16x32xf32>, %b: tensor<32x24xf32>, %bias: tensor<24xf32>) {
  %0 = tl.constant {init = "zero"} : tensor<16x24xf32>
  %1 = tl.matmul %a, %b, %0 : tensor<16x24xf32>
  %2 = tl.add %1, %bias : tensor<16x24xf32>
  %3 = tl.relu %2 : tensor<16x24xf32>
  return %3 : tensor<16x24xf32>
}
"""


# an eval_generic case: (text, operand shapes); every body head of
# ir/affine.py BODY_OPS and every map class (identity, row and column
# broadcast, scalar, transposed) over the two contraction forms
def _eltwise(body, maps, shapes, out=(8, 16)):
    def t_(shape):
        return "tensor<" + "".join(f"{d}x" for d in shape) + "DT>"
    ins = ", ".join(f"%a{i}" for i in range(len(shapes)))
    sig = ", ".join(f"%a{i}: {t_(s)}" for i, s in enumerate(shapes))
    t = t_(out)
    return (f"func @entry({sig}) {{\n"
            f'  %z = tl.constant {{init = "zero"}} : {t}\n'
            f"  %1 = tl.generic {ins}, %z {{body = {body}, indexing_maps = "
            f"{maps}, iterator_types = [\"parallel\", \"parallel\"]}} : {t}\n"
            f"  return %1 : {t}\n}}\n"), shapes


_A0, _A1 = '["arg", 0]', '["arg", 1]'
EVAL_CASES = {
    **{f"unary-{h}": _eltwise(f'["{h}", {_A0}]', "[[0, 1], [0, 1]]",
                              [(8, 16)])
       for h in ("exp", "negate", "square", "tanh", "gelu", "relu",
                 "identity")},
    "unary-sqrt": _eltwise(f'["sqrt", ["square", {_A0}]]',
                           "[[0, 1], [0, 1]]", [(8, 16)]),
    "unary-rsqrt": _eltwise(f'["rsqrt", ["add", ["square", {_A0}], 1.0]]',
                            "[[0, 1], [0, 1]]", [(8, 16)]),
    "maximumf": _eltwise(f'["maximumf", {_A0}, 0.0]', "[[0, 1], [0, 1]]",
                         [(8, 16)]),
    **{f"binary-{h}": _eltwise(f'["{h}", {_A0}, {_A1}]',
                               "[[0, 1], [0, 1], [0, 1]]",
                               [(8, 16), (8, 16)])
       for h in ("add", "sub", "mul", "max", "min")},
    "binary-div": _eltwise(f'["div", {_A0}, ["add", ["square", {_A1}], 1.0]]',
                           "[[0, 1], [0, 1], [0, 1]]", [(8, 16), (8, 16)]),
    "row-bcast": _eltwise(f'["add", {_A0}, {_A1}]', "[[0, 1], [0], [0, 1]]",
                          [(8, 16), (8,)]),
    "col-bcast": _eltwise(f'["mul", {_A0}, {_A1}]', "[[0, 1], [1], [0, 1]]",
                          [(8, 16), (16,)]),
    "scalar": _eltwise(f'["sub", {_A0}, {_A1}]', "[[0, 1], [], [0, 1]]",
                       [(8, 16), ()]),
    "transposed": _eltwise(f'["add", {_A0}, {_A1}]',
                           "[[0, 1], [1, 0], [0, 1]]", [(8, 16), (16, 8)]),
    "matmul": (GENERIC_MATMUL.replace("f32", "DT"), [(32, 64), (64, 48)]),
    "brgemm": (GENERIC_BRGEMM.replace("f32", "DT"),
               [(4, 16, 32), (4, 32, 24)]),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_generic_roundtrip_and_eval(case, dtype):
    """The port's printer and parser round-trip a generic, and eval_generic
    matches the JAX package's on the same operands."""
    text, shapes = EVAL_CASES[case]
    text = text.replace("DT", dtype)
    port, ref = _both(text)
    port.verify()
    assert print_module(parse_module(print_module(port))) == \
        print_module(port) == jax_ir.print_module(ref)
    ins = [_np(s, seed=i, dtype=dtype) for i, s in enumerate(shapes)]
    op, rop = _generic(port), _generic(ref)
    zero = np.zeros(op.result.type.shape, ins[0].dtype)
    # to_torch gives a 0-d array one dim: shape it back
    got = eval_generic(op, [to_torch(a).reshape(np.shape(a))
                            for a in (*ins, zero)])
    want = jax_eval_generic(rop, [jnp.asarray(a) for a in (*ins, zero)])
    assert got.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    assert _err(got, want) <= (1e-6 if dtype == "f32" else 1e-2)


def test_generic_verifier_rejects():
    bad_cases = [
        GENERIC_MATMUL.replace("[0, 2], [2, 1]", "[0], [2, 1]"),
        GENERIC_MATMUL.replace("[2, 1], [0, 1]", "[2, 1], [0, 2]"),
        GENERIC_MATMUL.replace("[0, 2], [2, 1]", "[0, 0], [2, 1]"),
        GENERIC_MATMUL.replace('["arg", 2]', '["arg", 7]'),
    ]
    for text in bad_cases:
        with pytest.raises(ValueError):
            parse_module(text).verify()


@pytest.mark.parametrize("text,want", [
    (GENERIC_MATMUL, ("contraction", "matmul", False)),
    (GENERIC_BRGEMM, ("contraction", "brgemm", False)),
    (ROW_BCAST.replace("BODY", "add"), ("binary", "add")),
    (EVAL_CASES["maximumf"][0].replace("DT", "f32"), ("unary", "relu")),
], ids=["matmul", "brgemm", "binary", "relu"])
def test_classify_matmul_brgemm_binary(text, want):
    port, ref = _both(text)
    from tpp_mlir_tpu.ir.affine import classify_generic as jax_classify
    assert classify_generic(_generic(port)) == jax_classify(_generic(ref)) \
        == want


def test_infer_bcast_from_map_square_unambiguous():
    from tpp_mlir_tpu.ir.affine import infer_bcast_from_map as jax_infer
    for mp, want in (((1,), "bcast_col"), ((0,), "bcast_row"),
                     ((), "bcast_scalar"), ((0, 1), "none")):
        assert infer_bcast_from_map((0, 1), mp) == jax_infer((0, 1), mp) \
            == want


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_degeneralize_row_broadcast_square(precision):
    """A square row broadcast (map (d0,)): degeneralize inserts the (m, 1)
    reshape (the JAX package's IR), and the lowered run computes
    x + v[:, None], not the column broadcast shapes alone would suggest."""
    text = ROW_BCAST.replace("BODY", "add")
    x, v = _np((64, 64), 0), _np((64,), 1)
    want = x + v[:, None]
    port, ref = _both(text, precision)
    loops = port_compile(parse_module(text), device="cpu")(
        to_torch(x), to_torch(v))
    np.testing.assert_allclose(loops.numpy(), want, atol=1e-6)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    assert "tensor<64x1xf32>" in str(port)
    got = port_compile(port, device="cpu")(to_torch(x), to_torch(v))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_generic_mlp_lowers_to_same_fused_kernel(dtype):
    """tpp-gen --output=generic lowers to the named form's kernels (one
    fused chain) and to the JAX package's IR, and runs bit-equal to the
    named form, lowered and under --linalg-to-loops."""
    cfg = dict(batch=32, layers=(64, 64, 64), bias=True, relu=True,
               kernel="args", float_type=dtype)
    named, gen = build_mlp(MlpConfig(**cfg)), \
        build_mlp(MlpConfig(output="generic", **cfg))
    assert print_module(gen).count("tl.generic") == 6
    ref_gen = jax_build_mlp(MlpConfig(output="generic", **cfg))
    loops = [port_compile(m, device="cpu")
             for m in (build_mlp(MlpConfig(**cfg)),
                       build_mlp(MlpConfig(output="generic", **cfg)))]
    run_pipeline(named, "default-tpp-passes")
    run_pipeline(gen, "default-tpp-passes")
    jax_run_pipeline(ref_gen, "default-tpp-passes")
    assert "tl.generic" not in str(gen)
    assert _strip_tiles(str(gen)) == _strip_tiles(str(ref_gen))
    invokes = [op.opname for op in gen["entry"].ops
               if op.opname.startswith("xsmm.")
               and not op.opname.endswith("_dispatch")]
    assert invokes == ["xsmm.fused_chain"]
    args = [to_torch(_np(a.type.shape, i, dtype))
            for i, a in enumerate(named["entry"].args)]
    on = port_compile(named, device="cpu")(*args)
    og = port_compile(gen, device="cpu")(*args)
    assert torch.equal(on, og)
    assert torch.equal(loops[0](*args), loops[1](*args))


def test_generalize_roundtrip():
    """named -> generic -> named: the JAX package's IR at each step, and
    the same numbers as the named module."""
    args = [_np((16, 32), 0), _np((32, 24), 1), _np((24,), 2)]
    targs = [to_torch(a) for a in args]
    ref_out = port_compile(parse_module(NAMED_FC), device="cpu")(*targs)
    port, ref = _both(NAMED_FC)
    run_pipeline(port, "generalize-named-ops")
    jax_run_pipeline(ref, "generalize-named-ops")
    s = print_module(port)
    assert s == jax_ir.print_module(ref) and s.count("tl.generic") == 3
    assert "tl.matmul" not in s and "tl.add" not in s
    got_g = port_compile(port, device="cpu")(*targs)
    assert torch.equal(got_g, ref_out)
    run_pipeline(port, "degeneralize")
    jax_run_pipeline(ref, "degeneralize")
    s2 = print_module(port)
    assert s2 == jax_ir.print_module(ref) and "tl.generic" not in s2
    assert "tl.matmul" in s2 and "tl.relu" in s2
    got_n = port_compile(port, device="cpu")(*targs)
    assert torch.equal(got_n, ref_out)


def test_direct_generic_to_xsmm():
    """linalg-lowering alone (no degeneralize) matches generics directly,
    with map-derived flags: the JAX package's IR, and the right numbers."""
    port, ref = _both(GENERIC_MATMUL, "highest")
    run_pipeline(port, "linalg-lowering")
    jax_run_pipeline(ref, "linalg-lowering")
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    assert "xsmm.gemm" in str(port) and "tl.generic" not in str(port)
    a, b = _np((32, 64), 0), _np((64, 48), 1)
    got = port_compile(port, device="cpu")(to_torch(a), to_torch(b))
    np.testing.assert_allclose(got.numpy(), a @ b, atol=1e-4, rtol=1e-4)

    port, ref = _both(ROW_BCAST.replace("BODY", "mul"))
    run_pipeline(port, "linalg-lowering")
    jax_run_pipeline(ref, "linalg-lowering")
    assert str(port) == str(ref) and 'bcast_b = "bcast_row"' in str(port)
    x, v = _np((64, 64), 0), _np((64,), 1)
    got = port_compile(port, device="cpu")(to_torch(x), to_torch(v))
    np.testing.assert_allclose(got.numpy(), x * v[:, None], atol=1e-6)


def test_generic_brgemm_classify_and_lower():
    """A generic brgemm lowers to one xsmm.brgemm (B1) as the JAX
    package's does, and sums the batch."""
    port, ref = _both(GENERIC_BRGEMM, "highest")
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    assert "xsmm.brgemm" in str(port)
    a, b = _np((4, 16, 32), 0), _np((4, 32, 24), 1)
    want = np.einsum("bmk,bkn->mn", a, b)
    got = port_compile(port, device="cpu")(to_torch(a), to_torch(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_matcher_generic_predicates():
    from tpp_mlir_tpu_torch.ir.matcher import Matcher
    op = _generic(parse_module(GENERIC_MATMUL))
    mm = (Matcher("tl.generic").num_loops(3).dim(2, "reduction")
          .body_head("add").indexing_map(2, lambda mp: mp == (0, 1)))
    assert mm(op)
    assert not Matcher("tl.generic").num_loops(2)(op)
    assert not Matcher("tl.generic").body_head("mul")(op)


@pytest.mark.parametrize("flags,precision,tol", [
    ("--batch=8 --layers=16,16 --bias --relu", "highest", 1e-5),
    ("--batch=8 --layers=16,16 --bias --relu", "default", 1e-2),
    ("--batch=8 --layers=16,32,16 --bias --relu --float-type=bf16",
     "default", 1e-2),
], ids=["f32-highest", "f32-default", "bf16"])
def test_tpp_gen_output_generic_cli(flags, precision, tol):
    """tpp-gen --output=generic prints the JAX package's text and runs
    through the port's tpp_run on the CPU: the lowered run against JAX's
    tpp_compile(jit=False) of the same text on tpp_run's seeded args."""
    argv = (flags + " --output=generic --kernel=args").split()
    text = generate_text(config_from_args(build_parser().parse_args(argv)))
    from tpp_mlir_tpu.tools.mlir_gen import build_parser as jax_parser
    from tpp_mlir_tpu.tools.mlir_gen import config_from_args as jax_config
    assert text == jax_generate_text(jax_config(jax_parser().parse_args(
        argv)))
    assert "tl.generic" in text and "tl.matmul" not in text
    port, ref = _both(text, precision)
    res = run_module(port, seed=3, device="cpu", out_stream=io.StringIO())
    from tpp_mlir_tpu.tools.tpp_run import init_args as jax_init_args
    want = jax_compile(ref, jit=False)(*jax_init_args(ref, "entry",
                                                      "normal", 3))
    assert _err(res["outputs"][0], want) <= tol
