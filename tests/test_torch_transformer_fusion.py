"""ROADMAP A6: the JAX package's transformer-fusion and returned-value tests
(tests/passes/test_transformer_fusion.py, tests/passes/
test_returned_values.py) mirrored on the port, one test of the same name
each.

Each program (torch_parity_cases.FUSION_CASES, the JAX tests' IR and
inputs) goes
through default-tpp-passes in both packages: the JAX side through its
run_pipeline and runtime.compile, as its tests run it; the port's through
its run_pipeline and runtime.compile (run_module's executor) on the CPU.
Each test asserts the JAX test's own facts on the port's lowered IR, the
two lowered IRs printed equal once the tile hints are stripped
(tests/test_torch_tools.py _strip_tiles), and the port's outputs within
the JAX test's 1e-4 of the JAX outputs and of the port's own
--linalg-to-loops evaluation (runtime.compile of the IR not lowered).
Both modules run at f32 "highest": the JAX package on the CPU computes
true f32 at either precision, and "highest" is the port's f32 (at
"default" its products take bf16 operands, as on the card;
chip_smoke.phase_fusion_parity holds that form).
"""

import numpy as np
import pytest
import torch

import torch_parity_cases as cases
from tpp_mlir_tpu.ir import parse_module as jax_parse_module
from tpp_mlir_tpu.ir import print_module as jax_print_module
from tpp_mlir_tpu.models.transformer_block import \
    build_transformer_block as jax_build_transformer_block
from tpp_mlir_tpu.passes import make_pass as jax_make_pass
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.runtime import compile as jax_compile
from tpp_mlir_tpu_torch.ir import parse_module, print_module
from tpp_mlir_tpu_torch.passes import make_pass, run_pipeline
from tpp_mlir_tpu_torch.runtime import compile as port_compile
from test_torch_tools import _strip_tiles

TOL = 1e-4      # the JAX tests' atol and rtol


def _jax_module(name):
    src, _ = cases.FUSION_CASES[name]
    if isinstance(src, dict):
        return jax_build_transformer_block(**src)
    return jax_parse_module(src)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _lowered(name, jit=False):
    """Lower FUSION_CASES[name] in both packages, run both on the JAX
    test's inputs and hold the port against the JAX package and against
    its own --linalg-to-loops evaluation. Returns the port's lowered IR."""
    jax_low = _jax_module(name)
    low = cases.fusion_module(name)
    jax_low.attrs["precision"] = low.attrs["precision"] = "highest"
    jax_run_pipeline(jax_low, "default-tpp-passes")
    run_pipeline(low, "default-tpp-passes")
    text = print_module(low)
    assert _strip_tiles(text) == _strip_tiles(jax_print_module(jax_low))
    args = cases.fusion_inputs(name, "cpu")
    want = _tuple(jax_compile(jax_low, jit=jit)(*(a.numpy() for a in args)))
    got = _tuple(port_compile(low, device="cpu")(*args))
    ref = cases.fusion_module(name)
    ref.attrs["precision"] = "highest"
    loops = _tuple(port_compile(ref, device="cpu")(*args))
    assert len(got) == len(want) == len(loops)
    for g, w, r in zip(got, want, loops):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=TOL, rtol=TOL)
    return text


# tests/passes/test_transformer_fusion.py

def test_fold_residual_acc_gemm():
    s = _lowered("fold_residual_acc_gemm")
    assert s.count("xsmm.fused_brgemm ") == 1
    assert "xsmm.binary" not in s and "xsmm.unary" not in s
    assert '"beta_0"' not in s          # the residual is the accumulator
    assert 'unary_kind = "relu"' in s


def test_fold_residual_acc_keeps_unary_barrier():
    _lowered("fold_residual_acc_keeps_unary_barrier")


def test_fold_residual_acc_plain_brgemm_keeps_unary():
    s = _lowered("fold_residual_acc_plain_brgemm_keeps_unary")
    # the activation survives as a standalone unary or on a fused dispatch
    if 'unary_kind = "relu"' in s:
        assert "fused_brgemm_dispatch" in s
    else:
        assert 'kind = "relu"' in s


def test_transformer_block_fuses_completely():
    s = _lowered("transformer_block_fuses_completely", jit=True)
    assert s.count("xsmm.fused_brgemm ") == 4
    assert s.count('prologue = "layer_norm"') == 2
    assert s.count("xsmm.layer_norm ") == 0
    assert s.count("xsmm.attention ") == 1
    assert "qkv_packed = true" in s
    assert "xsmm.binary" not in s and "xsmm.unary" not in s


def test_multilayer_encoder_fuses_per_layer():
    s = _lowered("multilayer_encoder_fuses_per_layer", jit=True)
    assert s.count("xsmm.fused_brgemm ") == 8
    assert s.count("xsmm.attention ") == 2
    assert s.count("xsmm.layer_norm ") == 0
    assert "xsmm.binary" not in s and "xsmm.unary" not in s


def test_qkv_merge_requires_constant_weights():
    s = _lowered("qkv_merge_requires_constant_weights")
    assert "qkv_packed" not in s


def test_xla_delegated_attention_causal():
    """The JAX test's D < 128 XLA route is a TPU route; the port sends
    every token-layout attention key to csrc/attention.cu, whose plain
    version runs on the CPU (ROADMAP "Attention routing")."""
    s = _lowered("xla_delegated_attention_causal", jit=True)
    assert s.count("xsmm.attention ") == 1 and "causal = true" in s


# tests/passes/test_returned_values.py

def test_fold_residual_keeps_returned_intermediate():
    _lowered("fold_residual_keeps_returned_intermediate")


def test_combine_keeps_returned_contraction():
    _lowered("combine_keeps_returned_contraction")


def test_combine_rejects_broadcast_up_binary():
    s = _lowered("combine_rejects_broadcast_up_binary")
    assert "xsmm.binary" in s, "broadcast-up add must stay standalone"


def test_spatial_addend_not_classified_channel_bias():
    _lowered("spatial_addend_not_classified_channel_bias")


def test_attention_fusion_keeps_returned_softmax():
    _lowered("attention_fusion_keeps_returned_softmax")


MIN_DIM_IR = """func @entry(%x: tensor<64x64xf32>, %w: tensor<64x64xf32>) {
  %0 = tl.constant {init = "zero", seed = 0} : tensor<64x64xf32>
  %1 = tl.matmul %x, %w, %0 : tensor<64x64xf32>
  return %1 : tensor<64x64xf32>
}
"""


@pytest.mark.parametrize("tiles,packs", [
    ((32, 32, 32), True), ((64, 32, 32), True), ((32, 64, 64), True),
    ((64, 64, 32), True), ((64, 64, 64), False)])
def test_pack_matmul_min_dim_honored(tiles, packs):
    """The tiny-matmul threshold at its default, the one value either
    package uses (the port's pack.MIN_TILES, the JAX pass's min_dim 2): a
    64x64x64 matmul of 8, 4, 2 or 2 tiles packs, one of a single tile
    stays as it is. The port takes tiles from the module's `tiles`
    attribute (tpp-gen --tiles), the JAX test from the pass's option."""
    m, jm = parse_module(MIN_DIM_IR), jax_parse_module(MIN_DIM_IR)
    m.attrs["tiles"] = jm.attrs["tiles"] = tiles
    make_pass("pack-matmul").run(m)
    jax_make_pass("pack-matmul", tiles=tiles).run(jm)
    assert ("tl.pack" in print_module(m)) == packs
    assert print_module(m) == jax_print_module(jm)
    x, w = (torch.randn(64, 64, generator=torch.Generator().manual_seed(i))
            for i in (0, 1))
    np.testing.assert_allclose(port_compile(m, device="cpu")(x, w).numpy(),
                               (x @ w).numpy(), atol=TOL, rtol=TOL)
