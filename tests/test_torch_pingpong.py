"""The non-square fc warm bench (B5) of the port against the JAX package,
on the CPU.

The ping-pong plain version (ChainKey.pingpong with repeats > 1,
tpp_mlir_tpu_torch/xsmm/reference.py, the oracle csrc/chain.cu's B5 loop
is held to on the card) against `_build_chain_bench_pingpong` in interpret
mode at R 2, 3, 4 with bias and relu; and extract_bench_kernel, which picks
the in-kernel bench of a lowered function, against the reference's: the
same key for a non-square fc and for a lone attention invoke.

Error measure: max|port - jax| / max|jax|. f32 "highest" 1e-5 (the same
math, sum order only); bf16 1e-2 (each repeat rounds its state to bf16).
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu.ir import parse_module as jax_parse_module
from tpp_mlir_tpu.models import mha as jax_mha
from tpp_mlir_tpu.passes import run_pipeline as jax_run_pipeline
from tpp_mlir_tpu.runtime.executor import \
    extract_bench_kernel as jax_extract_bench_kernel
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.models import mha
from tpp_mlir_tpu_torch.models.mlp import MlpConfig
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime.executor import extract_bench_kernel
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.tools.mlir_gen import generate_text
from tpp_mlir_tpu_torch.xsmm import ChainKey, chain_fits_smem, \
    reference_kernel


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


@pytest.mark.parametrize("repeats", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pingpong_plain_matches_pallas_interpret(dtype, repeats):
    prec = "highest" if dtype == "f32" else "default"
    key = ChainKey(m=24, dims=(32, 80), dtype=dtype, precision=prec,
                   repeats=repeats, pingpong=True, unary_kind="relu",
                   last_unary="relu")
    rng = np.random.default_rng(repeats)
    dt = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    x = rng.standard_normal((24, 32)).astype(np.float32).astype(dt)
    w = (rng.standard_normal((32, 80)) / 32 ** 0.5).astype(np.float32) \
        .astype(dt)
    bias = (0.1 * rng.standard_normal(80)).astype(np.float32).astype(dt)
    ref_key = ref_flags.ChainKey(**dataclasses.asdict(key))
    want = jax_build_kernel(ref_key, interpret=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = reference_kernel(key)(to_torch(x), to_torch(w), to_torch(bias))
    assert _err(got, want) <= (1e-5 if dtype == "f32" else 1e-2)


def test_pingpong_at_two_repeats_is_one_fc():
    # W^T is not W^-1: only R == 2 gives a single fc application
    key = ChainKey(m=8, dims=(16, 48), precision="highest", repeats=2,
                   pingpong=True, last_unary="relu")
    one = dataclasses.replace(key, repeats=1, pingpong=False)
    rng = np.random.default_rng(0)
    args = [to_torch(rng.standard_normal(s).astype(np.float32))
            for s in ((8, 16), (16, 48), (48,))]
    assert _err(reference_kernel(key)(*args),
                reference_kernel(one)(*args).numpy()) <= 1e-6


FCS = ["--batch=16 --layers=32,80 --bias --relu",
       "--batch=16 --layers=80,32 --bias --relu --float-type=bf16",
       "--batch=16 --layers=48,48 --bias --relu",
       "--batch=16 --layers=32,80"]


@pytest.mark.parametrize("flags", FCS,
                         ids=["fc-32x80", "fc-80x32-bf16", "fc-square",
                              "matmul-32x80"])
def test_extract_bench_kernel_matches_reference_for_an_fc(flags):
    from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser,
                                                   config_from_args)
    text = generate_text(config_from_args(build_parser().parse_args(
        flags.split())))
    port, ref = parse_module(text), jax_parse_module(text)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    key, _ = extract_bench_kernel(port)
    ref_key, _ = jax_extract_bench_kernel(ref)
    assert dataclasses.asdict(key) == dataclasses.asdict(ref_key)
    assert key.pingpong == (key.dims[0] != key.dims[1])


def test_extract_bench_kernel_matches_reference_for_attention():
    kw = dict(batch=1, heads=2, seq=128, head_dim=32, causal=True,
              scale=0.125)
    port, ref = mha.build_mha(**kw), jax_mha.build_mha(**kw)
    run_pipeline(port, "default-tpp-passes")
    jax_run_pipeline(ref, "default-tpp-passes")
    key, get_operands = extract_bench_kernel(port)
    ref_key, _ = jax_extract_bench_kernel(ref)
    assert dataclasses.asdict(key) == dataclasses.asdict(ref_key)
    q = to_torch(np.ones((2, 128, 32), np.float32))
    assert len(get_operands([q, q, q])) == 3


def test_wide_fc_takes_the_loop_lowering():
    # 3072 wide: the row block's activations pass the shared memory one
    # block may use, so chain.cu cannot hold it (fc_128x3072x768)
    key = ChainKey(m=128, dims=(3072, 768), repeats=2, pingpong=True)
    assert not chain_fits_smem(key)
    assert chain_fits_smem(dataclasses.replace(key, dims=(768, 2304)))
    text = generate_text(MlpConfig(batch=16, layers=(3072, 768), bias=True,
                                   relu=True))
    m = parse_module(text)
    run_pipeline(m, "default-tpp-passes")
    assert extract_bench_kernel(m) is None
