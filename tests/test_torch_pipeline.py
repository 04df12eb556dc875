"""The port's main paths (tpp-gen IR, and the imported GPT and transformer
block -> default-tpp-passes -> executor) against the JAX package's
run_module on the same module and seed, on the CPU.

Error measure: max|port - jax| / max|jax|. Tolerances: f32 "highest" 1e-5
(sum order only); f32 "default" and bf16 1e-2 (the port rounds f32
operands to bf16 as the compiled TPU kernels do, interpret mode does not;
bf16 rounds at other places in the two frameworks).
"""

import io

import ml_dtypes
import numpy as np
import pytest
import torch

from tpp_mlir_tpu.ir import parse_module as ref_parse_module
from tpp_mlir_tpu.models.gpt import build_gpt as ref_build_gpt
from tpp_mlir_tpu.models.transformer_block import \
    build_transformer_block as ref_build_transformer_block
from tpp_mlir_tpu.runtime.tensor_init import tensor_init as ref_tensor_init
from tpp_mlir_tpu.tools.tpp_run import init_args as ref_init_args
from tpp_mlir_tpu.tools.tpp_run import run_module as ref_run_module
from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.models.gpt import build_gpt
from tpp_mlir_tpu_torch.models.mlp import MlpConfig, build_mlp
from tpp_mlir_tpu_torch.models.transformer_block import \
    build_transformer_block
from tpp_mlir_tpu_torch.tools.mlir_gen import generate_text
from tpp_mlir_tpu_torch.runtime import compile as port_compile
from tpp_mlir_tpu_torch.runtime.tensor_init import tensor_init, to_torch
from tpp_mlir_tpu_torch.tools import tpp_run
from tpp_mlir_tpu_torch.tools.tpp_run import (init_args, run_module,
                                              wrap_bench_main)


def _module(cfg, precision="default", ref=False):
    """tpp-gen's module, parsed by the port (or, ref=True, by the JAX
    package: each package runs IR of its own classes)."""
    m = (ref_parse_module if ref else parse_module)(generate_text(cfg))
    if precision != "default":
        m.attrs["precision"] = precision
    return m


def _err(port, ref):
    p = port.float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


MLP = dict(batch=32, layers=(128,) * 4, bias=True, relu=True)
CASES = {
    "mlp-f32-default": (MlpConfig(**MLP), "default", 1e-2),
    "mlp-f32-highest": (MlpConfig(**MLP), "highest", 1e-5),
    "mlp-bf16": (MlpConfig(**MLP, float_type="bf16"), "default", 1e-2),
    "mlp-bf16-args": (MlpConfig(**MLP, float_type="bf16", kernel="args"),
                      "default", 1e-2),
    "fc-f32-highest": (MlpConfig(batch=32, layers=(128, 128), bias=True,
                                 relu=True), "highest", 1e-5),
    "fc-f32-default": (MlpConfig(batch=32, layers=(128, 128), bias=True,
                                 relu=True), "default", 1e-2),
    "matmul-f32-highest": (MlpConfig(batch=32, layers=(128, 64)),
                           "highest", 1e-5),
    "matmul-bf16": (MlpConfig(batch=32, layers=(128, 64), float_type="bf16"),
                    "default", 1e-2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_run_module_matches_reference(name):
    cfg, precision, tol = CASES[name]
    want = ref_run_module(_module(cfg, precision, ref=True), seed=3,
                          out_stream=io.StringIO())["outputs"][0]
    got = run_module(_module(cfg, precision), seed=3, device="cpu",
                     out_stream=io.StringIO())["outputs"][0]
    assert _err(got, want) <= tol


@pytest.mark.parametrize("name", ["mlp-bf16", "fc-f32-highest",
                                  "matmul-f32-highest"])
def test_lowered_matches_linalg_to_loops(name):
    cfg, precision, tol = CASES[name]
    got = run_module(_module(cfg, precision), seed=5, device="cpu",
                     out_stream=io.StringIO())
    want = run_module(_module(cfg, precision), seed=5, device="cpu",
                      linalg_to_loops=True, out_stream=io.StringIO())
    assert _err(got["outputs"][0], want["outputs"][0].float().numpy()) <= tol


def test_bench_wrapper_chains_iterations():
    # perf.bench feeds each result back as the next input: n=3 equals three
    # applications (loop lowering, which the CPU takes)
    m = _module(MlpConfig(batch=8, layers=(16, 16), bias=True, relu=True))
    from tpp_mlir_tpu_torch.passes import run_pipeline
    run_pipeline(m, "default-tpp-passes")
    name = wrap_bench_main(m, "entry", 3)
    args = init_args(m, "entry", "normal", 0, device="cpu")
    step = port_compile(m, "entry", device="cpu")
    mean, out = port_compile(m, name, device="cpu")(*args)
    assert float(mean) > 0
    assert torch.equal(out, step(step(step(args[0]))))


def test_run_module_times_on_cpu_and_names_the_device():
    stream = io.StringIO()
    res = run_module(_module(MlpConfig(batch=8, layers=(16, 16, 16),
                                       bias=True, relu=True)),
                     n=2, device="cpu", out_stream=stream)
    assert res["gflops"] > 0 and res["device"] == "cpu"
    assert "gflops" in stream.getvalue() and "cpu" in stream.getvalue()
    # the timed run does not change the result
    ref = run_module(_module(MlpConfig(batch=8, layers=(16, 16, 16),
                                       bias=True, relu=True)),
                     device="cpu", out_stream=io.StringIO())
    assert torch.equal(res["outputs"][0], ref["outputs"][0])


def test_cli_prints_like_the_reference(tmp_path, capsys):
    path = tmp_path / "fc.mlir"
    path.write_text(generate_text(MlpConfig(batch=4, layers=(16, 8),
                                            bias=True, relu=True)))
    assert tpp_run.main([str(path), "--print", "-seed", "2",
                         "--precision", "highest", "--device", "cpu"]) == 0
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.startswith("(")]
    want = ref_run_module(ref_parse_module(path.read_text()), seed=2,
                          out_stream=io.StringIO())["outputs"][0]
    got = np.array([[float(v) for v in r.strip("() ").split(",")]
                    for r in rows], np.float32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        run_module(build_mlp(MlpConfig(batch=4, layers=(8, 8))))


def test_trace_reads_only_device_time():
    from tpp_mlir_tpu_torch.tools.trace import trace_module
    with pytest.raises(RuntimeError, match="needs --device cuda"):
        trace_module(build_mlp(MlpConfig(batch=4, layers=(8, 8))),
                     device="cpu")


@pytest.mark.parametrize("kind", ["zero", "const", "simple", "cont", "rand",
                                  "normal", "identity"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16", "i32"])
def test_tensor_init_bitwise_parity(kind, dtype):
    ref = ref_tensor_init(kind, (6, 6), dtype, seed=11, value=0.7)
    port = tensor_init(kind, (6, 6), dtype, seed=11, value=0.7)
    assert ref.dtype.itemsize == port.element_size()
    bits = {1: np.uint8, 2: np.uint16, 4: np.uint32}[ref.dtype.itemsize]
    tbits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        port.element_size()]
    np.testing.assert_array_equal(
        port.view(tbits).numpy().view(bits), ref.view(bits))


def test_to_torch_carries_ml_dtypes_bf16_bit_for_bit():
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    b = x.astype(ml_dtypes.bfloat16)
    t = to_torch(b)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  b.view(np.uint16))
    assert torch.equal(to_torch(x), torch.from_numpy(x))
    assert torch.equal(to_torch(x[:, ::2]), torch.from_numpy(x[:, ::2].copy()))


# ---------------------------------------------------------------------------
# the transformer slice: imported GPT and transformer block
# ---------------------------------------------------------------------------

def _gpt(dtype="bf16", precision="default", ref=False):
    m = (ref_build_gpt if ref else build_gpt)(
        batch=2, seq=128, vocab=512, embed=256, heads=2, layers=2,
        dtype=dtype)
    if precision != "default":
        m.attrs["precision"] = precision
    return m


def _block(dtype="f32", precision="default", ref=False):
    m = (ref_build_transformer_block if ref else build_transformer_block)(
        batch=2, seq=128, embed=256, heads=2, dtype=dtype)
    if precision != "default":
        m.attrs["precision"] = precision
    return m


# Tolerances (max|port - jax| / max|jax|): bf16 and f32 "default" 2e-2 (the
# port's kernels round f32 operands to bf16 where interpret mode keeps f32,
# and two layers of bf16 roundings fall at other places; measured up to
# 6.4e-3); f32 "highest" 1e-4 (sum order and the one-pass vs two-pass
# LayerNorm statistics only).
MODEL_CASES = {
    "gpt-bf16": (_gpt, "bf16", "default", 2e-2),
    "gpt-f32-default": (_gpt, "f32", "default", 2e-2),
    "gpt-f32-highest": (_gpt, "f32", "highest", 1e-4),
    "block-bf16": (_block, "bf16", "default", 2e-2),
    "block-f32-default": (_block, "f32", "default", 2e-2),
    "block-f32-highest": (_block, "f32", "highest", 1e-4),
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_imported_model_matches_reference(name):
    build, dtype, precision, tol = MODEL_CASES[name]
    want = ref_run_module(build(dtype, precision, ref=True), seed=1,
                          out_stream=io.StringIO())["outputs"][0]
    got = run_module(build(dtype, precision), seed=1, device="cpu",
                     out_stream=io.StringIO())["outputs"][0]
    assert got.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    assert _err(got, want) <= tol


@pytest.mark.parametrize("name", ["gpt-bf16", "block-f32-highest"])
def test_imported_model_lowered_matches_linalg_to_loops(name):
    build, dtype, precision, tol = MODEL_CASES[name]
    got = run_module(build(dtype, precision), seed=2, device="cpu",
                     out_stream=io.StringIO())["outputs"][0]
    want = run_module(build(dtype, precision), seed=2, device="cpu",
                      linalg_to_loops=True,
                      out_stream=io.StringIO())["outputs"][0]
    assert _err(got, want.float().numpy()) <= tol


def test_gpt_at_highest_matches_the_torch_module():
    # as tests/frontend/test_torch_import.py does for the JAX package
    from tpp_mlir_tpu_torch.frontend import import_torch_fx
    from tpp_mlir_tpu_torch.models.gpt import GptTorch
    torch.manual_seed(0)
    tm = GptTorch(96, 64, 4, 2, 4, max_seq=16).eval()
    ids = np.random.default_rng(0).integers(0, 96, (2, 16)).astype(np.int32)
    with torch.no_grad():
        want = tm(torch.from_numpy(ids).long()).numpy()
    m = import_torch_fx(tm, (2, 16), dtype="f32", input_dtype="i32")
    m.attrs["precision"] = "highest"
    from tpp_mlir_tpu_torch.passes import run_pipeline
    run_pipeline(m, "default-tpp-passes")
    got = port_compile(m, device="cpu")(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_init_args_makes_the_reference_token_ids():
    # token ids: uniform in [0, rows of the gather table), default_rng(seed
    # + i), as the reference's tpp_run.init_args; not truncated normals
    kw = dict(batch=2, seq=16, vocab=96, embed=32, heads=2, layers=1)
    m = build_gpt(**kw)
    want = ref_init_args(ref_build_gpt(**kw), "entry", "normal", 5)
    got = init_args(m, "entry", "normal", 5, device="cpu")
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert 0 <= int(got[0].min()) and int(got[0].max()) < 96


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_literals_carry_to_the_reference_bits(dtype):
    import jax.numpy as jnp
    from tpp_mlir_tpu.ir.types import jnp_dtype
    from tpp_mlir_tpu_torch.runtime.params import literal_tensor, module_params
    m = build_gpt(batch=1, seq=16, vocab=96, embed=32, heads=2, layers=1,
                  dtype=dtype)
    params = module_params(m, device="cpu")
    consts = [op for op in m["entry"].ops if op.opname == "tl.constant"
              and op.attrs.get("init") == "literal"]
    assert len(params) == len(consts) > 0
    bits = {"bf16": (torch.int16, np.uint16), "f32": (torch.int32, np.uint32)}
    tb, nb = bits[dtype]
    for op in consts:
        t = op.results[0].type
        want = np.asarray(jnp.asarray(np.asarray(
            m.literals[op.attrs["literal"]])).astype(jnp_dtype(t)))
        got = literal_tensor(m, op.attrs["literal"], t, device="cpu")
        assert torch.equal(got, params[op.attrs["literal"]])
        np.testing.assert_array_equal(got.view(tb).numpy().view(nb),
                                      want.view(nb))


def test_bench_driver_runs_a_model_entry(capsys):
    from tpp_mlir_tpu_torch.tools import bench_driver
    entry = {"model": 'transformer_block:{"batch": 1, "seq": 32, '
                      '"embed": 64, "heads": 2}', "precision": "highest"}
    res = bench_driver.run_entry(entry, n=2, device="cpu",
                                 out_stream=io.StringIO())
    got, want = res["lowered"]["outputs"][0], res["baseline"]["outputs"][0]
    assert got.shape == (1, 32, 64) and res["tokens"] is None
    assert _err(got, want.numpy()) <= 1e-4
    assert res["lowered"]["mean_seconds"] > 0
    assert bench_driver.main([
        "--model", 'gpt:{"batch": 1, "seq": 16, "vocab": 64, "embed": 32, '
        '"heads": 2, "layers": 1}', "--device", "cpu", "-n", "1"]) == 0
    out = capsys.readouterr().out
    assert "tokens/s" in out and "vs --linalg-to-loops" in out
    assert "on cpu" in out
    with pytest.raises(NotImplementedError, match="outside the port's slice"):
        bench_driver.build_module({"model": "convnet"})
