"""The port (every slice: the MLP path, the compiler's general path and its
tools, the imported transformer, serving and its batching, beam and
speculative modes, training, MoE, the MHA suite, the conv family, packed
parity mode, the parallel layer, the tuning layer and the user API with
its examples, the dispatch API) imports
torch and its own modules only: never JAX, Triton, ml_dtypes, nor any
module of the JAX package `tpp_mlir_tpu`; nor does a rank of a world the
parallel layer spawns.

The run-time checks go in a subprocess because this test process already
holds JAX and the JAX package (tests/conftest.py imports them)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tpp_mlir_tpu_torch"

_LOADED = r"""
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "ml_dtypes",
                                    "tpp_mlir_tpu"))
print("LOADED", bad)
"""

_SLICE = r"""
import sys
import torch
import tpp_mlir_tpu_torch
from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser, config_from_args,
                                               generate_text)
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import build

for flags in ("--batch=8 --layers=16,16,16 --bias --relu --float-type=bf16",
              "--batch=8 --layers=16,32 --bias --relu",
              "--batch=8 --layers=32,16"):
    cfg = config_from_args(build_parser().parse_args(flags.split()))
    res = run_module(parse_module(generate_text(cfg)), n=2, device="cpu",
                     out_stream=sys.stderr)
    assert res["outputs"][0].shape[0] == 8
# the compiler's general path: generic and softmax IR, split-reduction,
# the pools, tpp-opt and fpcmp
from tpp_mlir_tpu_torch.passes import make_pass
from tpp_mlir_tpu_torch.tools import fpcmp, tpp_opt
for flags in ("--batch=8 --layers=16,16 --bias --relu --output=generic",
              "--batch=8 --layers=16,16 --bias --relu --softmax"):
    cfg = config_from_args(build_parser().parse_args(flags.split()))
    res = run_module(parse_module(generate_text(cfg)), device="cpu",
                     print_mlir="kernel", sanitize=True,
                     out_stream=sys.stderr)
    assert res["outputs"][0].shape == (8, 16)
m = parse_module(generate_text(config_from_args(build_parser().parse_args(
    "--batch=8 --layers=64,16".split()))))
make_pass("split-reduction-dim", tile=16).run(m)
assert run_module(m, device="cpu", out_stream=sys.stderr)["outputs"][0] \
    .shape == (8, 16)
from tpp_mlir_tpu_torch.frontend import import_torch
pool = torch.nn.Sequential(torch.nn.Conv2d(8, 8, 3, padding=1),
                           torch.nn.MaxPool2d(2), torch.nn.AvgPool2d(2))
res = run_module(import_torch(pool, (1, 8, 8, 8)), device="cpu",
                 out_stream=sys.stderr)
assert res["outputs"][0].shape == (1, 8, 2, 2)
assert tpp_opt.main(["--list"]) == 0
assert fpcmp.compare_values([1.0, float("inf")], [1.0, float("inf")], 0, 0)[0]
# the transformer slice: an imported GPT through the port's bench driver
from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
res = run_entry({"model": 'gpt:{"batch": 1, "seq": 16, "vocab": 64, '
                          '"embed": 32, "heads": 2, "layers": 1}'},
                device="cpu", out_stream=sys.stderr)
assert res["lowered"]["outputs"][0].shape == (1, 16, 64)
ops = {op.opname for op in res["lowered"]["module"]["entry"].ops}
assert {"xsmm.attention", "xsmm.layer_norm", "xsmm.gemm"} <= ops, ops
# the MHA slice: flat attention, the batched matmul with its softmax
for model in ('mha_full:{"batch": 1, "heads": 2, "seq": 128, '
              '"head_dim": 32}',
              'mha_qk:{"batch": 1, "heads": 2, "seq": 32, "head_dim": 64}',
              'mha_softmax_v:{"batch": 1, "heads": 2, "seq": 32, '
              '"head_dim": 64}'):
    res = run_entry({"model": model}, n=2, device="cpu",
                    out_stream=sys.stderr)
    assert torch.isfinite(res["lowered"]["outputs"][0]).all()
# the serving slice: engine, quantizers, flash prefill and tpp_serve
from tpp_mlir_tpu_torch.serving import (GptConfig, init_params, make_generate,
                                        quantize_params)
from tpp_mlir_tpu_torch.tools import tpp_serve
cfg = GptConfig(vocab=64, embed=32, heads=2, layers=1, max_seq=40,
                kv_quant="int8", int8_compute=True)
toks = make_generate(cfg, 3)(quantize_params(init_params(cfg, device="cpu")),
                             torch.zeros(1, 32, dtype=torch.int32))
assert toks.shape == (1, 3)
fcfg = GptConfig(vocab=64, embed=32, heads=2, layers=1, max_seq=40,
                 flash_attn=True)
assert make_generate(fcfg, 2)(init_params(fcfg, device="cpu"),
                              torch.zeros(1, 8, dtype=torch.int32)).shape \
    == (1, 2)
# the serving modes: both batching schedulers, beam search, speculative
from tpp_mlir_tpu_torch.serving import (BatchingEngine, DeviceBatchingEngine,
                                        make_beam_generate,
                                        make_speculative_generate)
bcfg = GptConfig(vocab=64, embed=32, heads=2, layers=2, max_seq=40)
bp = init_params(bcfg, device="cpu")
for engine in (BatchingEngine, DeviceBatchingEngine):
    eng = engine(bp, bcfg, slots=2, sync_steps=2, buckets=(8,))
    eng.submit([1, 2, 3], max_new=3)
    assert len(eng.run()[0]) == 3
prompt = torch.zeros(1, 4, dtype=torch.int32)
assert make_beam_generate(bcfg, 3, 2)(bp, prompt)[0].shape == (1, 3)
assert make_speculative_generate(bcfg, None, 4, k=2, trunk_layers=1)(
    bp, prompt)[0].shape == (1, 4)
# the training slice: the MLP SGD and optimizer steps, the GPT step
from tpp_mlir_tpu_torch.parallel import (adamw, make_gpt_train_step,
                                         make_optim_train_step,
                                         make_train_step, mlp_init, sgd)
layers = (16, 32, 16)
params = mlp_init(layers, device="cpu")
x, y = torch.randn(8, 16), torch.randn(8, 16)
params, loss = make_train_step(layers, 0.1, device="cpu")(params, x, y)
step, init = make_optim_train_step(layers, adamw(1e-3), accum_steps=2,
                                   device="cpu")
step(params, init(params), x, y)
gcfg = GptConfig(vocab=64, embed=32, heads=2, layers=1, max_seq=16)
ids = torch.randint(0, 64, (2, 8), dtype=torch.int32)
for flash in (True, False):
    gp = init_params(gcfg, device="cpu")
    step, init = make_gpt_train_step(gcfg, sgd(0.1), flash_attn=flash,
                                     device="cpu")
    assert torch.isfinite(step(gp, init(gp), ids)[2])
# the MoE slice: the grouped form serving and training
mcfg = GptConfig(vocab=64, embed=32, heads=2, layers=1, max_seq=16,
                 n_experts=4, moe_prefill_form="grouped", moe_group_bm=8)
mp = init_params(mcfg, device="cpu")
assert make_generate(mcfg, 2)(mp, ids).shape == (2, 2)
step, init = make_gpt_train_step(mcfg, sgd(0.1), device="cpu")
assert torch.isfinite(step(mp, init(mp), ids)[2])
# the conv family: a conv net, the imported ResNet block and a ViT
for model in ('convnet:{"batch": 2, "channels": 16, "filters": 16, '
              '"height": 8, "width": 8, "padding": "same", "layers": 2, '
              '"residual": true}',
              'resnet_block:{"batch": 1, "channels": 8, "hw": 6}',
              'vit:{"batch": 1, "image": 32, "patch": 16, "embed": 64, '
              '"heads": 2, "layers": 1}'):
    res = run_entry({"model": model}, device="cpu", out_stream=sys.stderr)
    assert torch.isfinite(res["lowered"]["outputs"][0]).all()
# packed parity mode: tpp_run and the bench driver under
# default-tpp-passes-packed, a file entry, and the functional ops
cfg = config_from_args(build_parser().parse_args(
    "--batch=16 --layers=1024,1024 --bias --relu --float-type=bf16".split()))
res = run_module(parse_module(generate_text(cfg)), n=2, device="cpu",
                 pipeline="default-tpp-passes-packed", out_stream=sys.stderr)
assert res["outputs"][0].shape == (16, 1024)
for entry in ({"model": 'convnet:{"batch": 1, "channels": 16, '
                        '"filters": 16, "height": 6, "width": 6}',
               "pipeline": "default-tpp-passes-packed"},
              {"file": "benchmarks/mlir/fp32-pack-gemm-operand-b-512x1024.mlir"}):
    res = run_entry(entry, n=1, device="cpu", out_stream=sys.stderr)
    assert torch.isfinite(res["lowered"]["outputs"][0]).all()
from tpp_mlir_tpu_torch import ops
assert ops.blocked_matmul(torch.randn(1, 2, 8, 16),
                          ops.vnni_pack(torch.randn(2, 2, 16, 8)),
                          vnni=2).shape == (1, 2, 8, 8)
assert ops.conv2d_brgemm(torch.randn(1, 2, 5, 5, 8),
                         torch.randn(1, 2, 3, 3, 8, 4)).shape == (1, 1, 3, 3, 4)
# the parallel layer: its modules on one device, then a spawned gloo world
# of two ranks running the dry run, each rank reporting what it loaded
from tpp_mlir_tpu_torch.parallel import (P, make_mha_forward,
                                         make_moe_forward,
                                         make_pipeline_forward,
                                         make_ring_attention, mha_params,
                                         moe_init, pipeline_init, spawn)
x = torch.randn(2, 8, 32)
assert make_mha_forward(None, 32, 4)(mha_params(32, 4, device="cpu"),
                                     x).shape == x.shape
assert make_pipeline_forward({"pp": 1}, 16)(
    pipeline_init(16, 1, device="cpu"), torch.randn(3, 4, 16)).shape \
    == (3, 4, 16)
q = torch.randn(1, 8, 2, 4)
assert make_ring_attention({"sp": 1}, 2, causal=True)(q, q, q).shape \
    == q.shape
assert make_moe_forward({"ep": 1}, 16, 32, 4)(
    moe_init(16, 32, 4, device="cpu"), torch.randn(8, 16)).shape == (8, 16)
sys.path.insert(0, "tests")
from torch_parallel_workers import loaded_modules
roots = ("jax", "jaxlib", "triton", "ml_dtypes", "tpp_mlir_tpu")
for rank_bad in spawn(loaded_modules, 2, "gloo", "cpu", (roots,)):
    print("RANK LOADED", rank_bad)
# the tuning layer and the user API: the table, tpp-tune's listing,
# --register-blocking, the completed ops and an example run in process
import runpy
from tpp_mlir_tpu_torch.tools import tpp_run, tpp_tune
from tpp_mlir_tpu_torch.xsmm import tune
assert tpp_tune.main(["--dry", "--device", "cpu", "--gen",
                      "--batch=8 --layers=16,16 --bias --relu",
                      "--key", "BrgemmKey"]) == 0
import tempfile
with tempfile.NamedTemporaryFile("w", suffix=".ir") as f:
    f.write(generate_text(config_from_args(build_parser().parse_args(
        "--batch=8 --layers=64,64 --bias --relu".split()))))
    f.flush()
    assert tpp_run.main([f.name, "--device", "cpu", "--register-blocking",
                         "64,64,64"]) == 0
assert ops.brgemm(torch.randn(2, 8, 16), torch.randn(2, 16, 8)).shape == (8, 8)
assert ops.relu(torch.randn(4)).min() >= 0
sys.argv = ["02_functional_ops.py", "--device", "cpu"]
runpy.run_path("examples/torch/02_functional_ops.py", run_name="__main__")
# the libxsmm-shaped GEMM dispatch functions
from tpp_mlir_tpu_torch.xsmm import (brgemm_dispatch, fused_brgemm_dispatch,
                                     gemm_dispatch)
assert gemm_dispatch(8, 8, 8, beta0=True)(torch.randn(8, 8),
                                          torch.randn(8, 8)).shape == (8, 8)
assert brgemm_dispatch(2, 8, 8, 8, beta0=True)(
    torch.randn(2, 8, 8), torch.randn(2, 8, 8)).shape == (8, 8)
assert fused_brgemm_dispatch(1, 8, 8, 8, beta0=True)(
    torch.randn(1, 8, 8), torch.randn(1, 8, 8), None,
    torch.randn(8)).min() >= 0
""" + _LOADED + r"""
print("LIBRARY", build.library.cache_info().currsize)
"""


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_slice_runs_without_jax_triton_or_ml_dtypes():
    out = _run(_SLICE)
    # neither JAX, Triton, ml_dtypes nor any module of the JAX package, in
    # this process and in each spawned rank
    assert "LOADED []" in out, out
    assert out.count("RANK LOADED []") == 2, out
    # on the CPU the plain versions run: the CUDA library is never loaded
    assert "LIBRARY 0" in out, out


def _imports_and_strings(path: Path):
    """(top-level names of absolute imports, string constants) of a file."""
    tree = ast.parse(path.read_text())
    names, strings = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.append(node.value)
    return names, strings


def test_port_sources_name_no_jax_or_triton_import():
    """No file of the port, nor chip_smoke.py, nor the rank bodies of the
    parallel tests (tests/torch_parallel_workers.py), nor the parity cases
    chip_smoke.py shares with the tests (tests/torch_parity_cases.py), nor
    the port's examples (examples/torch/) imports JAX, ml_dtypes, Triton
    (the port has no Triton kernel) or the JAX package, or names a module
    of the JAX package to run (`-m tpp_mlir_tpu.…`)."""
    offenders = []
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
                 ROOT / "tests" / "torch_parallel_workers.py",
                 ROOT / "tests" / "torch_parity_cases.py",
                 *(ROOT / "examples" / "torch").glob("*.py")]:
        names, strings = _imports_and_strings(path)
        bad = names & {"jax", "jaxlib", "ml_dtypes", "tpp_mlir_tpu",
                       "triton"}
        bad |= {s for s in strings
                if s == "tpp_mlir_tpu" or s.startswith("tpp_mlir_tpu.")}
        if bad:
            offenders.append((str(path.relative_to(ROOT)), sorted(bad)))
    assert offenders == []


_SMOKE = r"""
import sys
import chip_smoke
print("AT_IMPORT", sorted(m for m in sys.modules if m.startswith("tpp")))
module = chip_smoke._module("--batch=8 --layers=16,16 --bias --relu")
print("OPS", [op.opname for op in module["entry"].ops])
pc = chip_smoke._parity_cases()
for name in pc.FUSION_CASES:
    pc.fusion_module(name)
    pc.fusion_inputs(name, "cpu")
assert len(pc.fuzz_arches(dict(vocab=97, embed=32, heads=4, layers=2,
                               max_seq=32, dtype="f32"), 2)) == 10
""" + _LOADED


def test_chip_smoke_imports_only_torch_and_the_port():
    """chip_smoke imports only the standard library, numpy, torch, the
    port and the parity cases it shares with the tests
    (tests/torch_parity_cases.py, which imports the same and no more);
    tpp-gen is the port's copy, in process."""
    names, _ = _imports_and_strings(ROOT / "chip_smoke.py")
    assert names - set(sys.stdlib_module_names) == {
        "numpy", "torch", "tpp_mlir_tpu_torch", "torch_parity_cases"}
    names, _ = _imports_and_strings(ROOT / "tests" / "torch_parity_cases.py")
    assert names - set(sys.stdlib_module_names) <= {"numpy", "torch",
                                                   "tpp_mlir_tpu_torch"}
    out = _run(_SMOKE)
    assert "AT_IMPORT []" in out, out
    assert "OPS ['tl.constant', 'tl.constant', 'tl.constant', 'tl.matmul', " \
        "'tl.add', 'tl.relu']" in out, out
    assert "LOADED []" in out, out
