"""The port (the serving slice and tpp_serve included) imports torch and
never JAX, Triton or ml_dtypes.

The check runs in a subprocess because this test process already holds JAX
(tests/conftest.py imports it)."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tpp_mlir_tpu_torch"

_SLICE = r"""
import sys
import tpp_mlir_tpu_torch
from tpp_mlir_tpu.ir import parse_module
from tpp_mlir_tpu.tools.mlir_gen import (build_parser, config_from_args,
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
# the transformer slice: an imported GPT through the port's bench driver
from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
res = run_entry({"model": 'gpt:{"batch": 1, "seq": 16, "vocab": 64, '
                          '"embed": 32, "heads": 2, "layers": 1}'},
                device="cpu", out_stream=sys.stderr)
assert res["lowered"]["outputs"][0].shape == (1, 16, 64)
ops = {op.opname for op in res["lowered"]["module"]["entry"].ops}
assert {"xsmm.attention", "xsmm.layer_norm", "xsmm.gemm"} <= ops, ops
# the serving slice: engine, quantizers and tpp_serve
import torch
from tpp_mlir_tpu_torch.serving import (GptConfig, init_params, make_generate,
                                        quantize_params)
from tpp_mlir_tpu_torch.tools import tpp_serve
cfg = GptConfig(vocab=64, embed=32, heads=2, layers=1, max_seq=40,
                kv_quant="int8", int8_compute=True)
toks = make_generate(cfg, 3)(quantize_params(init_params(cfg)),
                             torch.zeros(1, 32, dtype=torch.int32))
assert toks.shape == (1, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "ml_dtypes"))
print("LOADED", bad)
print("LIBRARY", build.library.cache_info().currsize)
"""


def test_slice_runs_without_jax_triton_or_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    # on the CPU the plain versions run: the CUDA library is never loaded
    assert "LIBRARY 0" in proc.stdout, proc.stdout


def test_port_sources_name_no_jax_or_triton_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|triton|ml_dtypes)\b",
                     re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []


_SMOKE = r"""
import sys
import chip_smoke
print("AT_IMPORT", sorted(m for m in sys.modules if m.startswith("tpp")))
module = chip_smoke._module("--batch=8 --layers=16,16 --bias --relu")
print("OPS", [op.opname for op in module["entry"].ops])
print("REFERENCE", sorted(
    m for m in sys.modules if m.split(".")[0] == "tpp_mlir_tpu"
    and not m.startswith("tpp_mlir_tpu.ir")))
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in
                       ("jax", "jaxlib", "triton", "ml_dtypes")))
"""


def test_chip_smoke_imports_only_torch_and_the_port():
    """chip_smoke names no module of the JAX package: tpp-gen runs in its
    own process and the port parses its text."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names - set(sys.stdlib_module_names) == {"torch",
                                                   "tpp_mlir_tpu_torch"}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SMOKE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "AT_IMPORT []" in proc.stdout, proc.stdout
    assert "OPS ['tl.constant', 'tl.constant', 'tl.constant', 'tl.matmul', " \
        "'tl.add', 'tl.relu']" in proc.stdout, proc.stdout
    # the port shares only the IR: the generator and models stayed in the
    # tpp-gen process
    assert "REFERENCE ['tpp_mlir_tpu']" in proc.stdout, proc.stdout
    assert "LOADED []" in proc.stdout, proc.stdout
