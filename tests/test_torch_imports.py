"""The port (every slice: the MLP path, the imported transformer, serving,
training, MoE, the MHA suite, the conv family, packed parity mode) imports torch and its own
modules only: never JAX, Triton, ml_dtypes, nor any module of the JAX
package `tpp_mlir_tpu`.

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
    # neither JAX, Triton, ml_dtypes nor any module of the JAX package
    assert "LOADED []" in out, out
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
    """No file of the port nor chip_smoke.py imports JAX, ml_dtypes, Triton
    (the port has no Triton kernel) or the JAX package, or names a module
    of the JAX package to run (`-m tpp_mlir_tpu.…`)."""
    offenders = []
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
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
""" + _LOADED


def test_chip_smoke_imports_only_torch_and_the_port():
    """chip_smoke imports only the standard library, numpy, torch and the
    port; tpp-gen is the port's copy, in process."""
    names, _ = _imports_and_strings(ROOT / "chip_smoke.py")
    assert names - set(sys.stdlib_module_names) == {"numpy", "torch",
                                                   "tpp_mlir_tpu_torch"}
    out = _run(_SMOKE)
    assert "AT_IMPORT []" in out, out
    assert "OPS ['tl.constant', 'tl.constant', 'tl.constant', 'tl.matmul', " \
        "'tl.add', 'tl.relu']" in out, out
    assert "LOADED []" in out, out
