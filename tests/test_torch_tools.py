"""The port's tools against the JAX package's, on the CPU: tpp-fpcmp
(the same verdicts and exit codes, equal infinities and NaNs), tpp-opt
(the same printed IR, --list, --print-after, -o, unknown arguments),
tpp-run's --splat-to-random (the same module rewrite, then different
numbers), and its debugging flags on the CPU: --print-mlir early, late and
kernel, -v, --profile and --sanitize nan. Mirrors
tests/tools/test_tools.py:71, :82, :162 and :199.
"""

import io
import json
import re

import numpy as np
import pytest

import tpp_mlir_tpu.ir as jax_ir
from tpp_mlir_tpu.tools import fpcmp as jax_fpcmp
from tpp_mlir_tpu.tools import tpp_opt as jax_tpp_opt
from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.tools import fpcmp, tpp_opt, tpp_run
from tpp_mlir_tpu_torch.xsmm import (ChainKey, ConvNhwcKey, FlashTrainKey,
                                     UnaryKey)
from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser, config_from_args,
                                               generate_text)


def gen(argv):
    return generate_text(config_from_args(build_parser().parse_args(argv)))


def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


@pytest.mark.parametrize("other,rc", [
    ("( 1.0, 2.0000001 )\n( 3.0, 4.0 )\n", 0),
    ("( 1.0, 9.0 )\n( 3.0, 4.0 )\n", 1),
    ("( 1.0, 2.0 )\n( 3.0 )\n", 1),
    ("( 1.0, inf )\n( nan, 4.0 )\n", 1),
], ids=["within", "beyond", "count", "inf-nan"])
def test_fpcmp_tool(tmp_path, other, rc):
    f1, f2 = tmp_path / "a.txt", tmp_path / "b.txt"
    f1.write_text("( 1.0, 2.0 )\n( 3.0, 4.0 )\n")
    f2.write_text(other)
    assert fpcmp.main([str(f1), str(f2)]) == rc
    assert jax_fpcmp.main([str(f1), str(f2)]) == rc
    assert fpcmp.compare_files(str(f1), str(f2)) == \
        jax_fpcmp.compare_files(str(f1), str(f2))


def test_fpcmp_usage_exits_2(tmp_path):
    with pytest.raises(SystemExit) as e:
        fpcmp.main([str(tmp_path / "only-one.txt")])
    assert e.value.code == 2


def test_fpcmp_equal_infinities_match():
    """Equal infinities and two NaNs match; inf against -inf does not (the
    JAX package's verdicts)."""
    inf, nan = float("inf"), float("nan")
    for a, b, want in (([inf, 1.0], [inf, 1.0], True), ([inf], [-inf], False),
                       ([nan, -inf], [nan, -inf], True),
                       ([nan], [1.0], False)):
        ok, _ = fpcmp.compare_values(a, b, 1e-6, 1e-4)
        assert ok == want == jax_fpcmp.compare_values(a, b, 1e-6, 1e-4)[0]
    text = "( 1, -2.5e-3, inf, nan, -inf )"
    assert repr(fpcmp.extract_floats(text)) == \
        repr(jax_fpcmp.extract_floats(text)) == \
        "[1.0, -0.0025, inf, nan, -inf]"


@pytest.mark.parametrize("flags,passes", [
    ("--batch=8 --layers=16,32 --bias --relu", ["--default-tpp-passes"]),
    ("--batch=8 --layers=16,16 --bias --relu --softmax",
     ["--default-tpp-passes-flat"]),
    ("--batch=8 --layers=16,16,16 --bias --relu --output=generic",
     ["-p", "degeneralize,cleanup"]),
    ("--batch=8 --layers=16,16 --bias", ["--linalg-lowering"]),
], ids=["default", "softmax-flat", "degeneralize", "linalg-lowering"])
def test_tpp_opt_cli(tmp_path, capsys, flags, passes):
    """tpp-opt prints the JAX package's tpp-opt output on the same file."""
    src = tmp_path / "m.ir"
    src.write_text(gen(flags.split()))
    assert tpp_opt.main([str(src), *passes]) == 0
    out = capsys.readouterr().out
    assert jax_tpp_opt.main([str(src), *passes]) == 0
    want = capsys.readouterr().out
    assert _strip_tiles(out) == _strip_tiles(want)
    assert "tl.generic" not in out or "linalg" in passes[0]


def test_tpp_opt_list_print_after_and_output(tmp_path, capsys):
    assert tpp_opt.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ("tpp-mapping", "linalg-lowering", "default-tpp-passes",
                 "default-tpp-passes-packed", "default-pipeline",
                 "degeneralize", "decompose-softmax", "split-reduction-dim",
                 "generalize-named-ops", "convert-tl-to-xsmm"):
        assert name in out
    src, dst = tmp_path / "m.ir", tmp_path / "out.ir"
    src.write_text(gen(["--batch=8", "--layers=16,16", "--softmax"]))
    assert tpp_opt.main([str(src), "-p", "decompose-softmax,cleanup",
                         "--print-after", "-o", str(dst)]) == 0
    err = capsys.readouterr().err
    assert "IR after decompose-softmax" in err and "IR after cleanup" in err
    assert "tl.reduce" in dst.read_text()
    assert tpp_opt.main([str(src), "stray"]) == 2
    assert tpp_opt.main([str(src), "--no-verify", "-p", "cleanup"]) == 0


SPLAT = """func @entry(%x: tensor<8x16xf32>) {
  %w = tl.constant {init = "const", value = 0.5} : tensor<16x16xf32>
  %a = tl.constant {init = "zero"} : tensor<8x16xf32>
  %0 = tl.matmul %x, %w, %a : tensor<8x16xf32>
  return %0 : tensor<8x16xf32>
}
"""


def test_splat_to_random_cli(tmp_path, capsys):
    """-splat-to-random makes the splat weight random and keeps the
    accumulator's zero, as the JAX package's does; the printed numbers
    change."""
    port = parse_module(SPLAT)
    tpp_run.splat_to_random(port, 7)
    inits = {op.results[0].name: op.attrs.get("init")
             for op in port["entry"].ops if op.opname == "tl.constant"}
    assert inits == {"w": "rand", "a": "zero"}
    f = tmp_path / "m.mlir"
    f.write_text(SPLAT)
    base = [str(f), "--print", "-seed", "7", "-init-type", "rand",
            "--device", "cpu"]
    assert tpp_run.main(base) == 0
    splat_out = capsys.readouterr().out
    assert tpp_run.main(base + ["-splat-to-random"]) == 0
    rand_out = capsys.readouterr().out
    assert splat_out and rand_out and splat_out != rand_out
    # the same rewrite as the JAX package's: its run of the rewritten text
    # prints the port's numbers
    from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
    ref = jax_ir.parse_module(str(port))
    want = jax_run_module(ref, init_type="rand", seed=7,
                          linalg_to_loops=True,
                          out_stream=io.StringIO())["outputs"][0]
    got = tpp_run.run_module(parse_module(str(port)), init_type="rand",
                             seed=7, linalg_to_loops=True, device="cpu",
                             out_stream=io.StringIO())["outputs"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("stage", ["early", "mid", "late", "kernel"])
def test_print_mlir_stages(tmp_path, capsys, stage):
    f = tmp_path / "m.ir"
    f.write_text(gen("--batch=8 --layers=16,16 --bias --relu --softmax "
                     "--output=generic".split()))
    assert tpp_run.main([str(f), "--device", "cpu", "--print-mlir",
                         stage]) == 0
    err = capsys.readouterr().err
    if stage == "early":
        assert "tl.generic" in err and "xsmm" not in err
    elif stage == "kernel":
        lines = [x for x in err.splitlines() if x.startswith("// kernel")]
        assert len(lines) == 4, err
        assert "tpp_mlir_tpu_torch/csrc/brgemm.cu" in lines[0]
        assert all("no kernel: a PyTorch op" in x for x in lines[1:])
        assert all("(on cpu: its plain version)" in x for x in lines)
    else:
        assert "xsmm.fused_brgemm" in err and "tl.generic" not in err


def _built(build, key, route):
    from tpp_mlir_tpu_torch.xsmm.kernels import (build_conv, build_kernel,
                                                 build_warm)
    if build == "kernel":
        return build_kernel(key)
    return {"warm": build_warm, "conv": build_conv}[build](key, route)


# a built Kernel carries the route and csrc/ source its launcher chose,
# a forced one included; --print-mlir kernel prints these
@pytest.mark.parametrize("build,key,route,source", [
    ("kernel", ChainKey(m=17, dims=(48, 160, 48), dtype="bf16"), "panel",
     "chain.cu"),
    ("warm", ChainKey(m=17, dims=(48, 160, 48), dtype="bf16"), "wmma",
     "chain.cu"),
    ("kernel", ConvNhwcKey(N=2, H=10, W=10, C=64, K=64, R=3, S=3,
                           dtype="bf16"), "tma", "conv.cu"),
    ("conv", ConvNhwcKey(N=2, H=10, W=10, C=64, K=64, R=3, S=3,
                         dtype="bf16"), "wmma", "conv.cu"),
    ("kernel", FlashTrainKey(2, 2, 64, 64, dtype="bf16"), "wgmma",
     "attention.cu"),
    ("kernel", FlashTrainKey(2, 2, 64, 64, dtype="f32"), "fma",
     "flash_train.cu"),
    ("kernel", UnaryKey(kind="relu", shape=(8, 16), dtype="f32"), None,
     None),
], ids=["chain", "chain-forced", "conv", "conv-forced", "flash-bf16",
        "flash-f32", "unary"])
def test_kernel_records_the_route_its_launcher_chose(build, key, route,
                                                     source):
    kern = _built(build, key, route)
    assert kern.route == route
    assert kern.source == (source and f"tpp_mlir_tpu_torch/csrc/{source}")


def test_verbose_prints_builds_and_launches(tmp_path, capsys):
    f = tmp_path / "m.ir"
    f.write_text(gen("--batch=8 --layers=16,16,16 --bias --relu".split()))
    assert tpp_run.main([str(f), "--device", "cpu", "-n", "2", "-v"]) == 0
    err = capsys.readouterr().err
    assert re.search(r"kernel cache: \d+ kernels, \d+ hits, \d+ misses", err)
    # on the CPU the plain versions run: no launch is counted
    assert "chain 8x16x16x16 f32: 0 launches" in err


def test_profile_cli(tmp_path):
    """--profile writes a torch.profiler chrome trace."""
    f = tmp_path / "m.mlir"
    f.write_text("""func @entry(%x: tensor<8x8xf32>) {
  %0 = tl.relu %x : tensor<8x8xf32>
  return %0 : tensor<8x8xf32>
}
""")
    prof = tmp_path / "trace"
    assert tpp_run.main([str(f), "--device", "cpu", "--profile",
                         str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


NAN = """func @entry(%x: tensor<8x8xf32>) {
  %0 = tl.rsqrt %x : tensor<8x8xf32>
  %1 = tl.negate %0 : tensor<8x8xf32>
  return %1 : tensor<8x8xf32>
}
"""


def test_sanitize_nan_names_the_first_op(tmp_path):
    """--sanitize nan raises at the first op whose output is not finite
    (rsqrt of a negative or zero input), not later; without it the run
    completes."""
    f = tmp_path / "m.mlir"
    f.write_text(NAN)
    argv = [str(f), "--device", "cpu", "-init-type", "normal",
            "--linalg-to-loops"]
    assert tpp_run.main(argv) == 0
    with pytest.raises(FloatingPointError, match="tl.rsqrt"):
        tpp_run.main(argv + ["--sanitize", "nan"])
    f.write_text(NAN.replace("tl.rsqrt", "tl.exp"))
    assert tpp_run.main(argv + ["--sanitize", "nan"]) == 0
