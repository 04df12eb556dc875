"""tpp-run's --register-blocking on the port against the JAX package's, on
the CPU: tile-and-fuse binds the same ops (tile_m/n/k and
`register_blocked`), the executor makes the same key bm/bn/bk, the run
gives the same output (f32 "highest" 1e-5: sum order only; f32 "default"
and bf16 1e-2: the port rounds f32 operands to bf16 as the compiled TPU
kernels do, interpret mode does not), the Kernel records the Hopper plan
the blocking names, and a blocking the kernel does not run raises.
Mirrors tests/passes/test_pass_options.py:61.
"""

import io

import numpy as np
import pytest

from tpp_mlir_tpu.ir import parse_module as ref_parse_module
from tpp_mlir_tpu.passes import run_pipeline as ref_run_pipeline
from tpp_mlir_tpu.runtime.executor import _dispatch_key as ref_dispatch_key
from tpp_mlir_tpu.tools.tpp_run import run_module as ref_run_module
from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.passes import make_pass, run_pipeline
from tpp_mlir_tpu_torch.runtime.executor import _dispatch_key, module_keys
from tpp_mlir_tpu_torch.tools import tpp_run
from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser, config_from_args,
                                               generate_text)
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import global_cache

FC = "--batch=64 --layers=256,256 --bias --relu"
BLOCKING = (64, 128, 128)


def _text(flags: str) -> str:
    return generate_text(config_from_args(build_parser().parse_args(
        flags.split())))


def _modules(flags: str, blocking=BLOCKING, precision="default"):
    """The same tpp-gen module parsed by the port and by the JAX package,
    with the module attr tpp-run's --register-blocking sets."""
    out = []
    for parse in (parse_module, ref_parse_module):
        m = parse(_text(flags))
        m.attrs["register_blocking"] = blocking
        if precision != "default":
            m.attrs["precision"] = precision
        out.append(m)
    return out


def _blocked(module) -> list:
    return [(op.opname, tuple(op.attrs.get(f"tile_{x}") for x in "mnk"))
            for op in module["entry"].ops if op.attrs.get("register_blocked")]


@pytest.mark.parametrize("flags", [FC, FC + " --float-type=bf16",
                                   "--batch=64 --layers=256,128"])
def test_tile_and_fuse_binds_the_same_ops(flags):
    port, ref = _modules(flags)
    run_pipeline(port, "tile-and-fuse")
    ref_run_pipeline(ref, "tile-and-fuse")
    assert _blocked(port) == _blocked(ref) == [
        (_blocked(port)[0][0], BLOCKING)]


def test_the_blocks_option_binds_as_the_module_attr():
    m = parse_module(_text(FC))
    make_pass("tile-and-fuse", blocks=BLOCKING).run(m)
    assert _blocked(m) == [("tl.matmul", BLOCKING)]


def _keys(port, ref):
    def key_of(m, dispatch_key):
        inv = next(op for op in m["entry"].ops
                   if op.opname.startswith("xsmm.")
                   and not op.opname.endswith("_dispatch"))
        return dispatch_key(inv.operands[0].owner, inv)
    return key_of(port, _dispatch_key), key_of(ref, ref_dispatch_key)


@pytest.mark.parametrize("flags", [FC, FC + " --float-type=bf16",
                                   "--batch=64 --layers=256,128"])
def test_the_key_carries_the_same_blocks(flags):
    port, ref = _modules(flags)
    run_pipeline(port, "default-tpp-passes")
    ref_run_pipeline(ref, "default-tpp-passes")
    got, want = _keys(port, ref)
    assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk) \
        == BLOCKING


def test_without_the_flag_the_tiles_stay_out_of_the_key():
    m = parse_module(_text(FC))
    run_pipeline(m, "default-tpp-passes")
    (_, key), = module_keys(m)
    assert (key.bm, key.bn, key.bk) == (0, 0, 0)


CASES = {
    "f32-default": (FC, "default", 1e-2),
    "f32-highest": (FC, "highest", 1e-5),
    "bf16": (FC + " --float-type=bf16", "default", 1e-2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_run_matches_the_jax_register_blocked_run(name):
    flags, precision, tol = CASES[name]
    blocking = (64, 64, 256) if precision == "highest" else BLOCKING
    port, ref = _modules(flags, blocking, precision)
    want = np.asarray(ref_run_module(ref, seed=3, out_stream=io.StringIO())[
        "outputs"][0], np.float32)
    got = run_module(port, seed=3, device="cpu",
                     out_stream=io.StringIO())["outputs"][0].float().numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= tol
    # the kernel recorded the Hopper plan the blocking names: the tile, and
    # ceil(256 / bk) k slices
    (_, key), = module_keys(port)
    plan = global_cache().dispatch(key).plan
    assert tuple(plan) == ((64, 64, 1) if precision == "highest"
                           else (64, 128, 2))


def test_cli_prints_the_plan_it_ran(tmp_path, capsys):
    f = tmp_path / "fc.ir"
    f.write_text(_text(FC))
    assert tpp_run.main([str(f), "--device", "cpu", "-registerBlocking",
                         "64,128,256", "--print-mlir", "kernel", "-v"]) == 0
    err = capsys.readouterr().err
    assert "plan 64x128 split 1" in err, err
    assert "256x256 f32 +add +relu: 0 launches, plan 64x128 split 1" in err


@pytest.mark.parametrize("blocking,precision,match", [
    ("32,32,32", "default", "64-deep k stage"),
    ("128,64,256", "default", "the tile is one of 128x128, 64x128, 64x64"),
    ("64,128,256", "highest", "the tile is one of 64x64"),
    ("64,64,64", "highest", "f32-FMA body"),
])
def test_an_illegal_blocking_raises(tmp_path, blocking, precision, match):
    f = tmp_path / "fc.ir"
    f.write_text(_text(FC))
    with pytest.raises(ValueError, match=match):
        tpp_run.main([str(f), "--device", "cpu", "--register-blocking",
                      blocking, "--precision", precision])
