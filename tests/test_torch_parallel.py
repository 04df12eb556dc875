"""The port's mesh, collectives, runner and dry run
(tpp_mlir_tpu_torch.parallel.mesh, collectives, runner), held against the
JAX package's on a mesh of the same shape over its virtual CPU devices.

One gloo world of 4 ranks on the CPU runs every case of this file
(`core_world` in tests/torch_parallel_workers.py, a JAX-free module) and
returns each rank's numpy results: mesh coordinates, shards of a tree,
each collective's value and gradient per rank, the data-parallel runner,
the task grid and `dryrun_multichip(4)`. The JAX side is the same code
under `jax.shard_map` (check_vma=False, as the JAX package runs it). f32
throughout: collectives that move data are exact; a sum is held at 1e-5.
`tpp_run --task-grid 2x1` runs under `torch.distributed.run` with two
ranks, against the JAX tool's `run_module(task_grid="2")`."""

import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tpp_mlir_tpu.parallel import collectives as JC
from tpp_mlir_tpu.parallel import data_parallel_run as jax_dp_run
from tpp_mlir_tpu.parallel import make_mesh as jax_make_mesh
from tpp_mlir_tpu.parallel.optim import _zero1_spec as jax_zero1_spec
from tpp_mlir_tpu.tools.mlir_gen import build_parser, config_from_args, \
    generate_text
from tpp_mlir_tpu_torch.parallel import P, spawn
from tpp_mlir_tpu_torch.parallel.optim import _zero1_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


INPUTS = {"tree": _normal(0, (4, 6)), "x": _normal(1, (12, 5)),
          "w": _normal(2, (5, 3))}
for _i, (_name, _xs, _ys) in enumerate([
        ("row_parallel_psum", (12, 5), (12, 5)),
        ("gather_cols", (12, 5), (12, 20)),
        ("mark_replicated", (12, 5), (12, 5)),
        ("pmax_stopgrad", (12, 5), (12, 5)),
        ("ring_shift", (12, 5), (12, 5)),
        ("all_to_all", (16, 5), (16, 5))]):
    INPUTS[_name + "_x"] = _normal(10 + _i, _xs)
    INPUTS[_name + "_ct"] = _normal(20 + _i, _ys)


@pytest.fixture(scope="module")
def world():
    from torch_parallel_workers import core_world
    return spawn(core_world, WORLD, "gloo", "cpu", (INPUTS,))


def _jax_dual(name, x, ct):
    """(value, gradient) of the JAX collective under shard_map over tp=4,
    each shard's block stacked on dim 0."""
    f = {"row_parallel_psum": lambda v: JC.row_parallel_psum(v, "tp"),
         "gather_cols": lambda v: JC.gather_cols(v, "tp", 1),
         "mark_replicated": lambda v: JC.mark_replicated(v, "tp"),
         "pmax_stopgrad": lambda v: JC.pmax_stopgrad(v, "tp"),
         "ring_shift": lambda v: jax.lax.ppermute(
             v, "tp", [(i, (i + 1) % 4) for i in range(4)]),
         "all_to_all": lambda v: jax.lax.all_to_all(v, "tp", 0, 0,
                                                    tiled=True)}[name]

    def body(v, c):
        y, vjp = jax.vjp(f, v)
        return y, vjp(c)[0]
    out = jax.shard_map(body, mesh=jax_make_mesh({"tp": 4}),
                        in_specs=(JP("tp"), JP("tp")),
                        out_specs=(JP("tp"), JP("tp")), check_vma=False)(
                            jnp.asarray(x), jnp.asarray(ct))
    return tuple(np.asarray(o) for o in out)


def test_mesh_coordinates_follow_the_jax_device_layout(world):
    """Rank r sits where the JAX mesh puts device r: the row-major
    coordinate of r in the mesh shape."""
    jmesh = jax_make_mesh({"dp": 2, "tp": 2})
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, out in enumerate(world):
        assert ids[out["coord"]] == r
        assert out["grid"] == ({"dp": 2, "tp": 2},) + out["coord"]


def test_a_mesh_larger_than_the_world_raises_in_jax_words(world):
    template = "mesh {{'dp': {n}}} needs {n} devices, have {have}"
    with pytest.raises(ValueError) as e:
        jax_make_mesh({"dp": 16})
    assert str(e.value) == template.format(n=16, have=len(jax.devices()))
    assert world[0]["too_big"] == template.format(n=8, have=4)
    assert "needs 8 devices, have 4" in world[0]["grid_too_big"]


@pytest.mark.parametrize("leaf,spec", [("a", JP("dp", "tp")),
                                       ("b", JP(None, "tp")), ("c", JP())])
def test_shard_tree_gives_each_rank_its_jax_shard(world, leaf, spec):
    """shard_tree is device_put with a NamedSharding: rank r's shard is the
    JAX shard on device r; gather_tree gives back the whole tree."""
    jmesh = jax_make_mesh({"dp": 2, "tp": 2})
    arr = jax.device_put(INPUTS["tree"], NamedSharding(jmesh, spec))
    shards = {s.device.id: np.asarray(s.data)
              for s in arr.addressable_shards}
    for r, out in enumerate(world):
        np.testing.assert_array_equal(out["shards"][leaf], shards[r])
        assert out["round_trip"]


@pytest.mark.parametrize("name", ["row_parallel_psum", "gather_cols",
                                  "mark_replicated", "pmax_stopgrad",
                                  "ring_shift", "all_to_all"])
def test_collective_value_and_gradient_match_jax(world, name):
    """Each dual's forward and backward (the JAX custom VJP, or autodiff of
    ppermute / all_to_all) per rank, on a tp=4 axis."""
    want_y, want_g = _jax_dual(name, INPUTS[name + "_x"],
                               INPUTS[name + "_ct"])
    got_y = np.concatenate([o[name][0] for o in world])
    got_g = np.concatenate([o[name][1] for o in world])
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-5)


def test_no_rank_loads_jax(world):
    """A spawned rank holds no module of JAX, Triton, ml_dtypes or the JAX
    package (test_torch_imports.py checks a second world)."""
    for out in world:
        assert not [m for m in out["modules"] if m.split(".")[0] in (
            "jax", "jaxlib", "triton", "ml_dtypes", "tpp_mlir_tpu")]


def test_mean_over_is_pmean_and_cpu_tensors_are_not_staged(world):
    for out in world:
        np.testing.assert_array_equal(out["mean_over"], np.full(3, 1.5))
        assert out["staged"] is False


def test_data_parallel_run_matches_jax(world):
    jmesh = jax_make_mesh({"dp": 4})
    fn = jax_dp_run(lambda a, b: jnp.maximum(a @ b, 0), jmesh, [0], 2)
    want = np.asarray(fn(INPUTS["x"], INPUTS["w"]))
    for out in world:
        np.testing.assert_allclose(out["dp_run"], want, rtol=1e-5,
                                   atol=1e-6)


def test_task_grid_run_gathers_every_output(world):
    x, w = INPUTS["x"][:8], INPUTS["w"]
    for out in world:
        y, s = out["grid_run"]
        np.testing.assert_allclose(y, x @ w, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s, x.sum(1, keepdims=True), rtol=1e-5,
                                   atol=1e-6)


def test_bench_driver_task_grid_entry(world):
    """An entry's `task_grid` ("2x2": dp 2, tp 2) runs the lowered program at
    each rank's half of the batch and gathers it (taskgrid.json's scaling
    rows): the lowered whole-batch run's output, row for row, and within
    the MLP modules' 1e-2 of --linalg-to-loops (max|diff| / max|ref|)."""
    for out in world:
        got, whole, loops = out["bench_grid"]
        assert got.shape == whole.shape == (8, 16)
        np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-6)
        assert np.abs(got - loops).max() <= 1e-2 * np.abs(loops).max()


DRYRUN_MODES = ["mlp step loss", "mlp step params", "conv", "attention",
                "transformer block", "tp MHA", "pp pipeline",
                "pp train loss", "sp ring attention", "ep MoE",
                "tp decode float", "tp decode int8", "zero1 adamw",
                "gpt step loss"]


@pytest.mark.parametrize("mode", DRYRUN_MODES)
def test_dryrun_multichip_runs_every_mode(world, mode):
    """dryrun_multichip(4): every mode of `__graft_entry__.py:30` ran on
    every rank and passed its `_check` (1e-3 * scale + 1e-4; a failed check
    fails the world); the errors come back finite."""
    for out in world:
        assert np.isfinite(out["dryrun"][mode])


@pytest.mark.parametrize("spec,shape,ndp", [
    (("", "tp"), (64, 128), 4), (("tp", ""), (64, 128), 4),
    (("tp",), (66,), 4), ((), (8, 6), 2), (("", ""), (3, 6), 2)])
def test_zero1_spec_picks_the_first_free_divisible_dim(spec, shape, ndp):
    """_zero1_spec's rule is the JAX function's (tests/parallel/
    test_optim.py:110 there), on the same inputs."""
    spec = tuple(a or None for a in spec)
    want = jax_zero1_spec(JP(*spec), shape, "dp", ndp)
    got = _zero1_spec(P(*spec), shape, "dp", ndp)
    assert tuple(got) == tuple(want) + (None,) * (len(got) - len(want))


def test_tpp_run_task_grid_under_torchrun(tmp_path):
    """`tpp_run --task-grid 2x1 --device cpu` under torch.distributed.run
    with two gloo ranks prints the JAX tool's task-grid output (precision
    highest: f32 products on both sides)."""
    from tpp_mlir_tpu.ir import parse_module as jax_parse
    from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
    text = generate_text(config_from_args(build_parser().parse_args(
        ["--batch=16", "--layers=32,32,32", "--bias", "--relu"])))
    path = tmp_path / "mlp.ir"
    path.write_text(text)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tpp_mlir_tpu_torch.tools.tpp_run",
         str(path), "--task-grid", "2x1", "--device", "cpu", "--print",
         "--precision", "highest", "-seed", "3"],
        capture_output=True, text=True, env=env, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "backend gloo, 2 ranks" in run.stderr
    got = np.array([[float(v) for v in line.strip("() ").split(",")]
                    for line in run.stdout.splitlines()
                    if line.startswith("(")], np.float32)
    ref = jax_parse(text)
    ref.attrs["precision"] = "highest"
    want = np.asarray(jax_run_module(ref, seed=3, task_grid="2",
                                     out_stream=io.StringIO())["outputs"][0])
    assert got.shape == want.shape == (16, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
