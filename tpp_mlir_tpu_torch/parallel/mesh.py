"""Device meshes over a torch.distributed world: the port of
`tpp_mlir_tpu/parallel/mesh.py`, and the world launcher and the shard/gather
pair the port's parallel layer stands on.

The JAX package is SPMD in one process: `shard_map` over a
`jax.sharding.Mesh`, arrays placed by `PartitionSpec`. The port is SPMD over
processes, in the Megatron idiom: one rank per device, a
`torch.distributed.device_mesh.DeviceMesh` whose named dims (dp, tp, pp, sp,
ep) give the process groups, and each rank holding only its shard, on which
it runs what the JAX `shard_map` body computes, with the port's kernels on
plain local tensors.

- `P` is the port's `PartitionSpec`: a tuple of axis names or None per dim.
- `make_mesh(shape)` is a `Mesh` over the first prod(shape) ranks (a rank
  outside it has no coordinate); with no world, only a mesh of one device.
- `shard_tree(tree, specs, mesh)` takes a full tree, the same on every rank,
  to this rank's shard: the counterpart of `device_put` with a
  `NamedSharding`. `gather_tree` all-gathers the shards back.
- `init_world` joins the world torchrun describes; `spawn` starts one on
  this host (tests, chip_smoke) and returns each rank's result.

The backend is chosen by the caller (nccl or gloo) and never swapped. A
gloo group's collective on CUDA tensors runs on a host copy
(`collectives.py`); NCCL refuses two ranks on one device, so a world of two
ranks on one card is a gloo world.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils.target import resolve_device

# a collective that waits longer than this on a dead peer fails the rank
TIMEOUT = timedelta(seconds=300)


class P(tuple):
    """A partition spec: per dim an axis name (the dim is split over that
    mesh axis, in the mesh coordinate's order) or None (replicated);
    missing trailing dims are replicated. `P()` replicates a leaf."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Named axes over ranks: `shape` {axis: size}, this rank's coordinate
    on each axis (`index`), and each axis's process group (`group`). A mesh
    made without a world (`device_mesh` None) has one device and no groups:
    every collective over it is the identity, as over a size-1 axis."""

    def __init__(self, shape: dict, device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self._coord = (device_mesh.get_coordinate() if device_mesh is not None
                       else [0] * len(self.shape))

    @property
    def member(self) -> bool:
        """Whether this rank is in the mesh."""
        return self._coord is not None

    def size(self, axis: str | None) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def index(self, axis: str | None) -> int:
        """This rank's coordinate on `axis` (0 on an absent axis)."""
        if not axis or axis not in self.shape:
            return 0
        return self._coord[list(self.shape).index(axis)]

    def group(self, axis: str | None):
        """The axis's process group, or None (no world, or an absent axis):
        the collectives treat None as a one-device axis."""
        if self.device_mesh is None or not axis or axis not in self.shape:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape})"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: dict[str, int] | None = None) -> Mesh:
    """A Mesh from {axis: size} over the first prod(sizes) ranks of the
    world (JAX: the first prod(sizes) devices); default all ranks on one
    'dp' axis. Every rank of the world calls it (it makes the groups)."""
    have = world_size()
    if shape is None:
        shape = {"dp": have}
    sizes = tuple(shape.values())
    n = math.prod(sizes)
    if n > have:
        raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    if not dist.is_initialized():
        return Mesh(shape)
    from torch.distributed.device_mesh import DeviceMesh
    # the DeviceMesh's type labels where its groups run: a gloo world
    # stages CUDA tensors through the host (collectives.py)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(kind, torch.arange(n).reshape(sizes),
                    mesh_dim_names=tuple(shape))
    return Mesh(shape, dm)


def task_grid_mesh(grid=(2, 8)) -> Mesh:
    """The reference's `parallel-task-grid` (default 2x8) as a (dp, tp)
    mesh."""
    return make_mesh({"dp": grid[0], "tp": grid[1]})


def as_mesh(mesh) -> Mesh:
    """A Mesh from a Mesh, or from a {axis: size} mapping (`make_mesh`), or
    None or a mapping of one device: a mesh of one device with no groups,
    whatever the world (each rank alone, as a single-device run)."""
    if isinstance(mesh, Mesh):
        return mesh
    shape = dict(mesh or {})
    if math.prod(shape.values()) == 1:
        return Mesh(shape)
    return make_mesh(shape)


def mesh_shape(mesh) -> dict:
    """{axis: size} of a Mesh or a mapping, without making a mesh."""
    if mesh is None:
        return {}
    return dict(mesh.shape if isinstance(mesh, Mesh) else mesh)


# ---------------------------------------------------------------------------
# the world

def rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: cuda:{local_rank % device_count} for "cuda" (made
    current), else the device named."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_world(backend: str | None = None, device="cuda") -> torch.device:
    """Join the world torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT); `backend` defaults to nccl on CUDA and gloo
    on the CPU. Returns this rank's device."""
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        timeout=TIMEOUT)
    return dev


def join_world(device="cuda", shape: dict | None = None):
    """A tool's world: torchrun's, or a world of one without torchrun, for
    a mesh of `shape` (one larger than the world raises make_mesh's
    ValueError before anything is joined). Returns (this rank's device,
    where the rank prints: rank 0 to stdout, the others into a buffer
    nobody reads). Rank 0 names the backend and world size on stderr."""
    import io
    import sys
    n = math.prod((shape or {}).values())
    have = int(os.environ.get("WORLD_SIZE", 1))
    if n > have:
        raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    if "WORLD_SIZE" not in os.environ:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=_free_port())
    dev = init_world(device=device)
    if dist.get_rank() == 0:
        print(f"# world: backend {dist.get_backend()}, "
              f"{dist.get_world_size()} ranks, {dev}", file=sys.stderr)
        return dev, sys.stdout
    return dev, io.StringIO()


def _free_port() -> str:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def _rank_main(rank, fn, world, backend, device, init_file, out_dir, args):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    dev = rank_device(device, rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = fn(rank, world, dev, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


class World:
    """A world of `world` new processes on this host running
    `fn(rank, world, device, *args)`, joined in a `backend` world (a file
    rendezvous in a fresh temporary directory, so concurrent worlds do not
    collide). It runs while its caller goes on; `result()` waits for it and
    returns each rank's result, in rank order. `fn` must be importable by
    name (a module-level function); results must pickle (numpy arrays,
    numbers). A rank that raises fails `result()`, and the other ranks are
    stopped."""

    def __init__(self, fn, world: int, backend: str, device="cuda", args=()):
        import torch.multiprocessing as mp
        resolve_device(device)
        self._n = world
        self._dir = tempfile.TemporaryDirectory(prefix="tpp_world_")
        d = self._dir.name
        self._ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, world, backend, str(device),
                  os.path.join(d, "rendezvous"), d, args))
        self._out = None

    def result(self) -> list:
        if self._out is None:
            try:
                while not self._ctx.join():
                    pass
                out = []
                for r in range(self._n):
                    # the files this world's own ranks just wrote
                    with open(os.path.join(self._dir.name, f"rank{r}.pkl"),
                              "rb") as f:
                        out.append(pickle.load(f))
                self._out = out
            finally:
                self._dir.cleanup()
        return self._out


def spawn(fn, world: int, backend: str, device="cuda", args=()) -> list:
    """`World(...).result()`: run `fn` on a new world and wait for it."""
    return World(fn, world, backend, device, args).result()


# ---------------------------------------------------------------------------
# shard and gather

def _spec_axes(spec, ndim: int) -> list:
    parts = list(spec or ())
    if len(parts) > ndim:
        raise ValueError(f"spec {spec} has more dims than the leaf's {ndim}")
    return parts + [None] * (ndim - len(parts))


def shard_tensor(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a full tensor: each dim split over its spec
    axis, the block at the rank's coordinate, as a new contiguous tensor
    (a replicated leaf too, as `device_put` makes new arrays), detached."""
    t = t.detach()
    out = t
    for dim, axis in enumerate(_spec_axes(spec, t.dim())):
        k = mesh.size(axis)
        if axis is None or k == 1:
            continue
        n = t.shape[dim]
        if n % k:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"{axis}={k}")
        out = out.narrow(dim, mesh.index(axis) * (n // k), n // k)
    return out.clone(memory_format=torch.contiguous_format)


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    from .collectives import all_gather
    return all_gather(t, group, dim)


def gather_tensor(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's block (shard_tensor's inverse)."""
    for dim, axis in enumerate(_spec_axes(spec, t.dim())):
        if axis is not None and mesh.group(axis) is not None:
            t = _all_gather(t, dim, mesh.group(axis))
    return t


def _qtensor_map(leaf, spec, mesh: Mesh, fn):
    """shard or gather one QTensor by its spec's q and scale parts. An
    int4 payload packs two values a byte along the last dim, so a split of
    that dim must leave an even count a shard; the K-major copy `qt` is
    made anew from the result, never sliced from another copy."""
    from ..serving.quant import QTensor, _kmajor
    qspec = _spec_axes(spec.q, leaf.q.dim())
    shape = leaf.shape
    if leaf.bits == 4 and qspec[-1] is not None:
        k = mesh.size(qspec[-1])
        n = leaf.dims[-1]
        if fn is shard_tensor and (n % k or (n // k) % 2):
            raise ValueError(
                f"int4 weight of {n} columns over {qspec[-1]}={k}: int4 "
                f"packs two values a byte along the columns, so each shard "
                f"needs an even column count")
        if shape is not None:
            s = list(shape)
            s[-1] = n // k if fn is shard_tensor else n * k
            shape = tuple(s)
    if leaf.bits == 4 and qspec[0] is not None and shape is not None:
        s = list(shape)
        k = mesh.size(qspec[0])
        s[0] = s[0] // k if fn is shard_tensor else s[0] * k
        shape = tuple(s)
    out = QTensor(q=fn(leaf.q, spec.q, mesh), scale=fn(leaf.scale,
                  spec.scale, mesh), bits=leaf.bits, shape=shape)
    return _kmajor(out) if leaf.qt is not None else out


def _map_tree(tree, specs, mesh: Mesh, fn):
    from ..serving.quant import QTensor
    if isinstance(tree, QTensor):
        if isinstance(specs, QTensor):
            return _qtensor_map(tree, specs, mesh, fn)
        return tree                         # replicated
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: _map_tree(v, specs[k], mesh, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if isinstance(specs, P):            # one spec for every leaf
            specs = [specs] * len(tree)
        return type(tree)(_map_tree(v, s, mesh, fn)
                          for v, s in zip(tree, specs, strict=True))
    return tree                             # numbers, None


def shard_tree(tree, specs, mesh: Mesh):
    """This rank's shard of a full tree (dicts, lists, tuples, QTensors,
    tensors) laid out by `specs`, a tree of the same structure with a `P`
    (or a QTensor of `P`s) at each leaf; `mesh` as `as_mesh` takes it."""
    return _map_tree(tree, specs, as_mesh(mesh), shard_tensor)


def gather_tree(tree, specs, mesh: Mesh):
    """The full tree from every rank's shard (every rank of the mesh
    calls it and gets the whole tree)."""
    return _map_tree(tree, specs, as_mesh(mesh), gather_tensor)
