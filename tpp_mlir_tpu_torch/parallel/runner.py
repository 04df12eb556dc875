"""Sharded execution of compiled programs: the port of
`tpp_mlir_tpu/parallel/runner.py`, and the multi-device dry run of
`__graft_entry__.py:30 dryrun_multichip`.

`data_parallel_run` is the multi-device face of the reference's
`--def-parallel` flag: the batch (leading) dim of the designated args
splits over the mesh's 'dp' axis, every rank runs the same compiled
function on its slice, and the outputs are gathered back along their batch
dim. The JAX package hands a global function to GSPMD; the port runs `fn`
as the local body (SPMD over ranks), which is the same thing for a
batch-parallel program: a pure data-parallel forward has no collective.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .mesh import P, as_mesh, gather_tree, make_mesh, shard_tree, world_size


def shard_run(fn: Callable, mesh, in_specs, out_specs=None) -> Callable:
    """`run(*full_args)`: each arg's shard by its spec (None replicates),
    `fn` on the shards, and with out_specs the outputs gathered by theirs
    (one spec for every output, or one each); without, fn's local
    outputs."""
    mesh = as_mesh(mesh)
    if not mesh.member:
        raise ValueError(f"this rank is outside the mesh {mesh.shape}: run "
                         f"a world of the mesh's size")

    def run(*args):
        local = [shard_tree(a, s, mesh) for a, s in zip(args, in_specs,
                                                        strict=True)]
        out = fn(*local)
        return out if out_specs is None else gather_tree(out, out_specs,
                                                         mesh)
    return run


def data_parallel_run(fn: Callable, mesh, batch_arg_indices: Sequence[int],
                      num_args: int, axis: str = "dp") -> Callable:
    """Split the leading dim of the given args over `axis`, replicate the
    rest; gather every output along its leading dim."""
    batch = set(batch_arg_indices)
    specs = [P(axis) if i in batch else P() for i in range(num_args)]
    return shard_run(fn, mesh, specs, P(axis))


def parse_task_grid(task_grid) -> dict:
    """"DPxTP" (or "DP,TP", or "DP") as a mesh shape: dp, and tp when > 1."""
    dims = [int(x) for x in str(task_grid).replace("x", ",").split(",")]
    shape = {"dp": dims[0]}
    if len(dims) > 1 and dims[1] > 1:
        shape["tp"] = dims[1]
    return shape


def local_batch(module, func_name: str, parts: int) -> None:
    """Rewrite `func_name` in place to 1/parts of its batch: every value
    whose leading dim is the batch (arg 0's leading dim B) gets B/parts
    rows. The executor runs IR of static shapes, so a rank's slice needs a
    program of its own size, where the JAX package lets GSPMD partition one
    trace. A weight (a constant that is not a zero init) of B rows is
    ambiguous and refused."""
    func = module[func_name]
    B = func.args[0].type.shape[0]
    if B % parts:
        raise ValueError(f"batch {B} does not split over dp {parts}")
    values = list(func.args)
    for op in func.ops:
        if op.opname == "tl.constant" and op.attrs.get("init") != "zero" \
                and op.result.type.shape[:1] == (B,):
            raise ValueError(f"a weight of {B} rows (the batch) in "
                             f"{func_name}: cannot tell it from the batch")
        values += op.results
    for v in values:
        if v.type.shape[:1] == (B,):
            v.type = v.type.with_shape((B // parts,) + v.type.shape[1:])


def task_grid_run(inner, task_grid, num_args, batch_arg_indices=(0,)):
    """Wire a compiled function over a --task-grid mesh: "DPxTP" splits the
    leading batch dim of the args over dp, with tp available to
    tensor-parallel programs. One definition shared by tpp_run and the bench
    driver. A grid larger than the world raises in make_mesh's words."""
    return data_parallel_run(inner, make_mesh(parse_task_grid(task_grid)),
                             list(batch_arg_indices), num_args)


# ---------------------------------------------------------------------------
# the dry run

def _check(sharded, unsharded, label: str) -> float:
    """The JAX dry run's differential check: max|diff| <= 1e-3 * max|ref|
    + 1e-4. Returns the error."""
    s = np.asarray(torch.as_tensor(sharded).detach().float().cpu())
    u = np.asarray(torch.as_tensor(unsharded).detach().float().cpu())
    if s.shape != u.shape:
        raise AssertionError(f"{label}: shapes {s.shape} vs {u.shape}")
    err = float(np.max(np.abs(s - u)))
    if not err <= 1e-3 * (float(np.max(np.abs(u))) + 1e-6) + 1e-4:
        raise AssertionError(f"sharded {label} diverges from unsharded: "
                             f"max|diff|={err}")
    return err


def _normal(seed: int, shape, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)).to(device)


def _program(build, batch: int, parts: int, seed: int, shard_args, mesh,
             device):
    """A builder's program at `batch` run whole, and data-parallel over
    `mesh`, each rank running the same builder at its share of the batch
    (the builders draw their weights from a seed, whatever the batch);
    (sharded, unsharded) first outputs."""
    from ..passes import PassManager
    from ..runtime import compile as tpp_compile
    from ..tools.tpp_run import init_args
    fns = []
    for b in (batch // parts, batch):
        m = build(b)
        PassManager(["default-tpp-passes"]).run(m)
        fns.append(tpp_compile(m, device=device))
    args = init_args(m, "entry", "normal", seed, device)
    out = data_parallel_run(fns[0], mesh, shard_args, len(args))(*args)
    ref = fns[1](*args)
    first = (lambda o: o[0] if isinstance(o, tuple) else o)
    return first(out), first(ref)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Every mode the JAX dry run runs, on this world's first n_devices
    ranks (every rank of the world calls it), each held against its
    unsharded run by `_check`: the dp x tp MLP step, the data-parallel
    convnet, MHA and transformer block, the tp MHA, the pipeline forward and
    train, ring attention, ep MoE, the tp decode (float and int8 weights),
    the ZeRO-1 AdamW step with accumulation and the GPT step. Returns
    {mode: max|diff|}."""
    from ..models import mha
    from ..models.convnet import ConvConfig, build_convnet
    from ..models.transformer_block import build_transformer_block
    from ..serving import (GptConfig, init_params, make_decode_step,
                           make_prefill, quantize_params)
    from ..serving.engine import (decode_cache_specs, decode_param_specs,
                                  make_tp_decode_step)
    from .gpt_train import gpt_param_specs, make_gpt_train_step
    from .moe import make_moe_forward, moe_init, moe_param_specs, \
        moe_reference
    from .optim import adamw, make_optim_train_step, sgd
    from .pipeline import (make_pipeline_forward, make_pipeline_train_step,
                           pipeline_init, pipeline_param_specs,
                           pipeline_reference)
    from .sequence import make_ring_attention, ring_attention_reference
    from .train import make_train_step, mlp_init, param_specs
    from .transformer import make_mha_forward, mha_param_specs, mha_params

    n = n_devices
    if world_size() < n:
        raise ValueError(f"dryrun_multichip({n}) needs a world of {n} "
                         f"ranks, have {world_size()}")
    dev = torch.device(device)
    errs = {}
    shape = ({"dp": n // 2, "tp": 2} if n >= 4 else
             {"dp": 1, "tp": 2} if n == 2 else {"dp": 1, "tp": 1})
    mesh, one = make_mesh(shape), None       # one: each rank alone
    nd = shape["dp"]

    # the dp x tp MLP SGD step, B1 on its shards
    layers = (128, 256, 128)
    params = mlp_init(layers, seed=0, device=dev)
    x, y = (_normal(s, (16 * nd, 128), dev) for s in (0, 1))
    want = make_train_step(layers, 1e-2, device=dev, mesh=one)(params, x, y)
    got = make_train_step(layers, 1e-2, device=dev, mesh=mesh)(
        shard_tree(params, param_specs(2), mesh),
        shard_tree(x, P("dp"), mesh), shard_tree(y, P("dp"), mesh))
    errs["mlp step loss"] = _check(got[1], want[1], "mlp step loss")
    new = gather_tree(got[0], param_specs(2), mesh)
    errs["mlp step params"] = max(
        _check(a, b, "mlp step params") for ab, wb in zip(new, want[0])
        for a, b in zip(ab, wb))

    # the data-parallel convnet, MHA and transformer block
    dp_mesh = make_mesh({"dp": n})
    errs["conv"] = _check(*_program(
        lambda b: build_convnet(ConvConfig(
            batch=b, channels=16, filters=16, height=10, width=10,
            layout="nhwc")), 2 * n, n, 0, [0], dp_mesh, dev), "conv")
    errs["attention"] = _check(*_program(
        lambda b: mha.build_mha(batch=b, heads=2, seq=128, head_dim=32,
                                fused=True, scale=0.125),
        n, n, 1, [0, 1, 2], dp_mesh, dev), "attention")
    errs["transformer block"] = _check(*_program(
        lambda b: build_transformer_block(batch=b, seq=128, embed=64,
                                          heads=2),
        n, n, 3, [0], dp_mesh, dev), "fused transformer block")

    # the Megatron MHA: heads over tp, the batch over dp
    E, H = 64, 8
    tshape = {"dp": max(1, n // 4), "tp": min(4, n)}
    tpmesh = make_mesh(tshape)
    p = mha_params(E, H, seed=0, device=dev)
    xt = _normal(2, (2 * tshape["dp"], 16, E), dev)
    mout = make_mha_forward(tpmesh, E, H)(
        shard_tree(p, mha_param_specs(), tpmesh),
        shard_tree(xt, P("dp"), tpmesh))
    mref = make_mha_forward(one, E, H)(p, xt)
    errs["tp MHA"] = _check(gather_tree(mout, P("dp"), tpmesh), mref,
                            "tp-sharded MHA")

    # the pipeline forward and training over pp
    pp_mesh = make_mesh({"pp": n})
    d = 64
    pparams = pipeline_init(d, n_stages=n, seed=0, device=dev)
    pxs = _normal(3, (2 * n, 8, d), dev)
    plocal = shard_tree(pparams, pipeline_param_specs(), pp_mesh)
    pout = make_pipeline_forward(pp_mesh, d, use_kernels=False)(plocal, pxs)
    errs["pp pipeline"] = _check(pout, pipeline_reference(pparams, pxs),
                                 "pp pipeline")
    ptstep, ptinit = make_pipeline_train_step(pp_mesh, d, sgd(1e-2),
                                              use_kernels=False)
    ptys = _normal(13, tuple(pxs.shape), dev)
    _, _, ptloss = ptstep(plocal, ptinit(plocal), pxs, ptys)
    ref = pipeline_reference(pparams, pxs).float()
    errs["pp train loss"] = _check(ptloss, torch.mean((ref - ptys) ** 2),
                                   "pp train loss vs oracle")

    # ring attention over sp, causal
    sp_mesh = make_mesh({"sp": n})
    q, k, v = (_normal(4 + i, (2, 16 * n, 2, 16), dev) for i in range(3))
    seq = P(None, "sp")
    rout = make_ring_attention(sp_mesh, heads=2, causal=True)(
        *(shard_tree(t, seq, sp_mesh) for t in (q, k, v)))
    errs["sp ring attention"] = _check(
        gather_tree(rout, seq, sp_mesh),
        ring_attention_reference(q, k, v, causal=True), "sp ring attention")

    # the ep MoE: experts over ep, two all-to-alls
    ep_mesh = make_mesh({"ep": n})
    eparams = moe_init(32, 64, 2 * n, seed=5, device=dev)
    ex = _normal(6, (8 * n, 32), dev)
    eout = make_moe_forward(ep_mesh, 32, 64, 2 * n)(
        shard_tree(eparams, moe_param_specs(), ep_mesh),
        shard_tree(ex, P("ep"), ep_mesh))
    errs["ep MoE"] = _check(gather_tree(eout, P("ep"), ep_mesh),
                            moe_reference(eparams, ex), "ep MoE")

    # the tp decode, float and int8 weights, against the one-device step
    scfg = GptConfig(vocab=96, embed=64, heads=max(4, min(8, n)), layers=2,
                     mlp_ratio=2, max_seq=16, dtype="f32")
    stp = make_mesh({"tp": min(4, n)})
    sids = torch.from_numpy(np.random.default_rng(8).integers(
        0, scfg.vocab, (2, 6)).astype(np.int32)).to(dev)
    stok = torch.full((2,), 3, dtype=torch.int32, device=dev)
    for label, sparams in (("float", init_params(scfg, seed=7, device=dev)),
                           ("int8", None)):
        quant = sparams is None
        if quant:
            sparams = quantize_params(init_params(scfg, seed=7, device=dev))
        _, cache = make_prefill(scfg, use_kernels=False)(sparams, sids)
        local = shard_tree(cache, decode_cache_specs(scfg), stp) \
            if stp.member else None
        sref, _ = make_decode_step(scfg)(sparams, cache, stok)
        if stp.member:
            sout, _ = make_tp_decode_step(stp, scfg)(
                shard_tree(sparams, decode_param_specs(scfg, quantized=quant),
                           stp), local, stok)
            errs[f"tp decode {label}"] = _check(
                sout, sref, f"tp serving decode ({label} weights)")

    # ZeRO-1 AdamW with accumulation against the one-device step
    olayers = (64, 128, 64, 64)
    oparams = mlp_init(olayers, seed=2, device=dev)
    ox, oy = (_normal(s, (4 * nd, 64), dev) for s in (11, 12))
    ospecs = param_specs(3)
    olocal = shard_tree(oparams, ospecs, mesh)
    ostep, oinit = make_optim_train_step(olayers, adamw(1e-2), accum_steps=2,
                                         zero1=True, device=dev, mesh=mesh)
    ostep(olocal, oinit(olocal), shard_tree(ox, P("dp"), mesh),
          shard_tree(oy, P("dp"), mesh))
    rparams = tuple((w.clone(), b.clone()) for w, b in oparams)
    rstep, rinit = make_optim_train_step(olayers, adamw(1e-2), device=dev,
                                         mesh=one, use_kernels=False)
    rstep(rparams, rinit(rparams), ox, oy)
    errs["zero1 adamw"] = max(
        _check(a, b, "zero1 adamw") for ab, wb in
        zip(gather_tree(olocal, ospecs, mesh), rparams)
        for a, b in zip(ab, wb))

    # the GPT step over dp x tp: its step-0 loss is the prefill's CE
    from .gpt_train import next_token_loss
    gcfg = GptConfig(vocab=64, embed=32, heads=4, layers=2, mlp_ratio=2,
                     max_seq=16, dtype="f32")
    gparams = init_params(gcfg, seed=9, device=dev)
    gids = torch.from_numpy(np.random.default_rng(10).integers(
        0, gcfg.vocab, (2 * nd, 12)).astype(np.int32)).to(dev)
    glogits, _ = make_prefill(gcfg, use_kernels=False)(gparams, gids)
    gwant = next_token_loss(glogits, gids)
    gmesh = make_mesh({"dp": nd, "tp": min(2, max(1, n // nd))})
    glocal = shard_tree(gparams, gpt_param_specs(gcfg), gmesh)
    gstep, ginit = make_gpt_train_step(gcfg, adamw(1e-2), device=dev,
                                       mesh=gmesh)
    _, _, gloss = gstep(glocal, ginit(glocal),
                        shard_tree(gids, P("dp"), gmesh))
    errs["gpt step loss"] = _check(gloss, gwant,
                                   "gpt train step loss vs prefill CE")
    return errs
