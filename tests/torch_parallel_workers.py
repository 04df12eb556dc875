"""Rank bodies for the port's parallel tests (tests/test_torch_parallel*.py,
tests/test_torch_tp_serving.py).

Each test file starts one gloo world on the CPU (`parallel.mesh.spawn`) that
runs one function below over all of that file's cases, and returns numpy
results per rank; the test process holds them against the JAX package's
sharded functions on a mesh of the same shape. This module imports no JAX
(a spawned rank imports it by name), nor anything of `tpp_mlir_tpu`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpp_mlir_tpu_torch.parallel import collectives as C
from tpp_mlir_tpu_torch.parallel.mesh import (P, gather_tree, make_mesh,
                                              shard_tree)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    return t


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return _np(tree)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def loaded_modules(rank, world, device, roots):
    """tests/test_torch_imports.py: the dry run on this world, then the
    modules under `roots` that this rank holds."""
    from tpp_mlir_tpu_torch.parallel import dryrun_multichip
    dryrun_multichip(world, device=device)
    return sorted(m for m in sys.modules if m.split(".")[0] in roots)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py: mesh, collectives, runner, the dry run

DUALS = {
    "row_parallel_psum": lambda x, g: C.row_parallel_psum(x, g),
    "gather_cols": lambda x, g: C.gather_cols(x, g, 1),
    "mark_replicated": lambda x, g: C.mark_replicated(x, g),
    "pmax_stopgrad": lambda x, g: C.pmax_stopgrad(x, g),
    "ring_shift": lambda x, g: C.ring_shift(x, g),
    "all_to_all": lambda x, g: C.all_to_all(x, g),
}


def core_world(rank, world, device, inputs):
    """Mesh coordinates, shards, every collective's value and gradient
    (each rank's block), the runner, the task grid and the dry run."""
    from tpp_mlir_tpu_torch.parallel import (data_parallel_run,
                                             dryrun_multichip, task_grid_mesh,
                                             task_grid_run)
    out = {"modules": sorted(sys.modules)}
    mesh = make_mesh({"dp": 2, "tp": 2})
    out["coord"] = (mesh.index("dp"), mesh.index("tp"))
    grid = task_grid_mesh((2, 2))
    out["grid"] = (grid.shape, grid.index("dp"), grid.index("tp"))
    try:
        make_mesh({"dp": 8})
    except ValueError as e:
        out["too_big"] = str(e)
    full = _t(inputs["tree"])
    specs = {"a": P("dp", "tp"), "b": P(None, "tp"), "c": P()}
    tree = {"a": full, "b": full, "c": full}
    local = shard_tree(tree, specs, mesh)
    out["shards"] = _tree_np(local)
    back = gather_tree(local, specs, mesh)
    out["round_trip"] = all(torch.equal(back[k], full) for k in back)

    tp4 = make_mesh({"tp": 4})
    g = tp4.group("tp")
    for name, f in DUALS.items():
        x = _t(inputs[name + "_x"]).chunk(4)[rank].clone().requires_grad_()
        y = f(x, g)
        ct = _t(inputs[name + "_ct"]).chunk(4)[rank]
        (gx,) = torch.autograd.grad(y, x, ct)
        out[name] = (_np(y), _np(gx))
    # the dp mean of a grad (pmean) and the staging rule of a CPU tensor
    out["mean_over"] = _np(C.mean_over(torch.full((3,), float(rank)), g))
    out["staged"] = C.staged(g, torch.zeros(1))

    dp4 = make_mesh({"dp": 4})
    w = _t(inputs["w"])
    run = data_parallel_run(lambda a, b: torch.relu(a @ b), dp4, [0], 2)
    out["dp_run"] = _np(run(_t(inputs["x"]), w))
    grid_run = task_grid_run(lambda a, b: (a @ b, a.sum(1, keepdim=True)),
                             "2x2", 2)
    out["grid_run"] = _tree_np(grid_run(_t(inputs["x"][:8]), w))
    try:
        task_grid_run(lambda a: a, "8", 1)
    except ValueError as e:
        out["grid_too_big"] = str(e)
    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    gen = "--batch=8 --layers=16,16 --bias --relu"
    res = run_entry({"gen": gen, "task_grid": "2x2"}, device="cpu")
    whole = run_entry({"gen": gen}, device="cpu")
    out["bench_grid"] = (_np(res["lowered"]["outputs"][0]),
                         _np(whole["lowered"]["outputs"][0]),
                         _np(res["baseline"]["outputs"][0]))
    out["dryrun"] = dryrun_multichip(world, device=device)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_train.py: the MLP, optimizer and GPT steps

MLP_CASES = {"mlp-dp2": {"dp": 2, "tp": 1}, "mlp-tp2": {"dp": 1, "tp": 2},
             "mlp-dp2tp2": {"dp": 2, "tp": 2}, "mlp-tp4": {"dp": 1, "tp": 4}}
# name: (mesh, accum_steps, zero1)
OPT_CASES = {"optim-tp2": ({"dp": 1, "tp": 2}, 1, False),
             "zero1": ({"dp": 2, "tp": 2}, 2, True),
             "zero1-dp4": ({"dp": 4, "tp": 1}, 1, True),
             "adamw-dp4": ({"dp": 4, "tp": 1}, 1, False)}
# name: (mesh, zero1, vocab_parallel, config overrides)
GPT_CASES = {"gpt-dp2tp2": ({"dp": 2, "tp": 2}, False, False, {}),
             "gpt-zero1": ({"dp": 2, "tp": 2}, True, False, {}),
             "vocab-parallel": ({"dp": 1, "tp": 2}, False, True, {}),
             "gpt-tp4-zero1-vocab": ({"dp": 1, "tp": 4}, True, True, {}),
             "moe-dp2": ({"dp": 2, "tp": 1}, False, False,
                         {"n_experts": 4})}


def _mlp(inputs):
    from tpp_mlir_tpu_torch.parallel import mlp_params_from_numpy
    return mlp_params_from_numpy(inputs["mlp_params"], device="cpu")


def _sgd_runs(inputs, layers, mesh, steps, lr, kernels):
    """(losses, gathered params) of `steps` SGD steps over `mesh`."""
    from tpp_mlir_tpu_torch.parallel import make_train_step, param_specs
    specs = param_specs(len(layers) - 1)
    x, y = _t(inputs["mlp_x"]), _t(inputs["mlp_y"])
    params = shard_tree(_mlp(inputs), specs, mesh)
    step = make_train_step(layers, lr, use_kernels=kernels, device="cpu",
                           mesh=mesh, precision="highest")
    losses = []
    for _ in range(steps):
        params, loss = step(params, shard_tree(x, P("dp"), mesh),
                            shard_tree(y, P("dp"), mesh))
        losses.append(float(loss))
    return losses, _tree_np(gather_tree(params, specs, mesh))


def _optim_runs(inputs, layers, mesh, accum, zero1, steps):
    from tpp_mlir_tpu_torch.parallel import (adamw, make_optim_train_step,
                                             param_specs)
    specs = param_specs(len(layers) - 1)
    params = shard_tree(_mlp(inputs), specs, mesh)
    step, init = make_optim_train_step(layers, adamw(1e-2),
                                       accum_steps=accum, zero1=zero1,
                                       use_kernels=False, device="cpu",
                                       mesh=mesh)
    opt = init(params)
    x, y = (shard_tree(_t(inputs[k]), P("dp"), mesh)
            for k in ("mlp_x", "mlp_y"))
    losses = [float(step(params, opt, x, y)[2]) for _ in range(steps)]
    return params, opt, losses, step, (x, y), specs


def _gpt_run(inputs, name):
    import tpp_mlir_tpu_torch.serving as S
    from tpp_mlir_tpu_torch.parallel import (adamw, gpt_param_specs,
                                             make_gpt_train_step)
    shape, zero1, vocab, extra = GPT_CASES[name]
    mesh = make_mesh(shape)
    if not mesh.member:
        return None
    cfg = S.GptConfig(**inputs["gpt_cfg"], **extra)
    full = S.params_from_numpy(inputs["moe_params" if extra else
                                      "gpt_params"], cfg, device="cpu")
    specs = gpt_param_specs(cfg, vocab_parallel=vocab)
    params = shard_tree(full, specs, mesh)
    step, init = make_gpt_train_step(cfg, adamw(1e-2, eps=1e-4),
                                     device="cpu", mesh=mesh, zero1=zero1,
                                     vocab_parallel=vocab)
    opt = init(params)
    ids = shard_tree(torch.from_numpy(inputs["gpt_ids"]), P("dp"), mesh)
    losses = [float(step(params, opt, ids)[2]) for _ in range(2)]
    return losses, _tree_np(gather_tree(params, specs, mesh))


def _grads_at(inputs, layers, shape, kernels):
    """One SGD step at lr 1: the gathered (params before - after), the
    complete gradients."""
    mesh = make_mesh(shape) if shape else None
    if mesh is not None and not mesh.member:
        return None
    _, after = _sgd_runs(inputs, layers, mesh, 1, 1.0, kernels)
    before = _tree_np(_mlp(inputs))
    return [[b - a for b, a in zip(bb, aa)] for bb, aa in zip(before, after)]


def _vocab_parallel_vs_replicated(inputs):
    import tpp_mlir_tpu_torch.serving as S
    from tpp_mlir_tpu_torch.parallel import (gpt_param_specs,
                                             make_gpt_train_step, sgd)
    mesh = make_mesh({"tp": 2})
    if not mesh.member:
        return None
    cfg = S.GptConfig(**inputs["gpt_cfg"])
    out = []
    for vocab in (False, True):
        specs = gpt_param_specs(cfg, vocab_parallel=vocab)
        params = shard_tree(S.params_from_numpy(inputs["gpt_params"], cfg,
                                                device="cpu"), specs, mesh)
        step, init = make_gpt_train_step(cfg, sgd(1.0), device="cpu",
                                         mesh=mesh, vocab_parallel=vocab)
        loss = float(step(params, init(params),
                          torch.from_numpy(inputs["gpt_ids"]))[2])
        out.append((loss, _tree_np(gather_tree(params, specs, mesh))))
    return out


def train_world(rank, world, device, inputs):
    from tpp_mlir_tpu_torch.parallel import (restore_checkpoint,
                                             save_checkpoint)
    layers = inputs["layers"]
    out = {"modules": sorted(sys.modules)}
    for name, shape in MLP_CASES.items():
        mesh = make_mesh(shape)
        if mesh.member:
            out[name] = _sgd_runs(inputs, layers, mesh, 3, 0.05, False)
    for kernels in (False, True):
        for shape in (None, {"tp": 2}, {"dp": 2, "tp": 2}):
            key = ("grads", kernels, tuple((shape or {}).items()))
            out[key] = _grads_at(inputs, layers, shape, kernels)
    for name, (shape, accum, zero1) in OPT_CASES.items():
        mesh = make_mesh(shape)
        if not mesh.member:
            continue
        params, opt, losses, _, _, specs = _optim_runs(
            inputs, layers, mesh, accum, zero1, 3)
        out[name] = (losses, _tree_np(gather_tree(params, specs, mesh)))
        if zero1:
            out[name + "-moments"] = [
                (opt.optimizer.state[s]["exp_avg"].numel(), t.numel())
                for s, t in zip(opt.slices, opt.leaves)]
    # ZeRO-1 checkpoint: saved gathered, restored onto the same mesh and
    # onto another, each resumed run against the uninterrupted one
    mesh = make_mesh({"dp": 2, "tp": 2})
    params, opt, _, step, batch, specs = _optim_runs(
        inputs, layers, mesh, 1, True, 4)
    out["ckpt-uninterrupted"] = _tree_np(gather_tree(params, specs, mesh))
    params, opt, _, step, batch, specs = _optim_runs(
        inputs, layers, mesh, 1, True, 2)
    save_checkpoint(inputs["ckpt"], {"params": params, "opt": opt}, step=2,
                    specs={"params": specs, "opt": None}, mesh=mesh)
    for label, shape in (("same", {"dp": 2, "tp": 2}),
                         ("dp4", {"dp": 4, "tp": 1})):
        m = make_mesh(shape)
        q, t, _, s, b, sp = _optim_runs(inputs, layers, m, 1, True, 0)
        with torch.no_grad():                   # a fresh start, overwritten
            for w, _ in q:
                w.zero_()
        like = {"params": q, "opt": t}
        got, at = restore_checkpoint(inputs["ckpt"], like, step=2,
                                     specs={"params": sp, "opt": None},
                                     mesh=m)
        for _ in range(2):
            s(got["params"], got["opt"], *b)
        out["ckpt-" + label] = (at, _tree_np(gather_tree(got["params"], sp,
                                                         m)))
    for name in GPT_CASES:
        out[name] = _gpt_run(inputs, name)
    out["vocab-vs-replicated"] = _vocab_parallel_vs_replicated(inputs)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_modes.py: tp MHA, pipeline, ring attention, MoE

# name: (mesh, dtype, causal, kernels)
MHA_CASES = {"dp2tp2": ({"dp": 2, "tp": 2}, "float32", False, False),
             "tp4-causal": ({"dp": 1, "tp": 4}, "float32", True, False),
             "tp2-bf16": ({"dp": 1, "tp": 2}, "bfloat16", False, False),
             "tp2-kernels": ({"dp": 1, "tp": 2}, "float32", True, True)}
# name: (pp, dp, n_micro, kernels)
PIPE_CASES = {"pp4-m4": (4, 1, 4, False), "pp4-m5": (4, 1, 5, False),
              "pp2-kernels": (2, 1, 4, True)}
PIPE_TRAIN = {"pp4": {"pp": 4}, "pp2-dp2": {"pp": 2, "dp": 2}}
RING_CASES = {"causal": (True, torch.float32), "full": (False, torch.float32),
              "causal-bf16": (True, torch.bfloat16)}
# name: (n_experts, capacity, dtype)
MOE_CASES = {"e4": (4, None, torch.float32), "e8": (8, None, torch.float32),
             "e4-drops": (4, 2, torch.float32),
             "e8-bf16": (8, None, torch.bfloat16)}


def _bf16(a):
    """A bf16 tensor from uint16 bits (how bf16 crosses to a rank)."""
    return torch.from_numpy(np.ascontiguousarray(a)).view(torch.bfloat16)


def modes_world(rank, world, device, inputs):
    from tpp_mlir_tpu_torch.parallel import (
        make_mha_forward, make_moe_forward, make_pipeline_forward,
        make_pipeline_train_step, make_ring_attention, mha_param_specs,
        mha_params_from_numpy, moe_param_specs, moe_params_from_numpy,
        pipeline_param_specs, pipeline_params_from_numpy, sgd)
    out = {}
    for name, (shape, dtype, causal, kernels) in MHA_CASES.items():
        mesh = make_mesh(shape)
        if not mesh.member:
            continue
        p = mha_params_from_numpy(inputs["mha_" + dtype], device="cpu")
        x = inputs["mha_x_" + dtype]
        x = _bf16(x) if dtype == "bfloat16" else _t(x)
        fwd = make_mha_forward(mesh, 32, 8, causal=causal,
                               use_kernels=kernels)
        y = fwd(shard_tree(p, mha_param_specs(), mesh),
                shard_tree(x, P("dp"), mesh))
        out["mha-" + name] = _np(gather_tree(y, P("dp"), mesh))
    for name, (pp, _, n_micro, kernels) in PIPE_CASES.items():
        mesh = make_mesh({"pp": pp})
        if not mesh.member:
            continue
        p = pipeline_params_from_numpy(inputs[f"pipe{pp}"], device="cpu")
        fwd = make_pipeline_forward(mesh, 16, use_kernels=kernels)
        out["pipe-" + name] = _np(fwd(
            shard_tree(p, pipeline_param_specs(), mesh),
            _t(inputs["pipe_xs"][:n_micro])))
    for name, shape in PIPE_TRAIN.items():
        mesh = make_mesh(shape)
        dp = "dp" if "dp" in shape else None
        p = shard_tree(pipeline_params_from_numpy(
            inputs[f"pipe{shape['pp']}"], device="cpu"),
            pipeline_param_specs(), mesh)
        step, init = make_pipeline_train_step(mesh, 16, sgd(1e-2),
                                              dp_axis=dp, use_kernels=False)
        opt = init(p)
        data = P(None, dp) if dp else P()
        xs, ys = (shard_tree(_t(inputs[k]), data, mesh)
                  for k in ("pipe_xs", "pipe_ys"))
        losses = [float(step(p, opt, xs, ys)[2]) for _ in range(3)]
        out["pipetrain-" + name] = (losses, _tree_np(
            gather_tree(p, pipeline_param_specs(), mesh)))
    sp = make_mesh({"sp": 4})
    seq = P(None, "sp")
    for name, (causal, dt) in RING_CASES.items():
        q, k, v = (_t(inputs["ring_" + c]).to(dt) for c in "qkv")
        local = [shard_tree(t, seq, sp).requires_grad_(dt == torch.float32)
                 for t in (q, k, v)]
        o = make_ring_attention(sp, 2, causal=causal)(*local)
        out["ring-" + name] = _np(gather_tree(o, seq, sp))
        if dt == torch.float32:
            ct = shard_tree(_t(inputs["ring_ct"]), seq, sp)
            grads = torch.autograd.grad(o, local, ct)
            out["ringgrad-" + name] = [_np(gather_tree(g, seq, sp))
                                       for g in grads]
    ep = make_mesh({"ep": 4})
    for name, (n_e, cap, dt) in MOE_CASES.items():
        p = moe_params_from_numpy(inputs[f"moe{n_e}"], device="cpu")
        p = {k: v.to(dt) for k, v in p.items()}
        x = _t(inputs["moe_x"]).to(dt)
        y = make_moe_forward(ep, 16, 32, n_e, capacity=cap)(
            shard_tree(p, moe_param_specs(), ep), shard_tree(x, P("ep"), ep))
        out["moe-" + name] = _np(gather_tree(y, P("ep"), ep))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_tp_serving.py: the tp decode and the tp batching engine

SERVE = dict(vocab=96, embed=64, heads=4, layers=2, mlp_ratio=2, max_seq=24,
             dtype="f32")
# name: (config overrides, weight bits)
TP_CASES = {"f32": ({}, 0), "gqa": ({"kv_heads": 2}, 0), "int8": ({}, 8),
            "int4": ({}, 4), "kv-int8": ({"kv_quant": "int8"}, 0),
            "decode-kernel": ({"decode_attn": "pallas"}, 0),
            "gqa-kv-int8-kernel": ({"kv_heads": 2, "kv_quant": "int8",
                                    "decode_attn": "pallas"}, 0)}
TP_STEPS = 8


def _serve_params(inputs, cfg, bits):
    import tpp_mlir_tpu_torch.serving as S
    params = S.params_from_numpy(inputs["serve_params"][cfg.kv_h], cfg,
                                 device="cpu")
    return S.quantize_params(params, bits=bits) if bits else params


def _greedy(step, params, cache, tok):
    """TP_STEPS greedy decode steps: (tokens (B, TP_STEPS), logits)."""
    toks, logits = [], []
    for _ in range(TP_STEPS):
        lg, _ = step(params, cache, tok)
        tok = lg.argmax(-1).to(torch.int32)
        toks.append(_np(tok))
        logits.append(_np(lg))
    return np.stack(toks, 1), np.stack(logits, 1)


def tp_serving_world(rank, world, device, inputs):
    import tpp_mlir_tpu_torch.serving as S
    from tpp_mlir_tpu_torch.serving.engine import (decode_cache_specs,
                                                   decode_param_specs,
                                                   make_tp_decode_step)
    out = {"modules": sorted(sys.modules)}
    mesh = make_mesh({"tp": world})
    ids = torch.from_numpy(inputs["serve_ids"])
    for name, (extra, bits) in TP_CASES.items():
        cfg = S.GptConfig(**SERVE, **extra)
        params = _serve_params(inputs, cfg, bits)
        prefill = S.make_prefill(cfg, use_kernels=False)
        logits, cache = prefill(params, ids)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        local = shard_tree(cache, decode_cache_specs(cfg), mesh)
        lparams = shard_tree(params, decode_param_specs(
            cfg, quantized=bool(bits)), mesh)
        step = make_tp_decode_step(mesh, cfg)
        out["tp-" + name] = _greedy(step, lparams, local, tok)
        out["one-" + name] = _greedy(S.make_decode_step(cfg), params, cache,
                                     tok)
        out["shapes-" + name] = {k: tuple(v.shape) for k, v in local.items()}
    cfg = S.GptConfig(**SERVE)
    params = _serve_params(inputs, cfg, 0)
    for label, tp in (("tp", mesh), ("one", None)):
        eng = S.BatchingEngine(params, cfg, slots=2, sync_steps=3,
                               buckets=(8, 16), tp_mesh=tp)
        rids = [eng.submit(p, max_new=5) for p in inputs["serve_prompts"]]
        done = eng.run()
        out["batching-" + label] = [done[r] for r in rids]
    return out
