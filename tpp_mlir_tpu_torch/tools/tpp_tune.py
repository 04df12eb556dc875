"""tpp-tune on PyTorch/CUDA: sweep the launch plans of a program's kernels
on the card and record the winners in the tuning table.

The port's counterpart of `tpp_mlir_tpu/tools/tpp_tune.py`. The plans are
Hopper's (xsmm/tune.py): for a GEMM key (B1/B2 BrgemmKey, B19
BlockedMatmulKey) the mainloop's output tile and k split, swept over every
legal tile and the splits 1, 2, 4, 8 and twice the heuristic's (at most the
key's 64-deep stages); for a program that is one warm-benchable chain or fc
(B3/B4/B5, a ChainKey) the warm-panel engine's panel rows (WARM_ROWS) x
every cluster size reference.warm_plan places, a cluster the card cannot
hold (kernels.warm_max_clusters) skipped. A chain is timed through its
in-kernel repeats (B4, whose key_tag is B3's), a GEMM key alone on
synthesized operands; every time is from a CUDA graph of --iters calls
(runtime/perf.py graph_seconds), three rounds with the heuristic re-timed in
each round beside the candidates, the median kept. A candidate beating the
heuristic by more than --min-gain percent is recorded with its sweep and
the card's name (`device_kind`): only that card's launches read it. The
last line of stdout is JSON: the keys recorded, the table, and each key's
heuristic and best plan with their times.

  python -m tpp_mlir_tpu_torch.tools.tpp_tune \\
      --gen "--batch=256 --layers=1024,1024,1024,1024 --bias --relu \\
             --float-type=bf16"
  python -m tpp_mlir_tpu_torch.tools.tpp_tune -c cfg.json --filter 'gpt*'
  python -m tpp_mlir_tpu_torch.tools.tpp_tune --gen "..." --key BrgemmKey
  python -m tpp_mlir_tpu_torch.tools.tpp_tune --gen "..." --dry \\
      --device cpu            # list keys and candidates, no card needed

As in the JAX tool, a program that is one warm-benchable chain tunes that
chain; `--key` filters every key's tag, so `--key BrgemmKey` tunes a one-
layer fc's GEMM key instead of its B4 chain. TPP_TUNING_PATH names another
table (xsmm/tune.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import statistics
import sys

import torch

ROUNDS = 3           # timing rounds, the heuristic re-timed in each
WARM_REPEATS = 20    # a chain's in-kernel repeats a timed launch
SPLITS = (1, 2, 4, 8)


def _gemm_keys(module) -> list:
    """Deduped B1/B2 and B19 keys of every GEMM invoke of the program."""
    from ..runtime.executor import module_keys
    from ..xsmm import tune
    from ..xsmm.flags import BlockedMatmulKey, BrgemmKey

    keys, seen = [], set()
    for _, key in module_keys(module):
        if not isinstance(key, (BrgemmKey, BlockedMatmulKey)) or \
                getattr(key, "repeats", 0):
            continue
        tag = tune.key_tag(key)
        if tag not in seen:
            seen.add(tag)
            keys.append(key)
    return keys


def gemm_candidates(key, heuristic) -> list[dict]:
    """The legal plans around the heuristic: each legal tile at splits
    1, 2, 4, 8 and twice the heuristic's, at most the key's stages (no
    split on the FMA body and under ln_stats_out), the heuristic left out."""
    from ..xsmm import reference
    tiles, most = reference.legal_gemm_plans(key)
    splits = sorted({s for s in (*SPLITS, 2 * heuristic.split)
                     if s <= most})
    return [{"bm": bm, "bn": bn, "split": s} for bm, bn in tiles
            for s in splits
            if (bm, bn, s) != tuple(heuristic)]


def warm_candidates(key) -> list[dict]:
    """Panel rows x cluster sizes the warm-panel engine places at `key`
    (reference.warm_plan), the heuristic's left out."""
    from ..xsmm import reference
    heur = reference.warm_plan(key)
    out = []
    for rows in reference.WARM_ROWS:
        for cluster in range(1, reference.WARM_MAX_CLUSTER + 1):
            plan = reference.warm_plan(key, rows=rows, cluster=cluster)
            if plan is not None and (rows, cluster) != (heur.rows,
                                                        heur.cluster):
                out.append({"bm": rows, "cluster": cluster})
    return out


def _randn(shape, dtype, g, scale=1.0):
    return (torch.randn(shape, generator=g, device=g.device) *
            scale).to(dtype)


def gemm_operands(key, device) -> tuple:
    """Operands of a B1/B2 or B19 key at its shapes, seeded, B scaled so
    the epilogue's unary stays in range."""
    from ..xsmm import reference
    from ..xsmm.flags import BrgemmKey
    g = torch.Generator(device=device).manual_seed(0)
    dt = reference.DTYPES[key.dtype]
    if isinstance(key, BrgemmKey):
        B, m, n, k = key.batch, key.m, key.n, key.k
        a = _randn((B, m, k), dt, g)
        b = _randn((B, n, k) if key.transpose_b else (B, k, n), dt, g, 0.03)
        if key.vnni:
            b = b.reshape(B, k // key.vnni, key.vnni, n).transpose(
                2, 3).contiguous()
        c = None if key.beta0 else _randn((m, n), dt, g)
        d = None
        if key.binary_kind:
            shape = {"bcast_col": (n,), "bcast_row": (m,),
                     "bcast_scalar": (1,)}.get(key.binary_bcast, (m, n))
            d = _randn(shape, dt, g, 0.1)
        args = [a, b, c, d]
        if key.prologue == "layer_norm" and key.prologue_affine:
            args += [_randn((k,), torch.float32, g, 0.1) + 1.0,
                     _randn((k,), torch.float32, g, 0.1)]
        return tuple(args)
    a = _randn((key.Mb, key.Kb, key.mb, key.kb), dt, g)
    v = key.vnni
    b = _randn((key.Nb, key.Kb, key.kb // v, key.nb, v) if v else
               (key.Nb, key.Kb, key.kb, key.nb), dt, g, 0.03)
    c = None if key.beta0 else _randn((key.Mb, key.Nb, key.mb, key.nb),
                                      dt, g)
    d = _randn((key.Nb * key.nb,), dt, g, 0.1) if key.binary_kind else None
    return a, b, c, d


def _time(key, cfg: dict, operands, iters: int) -> float:
    """Milliseconds of one launch of `key` built under `cfg` (the table's
    form; {} the heuristic), from a CUDA graph."""
    from ..runtime.perf import graph_seconds
    from ..xsmm import tune
    from ..xsmm.kernels import build_kernel
    with tune.trial(key, cfg):
        fn = build_kernel(key)
    return graph_seconds(lambda: fn(*operands), iters) * 1e3


def sweep(key, cands: list[dict], operands, iters: int, out) -> list[dict]:
    """Time the heuristic ({}) and every candidate in ROUNDS interleaved
    rounds; rows of {"cfg", "ms"} (the median), rows[0] the heuristic."""
    cfgs = [{}] + cands
    times = [[] for _ in cfgs]
    for _ in range(ROUNDS):
        for i, cfg in enumerate(cfgs):
            times[i].append(_time(key, cfg, operands, iters))
    rows = [{"cfg": cfg, "ms": statistics.median(t)}
            for cfg, t in zip(cfgs, times)]
    for r in rows:
        what = r["cfg"] or "heuristic"
        print(f"  {what}: {r['ms']:.5f} ms (heuristic {rows[0]['ms']:.5f} "
              f"ms, {rows[0]['ms'] / r['ms']:.3f}x)", file=out)
    return rows


def _placeable(key, cfg: dict) -> bool:
    """Whether the card holds at least one cluster of the plan."""
    from ..xsmm import reference
    from ..xsmm.kernels import warm_max_clusters
    plan = reference.warm_plan(key, rows=cfg["bm"], cluster=cfg["cluster"])
    return warm_max_clusters(plan.rows, plan.cluster, plan.smem) > 0


def _decide(key, heuristic: dict, rows: list[dict], min_gain: float,
            kind: str, out) -> dict:
    """Record the best row if it beats the heuristic by more than min_gain
    percent; the key's summary for the JSON line."""
    from ..xsmm import tune
    base = rows[0]["ms"]
    best = min(rows, key=lambda r: r["ms"])
    gain = (base / best["ms"] - 1) * 100
    recorded = best is not rows[0] and gain > min_gain
    if recorded:
        tune.record(key, best["cfg"], best["ms"], base, kind, rows)
        print(f"  RECORDED {best['cfg']} (+{gain:.1f}%)", file=out)
    else:
        print(f"  heuristic stands (best {best['cfg'] or 'heuristic'}, "
              f"+{max(gain, 0.0):.1f}%)", file=out)
    return {"tag": tune.key_tag(key), "heuristic": heuristic,
            "heuristic_ms": base, "best": best["cfg"] or heuristic,
            "best_ms": best["ms"], "recorded": recorded}


def _entries(args) -> list[dict]:
    from .bench_driver import load_config
    entries = []
    if args.gen:
        entries.append({"name": "cli", "gen": args.gen})
    for path in args.config:
        entries += [e for e in load_config(path)
                    if fnmatch.fnmatch(e["name"], args.filter)]
    return entries


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpp-tune (torch)", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-c", "--config", action="append", default=[],
                   help="a benchmark config (its entries' gen, model or "
                        "file, as bench_driver.build_module builds them)")
    p.add_argument("--filter", default="*",
                   help="fnmatch pattern over the config entries' names")
    p.add_argument("--gen", help="tpp-gen flags for a one-off program")
    p.add_argument("--iters", type=int, default=20,
                   help="calls a timed CUDA graph replays")
    p.add_argument("--dry", action="store_true",
                   help="list kernels and candidates, do not measure")
    p.add_argument("--min-gain", type=float, default=3.0,
                   help="record a winner only if it beats the heuristic "
                        "by this many percent (same-process comparison)")
    p.add_argument("--key", default="",
                   help="only tune kernel keys whose tag contains this "
                        "substring")
    p.add_argument("--device", default="cuda",
                   help="cuda (measure), or cpu with --dry")
    p.add_argument("--sms", type=int, default=0,
                   help="SMs the --dry heuristic plans for (default: the "
                        "card's, or the H100's 132 without one)")
    args = p.parse_args(argv)

    from ..passes import PassManager
    from ..runtime.executor import extract_bench_kernel
    from ..utils.target import resolve_device
    from ..xsmm import reference, tune
    from ..xsmm.flags import ChainKey
    from ..xsmm.kernels import gemm_plan
    from .bench_driver import build_module
    from .tpp_run import init_args

    entries = _entries(args)
    if not entries:
        print("nothing matched", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    if not args.dry and device.type != "cuda":
        raise SystemExit("tpp-tune measures on the card: --device cuda, "
                         "or --dry to list candidates")
    out = sys.stderr
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else None
    sms = args.sms or (torch.cuda.get_device_properties(
        device).multi_processor_count if kind else reference.H100_SMS)
    summary = []
    for entry in entries:
        print(f"== {entry['name']}", file=out)
        module = build_module(entry)
        PassManager([entry.get("pipeline", "default-tpp-passes")]).run(
            module)

        hit = extract_bench_kernel(module)
        if hit is not None and isinstance(hit[0], ChainKey) and \
                args.key in tune.key_tag(hit[0]):
            key, get_operands = hit
            print(f" {tune.key_tag(key)}", file=out)
            route = reference.chain_route(key)
            if route != "panel":
                print(f"  no plan to tune: chain.cu's first design "
                      f"({route}) has one 16-row block", file=out)
                continue
            plan = reference.warm_plan(key)
            heur = {"bm": plan.rows, "cluster": plan.cluster}
            print(f"  heuristic: {heur}", file=out)
            cands = warm_candidates(key)
            if args.dry:
                for c in cands:
                    print(f"  candidate: {c}", file=out)
                continue
            bench = dataclasses.replace(key, repeats=WARM_REPEATS)
            for c in [c for c in cands if not _placeable(key, c)]:
                print(f"  {c}: no cluster of it fits the card", file=out)
                cands.remove(c)
            operands = get_operands(init_args(module, "entry", "normal", 0,
                                              device))
            rows = sweep(bench, cands, operands, args.iters, out)
            summary.append(_decide(key, heur, rows, args.min_gain, kind,
                                   out))
            continue

        for key in _gemm_keys(module):
            tag = tune.key_tag(key)
            if args.key not in tag:
                continue
            heur = reference.GemmPlan(*gemm_plan(key, force=(0, 0, 0))[:3]) \
                if kind else reference.gemm_heuristic(key, sms)
            print(f" {tag}\n  heuristic: {dict(heur._asdict())}", file=out)
            cands = gemm_candidates(key, heur)
            if args.dry:
                for c in cands:
                    print(f"  candidate: {c}", file=out)
                continue
            rows = sweep(key, cands, gemm_operands(key, device), args.iters,
                         out)
            summary.append(_decide(key, dict(heur._asdict()), rows,
                                   args.min_gain, kind, out))
    print(json.dumps({"tuned": sum(k["recorded"] for k in summary),
                      "table": tune.tuning_path(), "device_kind": kind,
                      "keys": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
