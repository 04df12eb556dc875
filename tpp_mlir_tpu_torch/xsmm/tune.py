"""Measured launch plans: the kernel builders' tuning table.

The port's copy of `tpp_mlir_tpu/xsmm/tune.py`. `tpp-tune`
(tools/tpp_tune.py) sweeps legal plans on the card, timed from CUDA graphs,
and records winners here; the launchers read them when a Kernel is built.

What a plan is on Hopper:
  * BrgemmKey (B1/B2, csrc/brgemm.cu) and BlockedMatmulKey (B19,
    csrc/blocked_matmul.cu) run csrc/gemm_sm90.cuh's mainloop: `bm, bn`
    choose its output tile, one of its instantiations 128 x 128, 64 x 128
    or 64 x 64 (the f32-FMA body of f32 "highest" has 64 x 64 only); `bk`
    is the depth of one k slice, a multiple of the mainloop's 64-deep
    stage, so the k split is ceil(K / bk) over the whole reduction K
    (batch x k, or Kb x kb), and bk >= K means no split. A table entry
    names the split directly: {"bm", "bn", "split"}.
  * ChainKey (B3/B4/B5, csrc/chain.cu) and B20 (a BlockedMatmulKey with
    repeats) run csrc/warm_panel.cuh: `bm` chooses the panel rows, one of
    reference.WARM_ROWS, and `cluster` the blocks that share a panel.
    B19 and B20 share a tag (repeats is not part of it): an entry with a
    `cluster` is a warm-panel plan and binds B20 only; one without binds
    B19 only.

Lookup order inside the builders (reference.plan_request,
reference.warm_request):
  1. the key's own fields (tpp-run's --register-blocking sets them): they
     always win;
  2. the in-memory trial overlay (set by the tuner while sweeping);
  3. tuning.json, an entry recorded on this card (`device_kind` equal to
     torch.cuda.get_device_name(): a plan measured on another card, or a
     TPU block size, never binds);
  4. the launcher's heuristic (gemm_sm90.cuh gemm_plan, reference.warm_plan).

The table is `tpp_mlir_tpu_torch/utils/tuning.json` (TPP_TUNING_PATH
overrides it), loaded once a process; re-run `tpp-tune` and restart to
pick up new entries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os

#: key fields that never affect which plan is best: the timed-region repeat
#: count and the plan overrides themselves
_NON_IDENTITY_FIELDS = ("repeats", "bm", "bn", "bk", "pingpong")

#: in-memory overlay used by tune trials (tag -> cfg dict)
_OVERLAY: dict = {}


def key_tag(key) -> str:
    """Stable identity of a kernel key for the tuning table: class name +
    every dataclass field except repeat counts and plan overrides (the same
    text as the JAX package's key_tag for the same key)."""
    d = dataclasses.asdict(key)
    items = sorted((k, v) for k, v in d.items()
                   if k not in _NON_IDENTITY_FIELDS)
    body = ",".join(f"{k}={v}" for k, v in items)
    return f"{type(key).__name__}({body})"


def tuning_path() -> str:
    return os.environ.get(
        "TPP_TUNING_PATH",
        os.path.join(os.path.dirname(__file__), "..", "utils",
                     "tuning.json"))


@functools.lru_cache(maxsize=1)
def _load_file() -> dict:
    try:
        with open(tuning_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data.get("entries", {})


def device_kind() -> str | None:
    """The name of the current card, which an entry must carry to bind;
    None without one (then no entry binds)."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def tuned(key) -> dict:
    """Measured plan override for this key: the trial overlay first, then
    the table's entry if it was recorded on the current card. Returns {}
    when untuned (the heuristic applies)."""
    tag = key_tag(key)
    if tag in _OVERLAY:
        return dict(_OVERLAY[tag])
    entry = _load_file().get(tag)
    if not entry or entry.get("device_kind") != device_kind():
        return {}
    return dict(entry.get("cfg", {}))


@contextlib.contextmanager
def trial(key, cfg: dict):
    """Build with `cfg` forced for `key` (the tuner's sweep mechanism).
    Kernels built inside the context (build_kernel, not the cache's
    dispatch, which returns the kernel it built first) take cfg as if it
    were in the table."""
    tag = key_tag(key)
    prev = _OVERLAY.get(tag)
    _OVERLAY[tag] = dict(cfg)
    try:
        yield
    finally:
        if prev is None:
            _OVERLAY.pop(tag, None)
        else:
            _OVERLAY[tag] = prev


def record(key, cfg: dict, ms: float, heuristic_ms: float, device_kind: str,
           sweep: list | None = None) -> str:
    """Persist a measured winner for `key` (and refresh the process cache),
    with the sweep that chose it. Times are milliseconds from a CUDA graph
    (the JAX table keeps GFLOP/s from its scan-slope timing)."""
    path = os.path.abspath(tuning_path())
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {"entries": {}}
    tag = key_tag(key)
    data.setdefault("entries", {})[tag] = {
        "cfg": cfg,
        "ms": ms,
        "heuristic_ms": heuristic_ms,
        "device_kind": device_kind,
        "sweep": sweep or [],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    _load_file.cache_clear()
    return tag
