"""Continuous batching over the serving engine: slot-based, static shapes.

The port of `tpp_mlir_tpu/serving/batching.py`. The decode batch is a fixed
array of B slots, each owning one row of the KV cache and its own position
(`cache["pos"]` is (B,)); a free slot parks at the sentinel pos >= max_seq,
whose K/V writes leave the cache as it was (`engine._write`) and whose
decode attention (B13's slotted key) reads every row and is discarded.
Requests are prefilled at a bucket length (B7) and admitted into free slots;
every decode step advances all slots together.

Two schedulers, as in the JAX package:

- `BatchingEngine` (host): admission on the host between rounds (a batch-1
  prefill, `make_insert`, the first token sampled), then `sync_steps`
  decode steps with no host read (`make_decode_loop`): one CUDA graph of
  the steps and the sampling, captured once per engine, writes a static
  (sync_steps, slots) token buffer that is copied to the host once a round.
- `DeviceBatchingEngine` (device): requests are prefilled in batched bucket
  groups into a staging buffer (`make_stage_prefill`), and each macro call
  (`make_device_loop`) runs `sync_steps` iterations of retire, admit at most
  one staged request, decode every slot and scatter the live tokens into a
  per-request output buffer, all on the device, replayed from one CUDA
  graph. The JAX macro is a `lax.while_loop` that exits once nothing is live
  and the wave is drained; a graph has no early exit, so the port runs the
  fixed count: an iteration with nothing live and nothing staged changes
  only the trash row of the output buffer and the free slots' positions,
  so the tokens are the same. Admission is a `torch.where` over one slot's
  slab (the staged row's or the slot's own values, by a device flag), so
  the cache is bit-unchanged when nothing is admitted; it moves three slabs
  an iteration (GPT-2 small at max_seq 1024, bf16: 113 MB). The host reads
  `nxt_l` and `live_n` once a macro, in one copy.

Sampling draws its uniform numbers for a whole round (or macro) from the
engine's torch.Generator before the replay (`make_sampler`'s `noise`), so a
seed gives the same tokens eagerly and from the graph; they differ from the
JAX package's jax.random stream.

With a tp mesh (`make_decode_loop(mesh=...)`, `BatchingEngine(tp_mesh=...)`)
the decode is `engine.make_tp_decode_step` on this rank's shards: the
engine keeps the full params for the prefill, which is unsharded as in the
JAX engine, and decodes on its shards of the params and of the slotted
cache (`decode_param_specs`, `decode_cache_specs`), each prefill's cache
split before it is inserted. Every rank of the mesh runs the same schedule
and samples the same tokens (the logits are replicated). A gloo group
cannot be captured in a CUDA graph, so `graph` defaults off there.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.target import resolve_device
from .engine import (GptConfig, Replayed, _empty_cache, decode_cache_specs,
                     decode_param_specs, make_decode_step, make_prefill,
                     make_sampler, make_tp_decode_step, params_device,
                     stack_params)
from .quant import QTensor

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def _tp(mesh, tp_axis: str):
    """(Mesh, its tp group) of a tp mesh argument."""
    from ..parallel.mesh import as_mesh
    mesh = as_mesh(mesh)
    return mesh, mesh.group(tp_axis)


def tp_graph_default(group, device) -> bool:
    """Whether a tp decode is replayed from a CUDA graph by default: on
    CUDA, unless its group is gloo (a gloo collective runs on the host and
    cannot be captured)."""
    from ..parallel.collectives import staged
    return torch.device(device).type == "cuda" and not staged(group)


def init_slot_cache(cfg: GptConfig, slots: int, device="cuda") -> dict:
    """Empty slotted decode cache: zero KV (the engine's layouts), every
    slot parked at the free sentinel ``pos == max_seq``."""
    device = resolve_device(device)
    cache = _empty_cache(cfg, slots, device)
    cache["pos"] = torch.full((slots,), cfg.max_seq, dtype=torch.int32,
                              device=device)
    return cache


def _park(cache: dict, cfg: GptConfig) -> None:
    """Zero a slotted cache in place and park every slot (a reset that
    keeps the buffers a captured graph reads)."""
    for key, arr in cache.items():
        if key == "pos":
            arr.fill_(cfg.max_seq)
        else:
            arr.zero_()


def make_insert(cfg: GptConfig):
    """Return ``insert(cache, pcache, slot, true_len) -> cache``: copy a
    batch-1 prefill cache into slot ``slot`` of a slotted decode cache and
    set that slot's position to ``true_len`` (the un-padded prompt length:
    rows past it, the bucket padding, are masked off by the position). In
    place."""

    def insert(cache, pcache, slot, true_len):
        for key, arr in cache.items():
            if key != "pos":
                arr[:, slot].copy_(pcache[key][:, 0])
        cache["pos"][slot] = true_len
        return cache

    return insert


def make_decode_loop(cfg: GptConfig, sync_steps: int,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 0.0, mesh=None, tp_axis: str = "tp",
                     use_kernels: bool | None = None,
                     graph: bool | None = None):
    """Return ``loop(params, cache, tok, generator=None) -> (toks
    (sync_steps, B), cache, tok)``: ``sync_steps`` decode steps sampling on
    the device, the cache and ``tok`` (B,) updated in place. On CUDA (or
    with graph=True) the steps are one CUDA graph per set of buffers,
    captured at its first call; ``toks`` is a static buffer, so a caller
    copies it to the host once a round. With ``mesh`` the step is the
    tensor-parallel decode over its ``tp_axis`` on this rank's shards of
    the params and cache (laid out by ``decode_param_specs`` and
    ``decode_cache_specs``); ``graph`` then defaults off for a gloo group."""
    if mesh is None:
        step = make_decode_step(cfg, use_kernels)
    else:
        mesh, group = _tp(mesh, tp_axis)
        step = make_tp_decode_step(mesh, cfg, tp_axis, use_kernels)
    sample = make_sampler(temperature, top_k, top_p)
    runs = {}

    def loop(params, cache, tok, generator=None):
        key = (id(params), tok.data_ptr(),
               *(t.data_ptr() for t in cache.values()))
        if key not in runs:
            B = tok.shape[0]
            toks = torch.zeros(sync_steps, B, dtype=torch.int32,
                               device=tok.device)
            noise = None if temperature == 0.0 else torch.empty(
                sync_steps, B, cfg.vocab, device=tok.device)

            def body():
                for i in range(sync_steps):
                    logits, _ = step(params, cache, tok)
                    nxt = sample(logits, noise=None if noise is None
                                 else noise[i])
                    toks[i].copy_(nxt)
                    tok.copy_(nxt)
            g = graph
            if g is None and mesh is not None:
                g = tp_graph_default(group, tok.device)
            runs[key] = (Replayed(body, g, tok.device), toks, noise)
        run, toks, noise = runs[key]
        if noise is not None:
            noise.uniform_(generator=generator)
        run()
        return toks, cache, tok

    return loop


@dataclass
class Request:
    rid: int
    prompt: object                      # np.ndarray (S0,) int32
    max_new: int
    tokens: list = field(default_factory=list)
    done: bool = False


def _buckets(buckets, cfg: GptConfig) -> tuple:
    out = tuple(b for b in sorted(buckets) if b <= cfg.max_seq)
    if not out:
        raise ValueError("no bucket fits max_seq")
    return out


def _prompt(ids, buckets) -> np.ndarray:
    ids = np.asarray(ids, np.int32).reshape(-1)
    if ids.size == 0 or ids.size > buckets[-1]:
        raise ValueError(f"prompt length {ids.size} outside "
                         f"(0, {buckets[-1]}]")
    return ids


class BatchingEngine:
    """Host-side continuous-batching scheduler over the slotted decode
    step. Greedy by default; set temperature/top_k/top_p for sampling.

    ``submit()`` enqueues prompts; ``step()`` runs one scheduling round
    (admit into free slots, then ``sync_steps`` decode steps on the
    device); ``run()`` drives rounds until every submitted request finished
    and returns {rid: token list}. Generation stops at ``eos_id`` (if set),
    ``max_new`` tokens, or a full cache (max_seq), whichever is first.
    ``tp_mesh`` decodes tensor-parallel over its ``tp_axis`` (the module
    docstring). ``graph`` (default: on CUDA, off for a gloo tp group)
    replays the decode loop from a CUDA graph.
    """

    def __init__(self, params, cfg: GptConfig, slots: int = 4,
                 sync_steps: int = 4, eos_id: int | None = None,
                 buckets=DEFAULT_BUCKETS, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 tp_mesh=None, tp_axis: str = "tp",
                 use_kernels: bool | None = None,
                 graph: bool | None = None):
        if slots < 1 or sync_steps < 1:
            raise ValueError(f"slots and sync_steps must be positive: "
                             f"{slots}, {sync_steps}")
        if tp_mesh is not None:
            tp_mesh, _ = _tp(tp_mesh, tp_axis)
        self.cfg, self.slots, self.sync_steps = cfg, slots, sync_steps
        self.eos_id = eos_id
        self.buckets = _buckets(buckets, cfg)
        self.params = stack_params(params)
        dev = params_device(self.params)
        self._prefill = make_prefill(cfg, use_kernels)
        self._insert = make_insert(cfg)
        quantized = any(isinstance(v, QTensor) for blk in
                        self.params["blocks"] for v in blk.values())
        self._loop = make_decode_loop(cfg, sync_steps, temperature, top_k,
                                      top_p, mesh=tp_mesh, tp_axis=tp_axis,
                                      use_kernels=use_kernels, graph=graph)
        self._sample = make_sampler(temperature, top_k, top_p)
        self.cache = init_slot_cache(cfg, slots, dev)
        self._dparams, self._shard = self.params, lambda c: c
        if tp_mesh is not None:
            from ..parallel.mesh import shard_tree
            self._dparams = shard_tree(self.params, decode_param_specs(
                cfg, tp_axis, quantized), tp_mesh)
            cspecs = decode_cache_specs(cfg, tp_axis)
            self._shard = lambda c: shard_tree(c, cspecs, tp_mesh)
            self.cache = self._shard(self.cache)
        self.tok = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._seed = seed
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self.slot_req: list[Request | None] = [None] * slots
        self.queue: deque[Request] = deque()
        self.finished: dict[int, list[int]] = {}
        self._next_rid = 0

    # -- client API -------------------------------------------------------
    def reset(self) -> None:
        """Clear all scheduling state (cache, slots, queue, results) in
        place, keeping the buffers the captured decode loop reads — e.g. to
        replay a trace warm."""
        _park(self.cache, self.cfg)
        self.tok.zero_()
        self._gen.manual_seed(self._seed)
        self.slot_req = [None] * self.slots
        self.queue.clear()
        self.finished = {}
        self._next_rid = 0

    def submit(self, ids, max_new: int = 32) -> int:
        """Enqueue a prompt (1-D int sequence). Returns the request id."""
        ids = _prompt(ids, self.buckets)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, ids, max_new))
        return rid

    def run(self) -> dict[int, list[int]]:
        """Drive rounds until all submitted requests finish."""
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
        return self.finished

    # -- one scheduling round ----------------------------------------------
    def step(self) -> None:
        self._admit()
        if all(r is None for r in self.slot_req):
            return
        toks, _, _ = self._loop(self._dparams, self.cache, self.tok,
                                self._gen)
        toks = toks.cpu().numpy()           # (sync_steps, B): one copy
        for b, req in enumerate(self.slot_req):
            if req is None:
                continue
            for t in toks[:, b]:
                req.tokens.append(int(t))
                if self._exhausted(req):
                    break
            if req.done:
                self._retire(b, req)

    # -- internals ---------------------------------------------------------
    def _exhausted(self, req: Request) -> bool:
        t = req.tokens[-1]
        cap = self.cfg.max_seq - len(req.prompt)
        if (self.eos_id is not None and t == self.eos_id) \
                or len(req.tokens) >= min(req.max_new, cap):
            req.done = True
        return req.done

    def _retire(self, slot: int, req: Request) -> None:
        self.finished[req.rid] = req.tokens[:]
        self.slot_req[slot] = None
        # park the slot: the sentinel position leaves its KV as it is
        self.cache["pos"][slot] = self.cfg.max_seq

    def _admit(self) -> None:
        dev = self.tok.device
        for slot in range(self.slots):
            if not self.queue or self.slot_req[slot] is not None:
                continue
            req = self.queue.popleft()
            n = len(req.prompt)
            bucket = next(b for b in self.buckets if b >= n)
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :n] = req.prompt
            logits, pcache = self._prefill(self.params,
                                           torch.from_numpy(ids).to(dev))
            first = self._sample(logits[:, n - 1], self._gen)   # (1,)
            self._insert(self.cache, self._shard(pcache), slot, n)
            self.tok[slot:slot + 1].copy_(first)
            req.tokens.append(int(first[0]))
            self.slot_req[slot] = req
            if self._exhausted(req):
                self._retire(slot, req)


# ---------------------------------------------------------------------------
# Device-side admission: retire + admit + decode in one replayed macro.


def init_staging(cfg: GptConfig, rows: int, device="cuda") -> dict:
    """Staging buffer: `rows` per-request KV slabs, the slotted cache's key
    layout minus "pos" (axis 1 = staging row instead of slot)."""
    cache = init_slot_cache(cfg, rows, device)
    del cache["pos"]
    return cache


def make_stage_prefill(cfg: GptConfig, temperature: float = 0.0,
                       top_k: int = 0, top_p: float = 0.0,
                       use_kernels: bool | None = None):
    """Return ``stage(params, ids, lens, staging, offset, generator=None)
    -> (staging, firsts)``: batched prefill of one bucket group (B7), its
    per-request KV slabs written into staging rows [offset, offset + rows)
    in place, and each request's first token sampled from its true last
    row's logits. Rows of a padded group write slabs that the wave layout
    overwrites or never admits."""
    prefill = make_prefill(cfg, use_kernels)
    sample = make_sampler(temperature, top_k, top_p)

    def stage(params, ids, lens, staging, offset, generator=None):
        logits, pcache = prefill(params, ids)
        G = ids.shape[0]
        rows = logits[torch.arange(G, device=ids.device), lens.long() - 1]
        firsts = sample(rows, generator)
        for key, arr in staging.items():
            arr[:, offset:offset + G].copy_(pcache[key])
        return staging, firsts

    return stage


def make_device_loop(cfg: GptConfig, sync_steps: int,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 0.0, eos_id: int | None = None,
                     use_kernels: bool | None = None,
                     graph: bool | None = None):
    """Return the device-scheduler macro step:

    ``macro(params, cache, tok, generator, rid, left, out, olen, nxt_l,
    staging, wlen, wnew, wfirst, wrid, wcount) -> (cache, tok, rid, left,
    out, olen, nxt_l, live_n)``

    ``sync_steps`` iterations, each: retire slots whose budget hit 0 (rid
    -> the trash sentinel R = out.shape[0] - 1, pos -> max_seq), admit at
    most one staged request into the first free slot (its slab, pos, first
    token, rid and budget, by a device flag: no host read), decode every
    slot one step, scatter live tokens into ``out[rid, olen[rid]]``. Every
    argument but params, generator and staging's contents is updated in
    place; ``nxt_l`` (the next staging row) is a 0-d device tensor and
    ``live_n`` a 0-d device tensor of live slots after the macro. On CUDA
    (or with graph=True) the macro is one CUDA graph per set of buffers."""
    step = make_decode_step(cfg, use_kernels)
    sample = make_sampler(temperature, top_k, top_p)
    S = cfg.max_seq
    runs = {}

    def iteration(params, cache, tok, noise, rid, left, out, olen, nxt_l,
                  staging, wlen, wnew, wfirst, wrid, wcount):
        R, MAXNEW, W = out.shape[0] - 1, out.shape[1], wlen.shape[0]
        pos = cache["pos"]
        # retire: exhausted slots park at the sentinel (their last token
        # was recorded on the iteration that produced it)
        done = (rid < R) & (left <= 0)
        rid.masked_fill_(done, R)
        pos.masked_fill_(done, S)
        # admit at most one staged request, into the first free slot
        free = rid == R
        can = free.any() & (nxt_l < wcount)
        slot = free.float().argmax().reshape(1)
        li = nxt_l.clamp(max=W - 1).reshape(1).long()

        def put(buf, value, dim=0):
            buf.index_copy_(dim, slot, torch.where(
                can, value, buf.index_select(dim, slot)))
        for key, arr in staging.items():
            put(cache[key], arr.index_select(1, li), dim=1)
        first = wfirst.index_select(0, li)
        put(pos, wlen.index_select(0, li))
        put(tok, first)
        put(rid, wrid.index_select(0, li))
        budget = wnew.index_select(0, li) - 1   # the first is pre-sampled
        if eos_id is not None:
            budget = torch.where(first == eos_id, 0, budget)
        put(left, budget)
        row = wrid.index_select(0, li).long()
        zero = torch.zeros_like(row)
        out.index_put_((row, zero), torch.where(can, first, out[row, zero]))
        olen.index_put_((row,), torch.where(can, 1, olen[row]))
        nxt_l.add_(can.to(nxt_l.dtype))
        # decode every slot one token
        logits, _ = step(params, cache, tok)
        nxt = sample(logits, noise=noise)
        live = (rid < R) & (left > 0)
        row = torch.where(live, rid, R).long()
        col = olen[row].clamp(0, MAXNEW - 1).long()
        out.index_put_((row, col), torch.where(live, nxt, out[row, col]))
        olen.index_put_((row,), olen[row] + live.to(olen.dtype))
        left.copy_(torch.where(live, left - 1, left))
        if eos_id is not None:
            left.masked_fill_(live & (nxt == eos_id), 0)
        tok.copy_(torch.where(live, nxt, tok))

    def macro(params, cache, tok, generator, rid, left, out, olen, nxt_l,
              staging, wlen, wnew, wfirst, wrid, wcount):
        bufs = (tok, rid, left, out, olen, nxt_l, wlen, wnew, wfirst, wrid,
                wcount, *cache.values(), *staging.values())
        key = (id(params), *((t.data_ptr(), tuple(t.shape)) for t in bufs))
        if key not in runs:
            B = tok.shape[0]
            noise = None if temperature == 0.0 else torch.empty(
                sync_steps, B, cfg.vocab, device=tok.device)
            live_n = torch.zeros((), dtype=torch.int64, device=tok.device)

            def body():
                for i in range(sync_steps):
                    iteration(params, cache, tok,
                              None if noise is None else noise[i], rid,
                              left, out, olen, nxt_l, staging, wlen, wnew,
                              wfirst, wrid, wcount)
                R = out.shape[0] - 1
                live_n.copy_(((rid < R) & (left > 0)).sum())
            runs[key] = (Replayed(body, graph, tok.device), noise, live_n)
        run, noise, live_n = runs[key]
        if noise is not None:
            noise.uniform_(generator=generator)
        run()
        return cache, tok, rid, left, out, olen, nxt_l, live_n

    return macro


class DeviceBatchingEngine:
    """Continuous batching with device-side admission (see the module
    docstring): staged batched prefill + one replayed macro that retires,
    admits and decodes. Offline/batch serving semantics — the submitted set
    is staged in waves of ``wave`` requests; an online server would stage
    arrivals the same way between macro calls.

    Same client API as BatchingEngine (submit / run / reset); greedy by
    default. max_new is capped at max_seq - len(prompt) like the host
    engine. The buffers (cache, staging, wave tables, and the output buffer
    of each run's (requests, max_new) shape) are the engine's, kept across
    runs, so a second run of the same shape replays the first's graph."""

    def __init__(self, params, cfg: GptConfig, slots: int = 8,
                 sync_steps: int = 64, wave: int = 16,
                 buckets=DEFAULT_BUCKETS, eos_id: int | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 prefill_rows: int | None = None,
                 use_kernels: bool | None = None,
                 graph: bool | None = None):
        if min(slots, sync_steps, wave) < 1:
            raise ValueError(f"slots, sync_steps and wave must be positive: "
                             f"{slots}, {sync_steps}, {wave}")
        self.cfg, self.slots, self.sync_steps = cfg, slots, sync_steps
        self.wave = wave
        self.eos_id = eos_id
        self.buckets = _buckets(buckets, cfg)
        self.prefill_rows = prefill_rows or min(slots, wave)
        self.params = stack_params(params)
        dev = params_device(self.params)
        self._stage_fn = make_stage_prefill(cfg, temperature, top_k, top_p,
                                            use_kernels)
        self._macro = make_device_loop(cfg, sync_steps, temperature, top_k,
                                       top_p, eos_id, use_kernels, graph)
        i32 = dict(dtype=torch.int32, device=dev)
        self.cache = init_slot_cache(cfg, slots, dev)
        self.staging = init_staging(cfg, wave + self.prefill_rows, dev)
        self.tok = torch.zeros(slots, **i32)
        self.rid = torch.zeros(slots, **i32)
        self.left = torch.zeros(slots, **i32)
        self.nxt_l = torch.zeros((), **i32)
        self.wlen, self.wnew, self.wfirst, self.wrid = (
            torch.zeros(wave, **i32) for _ in range(4))
        self.wcount = torch.zeros((), **i32)
        self._outs: dict[tuple, tuple] = {}
        self._seed = seed
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self.reset()

    # -- client API ---------------------------------------------------------
    def reset(self) -> None:
        self._gen.manual_seed(self._seed)
        # (row, rid, prompt, new): row indexes the run's out buffer
        # (run-local), rid is the client-visible id (unique across runs)
        self._reqs: list[tuple[int, int, object, int]] = []
        self.finished: dict[int, list[int]] = {}
        self._next_rid = 0

    def submit(self, ids, max_new: int = 32) -> int:
        ids = _prompt(ids, self.buckets)
        rid = self._next_rid
        self._next_rid += 1
        new = max(1, min(max_new, self.cfg.max_seq - ids.size))
        self._reqs.append((len(self._reqs), rid, ids, new))
        return rid

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def _stage(self, reqs, R: int) -> None:
        """Prefill one wave (sorted by bucket, batched in fixed
        prefill_rows chunks per bucket so the prefill shapes stay
        one-per-bucket) into the staging buffer and the wave tables, in
        place."""
        PG, W = self.prefill_rows, self.wave
        dev = self.tok.device
        wlen = np.zeros(W, np.int32)
        wnew = np.zeros(W, np.int32)
        wrid = np.full(W, R, np.int32)
        self.wfirst.zero_()
        reqs = sorted(reqs, key=lambda r: self._bucket(len(r[2])))
        offset = 0
        while offset < len(reqs):
            bucket = self._bucket(len(reqs[offset][2]))
            group = [r for r in reqs[offset:offset + PG]
                     if self._bucket(len(r[2])) == bucket]
            ids = np.zeros((PG, bucket), np.int32)
            lens = np.ones(PG, np.int32)
            for j, (_, _, p, _) in enumerate(group):
                ids[j, :len(p)] = p
                lens[j] = len(p)
            _, firsts = self._stage_fn(
                self.params, torch.from_numpy(ids).to(dev),
                torch.from_numpy(lens).to(dev), self.staging, offset,
                self._gen)
            self.wfirst[offset:offset + len(group)].copy_(
                firsts[:len(group)])
            for j, (row, _, p, new) in enumerate(group):
                wlen[offset + j] = len(p)
                wnew[offset + j] = new
                wrid[offset + j] = row
            offset += len(group)
        for buf, host in ((self.wlen, wlen), (self.wnew, wnew),
                          (self.wrid, wrid)):
            buf.copy_(torch.from_numpy(host))
        self.wcount.fill_(len(reqs))
        self.nxt_l.zero_()

    def run(self) -> dict[int, list[int]]:
        """Stage waves and drive macro steps until every request is done;
        returns {rid: token list} (first token included, EOS recorded)."""
        if not self._reqs:
            return self.finished
        R = len(self._reqs)
        maxnew = max(new for _, _, _, new in self._reqs)
        dev = self.tok.device
        if (R, maxnew) not in self._outs:
            self._outs[(R, maxnew)] = (
                torch.zeros(R + 1, maxnew, dtype=torch.int32, device=dev),
                torch.zeros(R + 1, dtype=torch.int32, device=dev))
        out, olen = self._outs[(R, maxnew)]
        _park(self.cache, self.cfg)
        for buf in (self.tok, self.left, out, olen):
            buf.zero_()
        self.rid.fill_(R)
        waves = [self._reqs[i:i + self.wave] for i in range(0, R, self.wave)]
        wi = 0
        self._stage(waves[0], R)
        while True:
            *_, live_n = self._macro(
                self.params, self.cache, self.tok, self._gen, self.rid,
                self.left, out, olen, self.nxt_l, self.staging, self.wlen,
                self.wnew, self.wfirst, self.wrid, self.wcount)
            # the one host read per macro
            nxt_l, live = torch.stack([self.nxt_l.long(), live_n]).tolist()
            if nxt_l >= len(waves[wi]):
                if wi + 1 < len(waves):
                    wi += 1
                    self._stage(waves[wi], R)
                elif live == 0:
                    break
        out, olen = out.cpu().numpy(), olen.cpu().numpy()
        for row, rid_, _, _ in self._reqs:
            self.finished[rid_] = out[row, :olen[row]].tolist()
        self._reqs = []
        return self.finished
