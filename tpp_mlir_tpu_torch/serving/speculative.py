"""Speculative decoding: draft-model proposal + single-pass target
verification (greedy: the emitted stream is the target's own greedy
continuation, up to the numerics of the verify pass against the decode
step; in f32 on the CPU it equals the JAX package's token for token).

The port of `tpp_mlir_tpu/serving/speculative.py`. A small draft (a
separate model, float or int8, or the target's first N blocks) proposes k
tokens with k + 1 cheap decode steps (B13 at batch 1); the target scores all
k + 1 positions in one `make_extend` pass; the longest prefix where the
draft equals the target's argmax is accepted, then the target's own token at
the first mismatch (or the bonus token when all k matched). Rejected cache
rows past the new position are not rolled back: the position masks them and
the next round overwrites them.

The JAX round is one jitted program under a `lax.while_loop`; here one round
(the k + 1 draft steps, the verify pass, the acceptance and the cursor) is
replayed from a CUDA graph over static buffers, and the host reads the
token cursor once a round to stop. The engine's steps advance `pos` in
place, so the draft cache has its own `pos` tensor (were it the target's,
the draft's k + 1 steps would advance the target's frontier) and, for the
trunk draft, its own copy of the target's first N layers, as the JAX
package's is a separate array; both positions are set to the new frontier
after each round.

Batch is B = 1: acceptance length is data-dependent per sequence, and the
cache keeps one scalar `pos`.
"""

from __future__ import annotations

import dataclasses

import torch

from .engine import (GptConfig, Replayed, make_decode_step, make_extend,
                     make_prefill, stack_params)
from .quant import QTensor


def make_speculative_generate(cfg: GptConfig, draft_cfg: GptConfig | None,
                              steps: int, k: int = 4,
                              use_kernels: bool | None = None,
                              draft_vocab: int = 0,
                              trunk_layers: int = 0,
                              graph: bool | None = None):
    """Return `generate(params, draft_params, ids) -> (tokens (1, steps),
    stats)` emitting the target's greedy continuation. `stats`
    = {"macro_steps", "drafted", "accepted"} (0-d device tensors;
    acceptance rate = accepted / drafted).

    Requires ids.shape[1] + steps + k + 1 <= cfg.max_seq (the verify pass
    writes k + 1 speculative cache rows past the frontier).

    `draft_vocab` (0 = off) truncates the draft's lm_head to its first
    `draft_vocab` columns: proposals come from that prefix, and a target
    token outside it is a mismatch the verify pass emits itself, so only
    the acceptance rate changes.

    `trunk_layers` N > 0 makes the draft the target's first N blocks with
    the target's final norm and lm_head (self-speculative): no separate
    parameters and no draft prefill (its cache starts as a copy of the
    target's layers [0, N)). Pass draft_cfg=None; the returned generate
    takes (params, ids).

    On CUDA (or with graph=True) each round is replayed from one CUDA
    graph, its first round run eagerly and captured."""
    if trunk_layers:
        if draft_cfg is not None:
            raise ValueError("trunk_layers derives the draft from the "
                             "target; do not pass a separate draft_cfg")
        if not 0 < trunk_layers <= cfg.layers:
            raise ValueError(f"trunk_layers {trunk_layers} outside "
                             f"(0, {cfg.layers}]")
        draft_cfg = dataclasses.replace(cfg, layers=trunk_layers)
    if cfg.vocab != draft_cfg.vocab:
        raise ValueError("draft must share the vocab")
    if cfg.max_seq != draft_cfg.max_seq:
        raise ValueError("draft cache must cover the same positions")
    if not 0 <= draft_vocab <= cfg.vocab:
        raise ValueError(f"draft_vocab {draft_vocab} exceeds vocab "
                         f"{cfg.vocab}")
    if k < 1 or steps < 1:
        raise ValueError(f"k and steps must be positive: {k}, {steps}")

    prefill_t = make_prefill(cfg, use_kernels)
    prefill_d = None if trunk_layers else make_prefill(draft_cfg,
                                                       use_kernels)
    draft_step = make_decode_step(draft_cfg, use_kernels)
    verify = make_extend(cfg, use_kernels)

    def generate(params, draft_params, ids):
        B, s0 = ids.shape
        if B != 1:
            raise ValueError("speculative decoding serves the B=1 latency "
                             "path")
        if s0 + steps + k + 1 > cfg.max_seq:
            raise ValueError(f"prompt {s0} + steps {steps} + k+1 {k + 1} "
                             f"exceeds max_seq {cfg.max_seq}")
        params = stack_params(params)
        if trunk_layers:
            # the draft IS the target's first N blocks + its norm and head
            draft_params = dict(params,
                                blocks=params["blocks"][:trunk_layers])
        else:
            draft_params = stack_params(draft_params)
        if draft_vocab:
            lm = draft_params["lm_head"]
            if isinstance(lm, QTensor):
                raise NotImplementedError(
                    "draft_vocab requires an unquantized draft lm_head")
            # one slice, made once: every draft step reads E x draft_vocab
            draft_params = dict(draft_params,
                                lm_head=lm[:, :draft_vocab].contiguous())
        logits, tcache = prefill_t(params, ids)
        if trunk_layers:
            # the trunk's prompt cache is the target's first N layers
            # (identical weights on identical inputs), copied: the draft
            # writes its own rows past the prompt, and its own pos
            dcache = {kk: v[:trunk_layers].clone() if v.dim() else v.clone()
                      for kk, v in tcache.items()}
        else:
            _, dcache = prefill_d(draft_params, ids)
        dev = ids.device
        tok = logits[:, -1].argmax(-1).to(torch.int32)         # (1,)
        buf = torch.zeros(steps + k + 1, dtype=torch.int32, device=dev)
        buf[:1] = tok
        cursor = torch.ones((), dtype=torch.int64, device=dev)
        macros = torch.zeros((), dtype=torch.int64, device=dev)
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        ar = torch.arange(k + 1, device=dev)

        def body():
            pos0 = tcache["pos"].clone()
            # k + 1 draft steps, not k: the last proposal must itself be
            # fed through a draft step so its KV row (position pos + k) is
            # written for a fully accepted round; its own proposal is unused
            t, drafts = tok, []
            for _ in range(k + 1):
                dl, _ = draft_step(draft_params, dcache, t)
                t = dl.argmax(-1).to(torch.int32)
                drafts.append(t)
            d = torch.cat(drafts[:k])                           # (k,)
            vl, _ = verify(params, tcache, torch.cat([tok, d])[None])
            tt = vl[0].argmax(-1).to(torch.int32)               # (k+1,)
            # the longest prefix where the draft equals the target's argmax
            n = torch.cumprod((d == tt[:k]).to(torch.int64), 0).sum()
            # drafts[:n], then the target's token at the first mismatch (or
            # the bonus token when all k were accepted)
            emit = torch.where(ar < n, torch.cat([d, d[-1:]]), tt)
            count = n + 1
            tcache["pos"].copy_(pos0 + count)
            dcache["pos"].copy_(pos0 + count)
            buf.index_copy_(0, cursor + ar, emit)
            tok.copy_(emit.index_select(0, (count - 1).reshape(1)))
            cursor.add_(count)
            macros.add_(1)
            accepted.add_(count - 1)

        run = Replayed(body, graph, dev)
        while int(cursor) < steps:      # the one host read a round
            run()
        stats = {"macro_steps": macros, "drafted": macros * k,
                 "accepted": accepted}
        return buf[None, :steps], stats

    if trunk_layers:
        return lambda params, ids: generate(params, None, ids)
    return generate
