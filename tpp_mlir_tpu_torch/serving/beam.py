"""Beam-search decoding over the KV-cache engine (engine.py).

The port of `tpp_mlir_tpu/serving/beam.py`: the B·W beams ride the decode
step as one batch (B13's scalar key at B·W rows), log-probabilities
accumulate in f32, finished beams (optional `eos_id`) freeze their score and
extend only with EOS at zero cost, and the returned beam maximizes
`score / (t_effective ** length_penalty)` (GNMT length norm; 0 = plain sum
of log-probs).

The JAX loop is a `lax.scan` whose carry rebinds the cache after each
reorder (`jnp.take` along the batch axis). Here one beam step (the decode
step, the top-W selection and the reorder) is replayed from a CUDA graph
over static buffers, so the reorder gathers the parents' rows and copies
them back in place: every step reads and writes the whole cache, as the JAX
`take` does (ROADMAP queue B, "Serving modes": reorder only rows
[0, pos)).

Cache layout contract: every array leaf of the decode cache carries batch
at axis 1 — (L, B, H, S, D) KV slabs and their int8 scales alike — and
`pos` is a batch-free scalar, so beam expansion and parent reorder are one
rule over the leaves.
"""

from __future__ import annotations

import torch

from .engine import Replayed, make_decode_step, make_prefill, stack_params


def _cache_map(cache, fn):
    """Apply fn to every batched leaf (axis-1 batch); pass 'pos' through."""
    return {k: (v if k == "pos" else fn(v)) for k, v in cache.items()}


def make_beam_generate(cfg, steps: int, beams: int,
                       length_penalty: float = 0.0,
                       eos_id: int | None = None,
                       use_kernels: bool | None = None,
                       graph: bool | None = None):
    """Return `generate(params, ids, mark=None) -> (tokens, scores)`:
    tokens (B, steps) int32 — the best beam's continuation of each prompt,
    scores (B,) f32 — its length-normalized log-probability. On CUDA (or
    with graph=True) the beam step is replayed from one CUDA graph, its
    first step run eagerly and captured. `mark(phase)`, if given, is called
    at "start", after the prefill ("prefill"), after the first step and the
    capture ("capture") and at the end ("decode")."""
    if beams < 1 or steps < 1:
        raise ValueError(f"beams and steps must be positive: {beams}, "
                         f"{steps}")
    # topk(logp0, W) needs W <= vocab
    if beams > cfg.vocab:
        raise ValueError(f"beams={beams} exceeds vocab={cfg.vocab}")
    prefill = make_prefill(cfg, use_kernels)
    step = make_decode_step(cfg, use_kernels)
    W, V = beams, cfg.vocab
    NEG = -1e30

    def generate(params, ids, mark=None):
        mark = mark or (lambda phase: None)
        mark("start")
        params = stack_params(params)
        dev = ids.device
        B = ids.shape[0]
        logits, cache = prefill(params, ids)
        logp0 = torch.log_softmax(logits[:, -1].float(), -1)
        scores, tok = torch.topk(logp0, W)                  # (B, W)
        tok = tok.to(torch.int32)
        # expand the cache to B*W beams, beam-minor (b0w0, b0w1, ...)
        cache = _cache_map(cache, lambda x: x.repeat_interleave(W, dim=1))
        seqs = torch.zeros(B, W, steps, dtype=torch.int32, device=dev)
        seqs[:, :, 0] = tok
        finished = (tok == eos_id) if eos_id is not None \
            else torch.zeros(B, W, dtype=torch.bool, device=dev)
        # ended-at length (for the length norm); steps if never finished
        end_t = torch.where(finished, 1, steps)
        t = torch.ones(1, dtype=torch.int64, device=dev)
        base = torch.arange(B, device=dev)[:, None] * W
        if eos_id is not None:
            only_eos = torch.full((V,), NEG, device=dev)
            only_eos[eos_id] = 0.0
        mark("prefill")

        def body():
            logits, _ = step(params, cache, tok.reshape(B * W))
            logp = torch.log_softmax(logits.float(), -1).reshape(B, W, V)
            if eos_id is not None:
                # finished beams: only EOS continues, at zero cost
                logp = torch.where(finished[:, :, None], only_eos, logp)
            cand = (scores[:, :, None] + logp).reshape(B, W * V)
            best, idx = torch.topk(cand, W)                 # (B, W)
            parent, nxt = idx // V, (idx % V).to(torch.int32)
            flat = (base + parent).reshape(-1)
            for key, arr in cache.items():
                if key != "pos":
                    arr.copy_(arr.index_select(1, flat))
            seqs.copy_(seqs.gather(1, parent[:, :, None].expand(B, W,
                                                                steps)))
            seqs.index_copy_(2, t, nxt[:, :, None])
            fin = finished.gather(1, parent)
            end = end_t.gather(1, parent)
            if eos_id is not None:
                just = (nxt == eos_id) & ~fin
                end = torch.where(just, t + 1, end)
                fin = fin | just
            finished.copy_(fin)
            end_t.copy_(end)
            scores.copy_(best)
            tok.copy_(nxt)
            t.add_(1)

        run = Replayed(body, graph, dev)
        if steps > 1:
            run()               # the first step, eager (and captured)
        mark("capture")
        for _ in range(steps - 2):
            run()
        mark("decode")
        norm = end_t.clamp(min=1).float() ** length_penalty
        final = scores / norm
        best = final.argmax(1)                              # (B,)
        out = seqs[torch.arange(B, device=dev), best]       # (B, steps)
        return out, final.gather(1, best[:, None])[:, 0]

    return generate
