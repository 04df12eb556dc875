"""Sequence parallelism (sp): ring attention over a mesh axis, the port of
`tpp_mlir_tpu/parallel/sequence.py`.

The sequence splits over sp: each rank holds a contiguous Q/K/V block of
its own tokens. K/V blocks rotate around the ring (`ring_shift`, one hop a
step, sp steps) and each rank folds each arriving block into its queries'
attention with an online softmax carry (running max m, normalizer l,
accumulator acc) in the exp2 domain, f32 throughout, so no rank holds the
full scores or the full K/V. Causal masking uses global positions: the
block arriving at step t on rank i is rank (i - t) mod sp's. A row fully
masked so far (early causal steps) has m = -inf, and the rescale is
guarded so it stays finite (sequence.py:70-77 there). The JAX module
computes this with einsums, and so does the port, with PyTorch ops and no
kernel. It is differentiable through `ring_shift`.
"""

from __future__ import annotations

import math

import torch

from .collectives import ring_shift
from .mesh import as_mesh

LOG2E = 1.4426950408889634


def make_ring_attention(mesh, heads: int, causal: bool = False,
                        sp_axis: str = "sp"):
    """Return `attn(q, k, v) -> out` on this rank's sequence block: q/k/v
    (batch, seq/sp, heads, head_dim); out like q. Softmax in f32 whatever
    the input dtype."""
    mesh = as_mesh(mesh)
    sp, idx, group = mesh.size(sp_axis), mesh.index(sp_axis), \
        mesh.group(sp_axis)
    del heads

    def attn(q, k, v):
        b, sq, h, d = q.shape
        qf = q.float() * (1.0 / math.sqrt(d) * LOG2E)
        q_pos = idx * sq + torch.arange(sq, device=q.device)[:, None]
        m = torch.full((b, h, sq), -math.inf, device=q.device)
        l = torch.zeros((b, h, sq), device=q.device)
        acc = torch.zeros((b, h, sq, d), device=q.device)
        kb, vb = k, v
        for t in range(sp):
            src = (idx - t) % sp              # kb holds rank src's tokens
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
            if causal:
                k_pos = src * sq + torch.arange(sq, device=q.device)[None]
                s = torch.where(q_pos >= k_pos, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            # a row masked so far keeps a finite carry
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp2(s - m_safe[..., None])
            fin = torch.isfinite(m)
            corr = torch.exp2(torch.where(fin, m - m_safe, -math.inf))
            corr = torch.where(fin, corr, 0.0)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
            if t < sp - 1:                    # the last hop is unused
                kb, vb = ring_shift(kb, group), ring_shift(vb, group)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.permute(0, 2, 1, 3).to(q.dtype)

    return attn


def ring_attention_reference(q, k, v, causal: bool = False):
    """Unsharded oracle: plain softmax attention in f32, exp2 domain."""
    b, s, h, d = q.shape
    qf = q.float() * (1.0 / math.sqrt(d) * LOG2E)
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = torch.where(keep, sc, -math.inf)
    p = torch.exp2(sc - sc.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bhqd", p / p.sum(-1, keepdim=True),
                       v.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)
