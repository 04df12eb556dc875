"""GPT-2-class causal language model, torch-defined and imported through
torch.fx — the full-model decoder family: token + learned positional
embeddings, N pre-LN causal blocks, final LayerNorm, LM head.

Extends the torch-dynamo benchmark role (reference
benchmarks/config/pytorch/torch_dynamo.json, which stops at MLP/GEMM
bodies) to an end-to-end language model: the embedding gather stays
tl-level (XLA dynamic-slice machinery), every block lowers to the fused
attention + GEMM kernel family, and the LM head is a plain fc GEMM the
fuse-ln-gemm pass can absorb the final LayerNorm into.

Defaults are GPT-2 small (E=768, H=12 -> D=64, L=12) with the vocab padded
to 50304 = 128*393 so the LM-head GEMM's N dim is lane-aligned (the
standard GPT-2 padding trick; 50257 would leave a ragged 81-lane tail).
"""

from __future__ import annotations


def build_gpt(batch: int = 4, seq: int = 256, vocab: int = 50304,
              embed: int = 768, heads: int = 12, layers: int = 12,
              mlp_ratio: int = 4, seed: int = 0, dtype: str = "f32"):
    """Build the torch model and import it; returns the tensor-IR Module.

    Entry signature: (ids (batch, seq) i32) -> (batch, seq, vocab) logits.
    """
    import torch
    import torch.nn as nn

    from ..frontend import import_torch_fx

    torch.manual_seed(seed)
    model = GptTorch(vocab, embed, heads, layers, mlp_ratio,
                     max_seq=seq).eval()
    return import_torch_fx(model, (batch, seq), dtype=dtype,
                           input_dtype="i32")


class GptTorch:
    """Lazy factory so `import torch` stays inside build_gpt — replaced by
    the real nn.Module class on first construction."""

    def __new__(cls, *a, **kw):
        import torch.nn as nn

        class Block(nn.Module):
            """Pre-LN causal decoder block (GPT-2 layout).

            torch treats bare `is_causal=True` as a HINT and silently runs
            non-causal when attn_mask is None (verified on torch 2.13) —
            so the mask is passed explicitly for honest torch-side
            semantics; on import the mask kwarg is subsumed by the
            attention op's `causal` attr and never materializes."""

            def __init__(self, embed, heads, mlp_ratio, max_seq):
                super().__init__()
                import torch

                self.ln1 = nn.LayerNorm(embed)
                self.attn = nn.MultiheadAttention(embed, heads,
                                                  batch_first=True)
                self.register_buffer(
                    "mask", torch.triu(
                        torch.ones(max_seq, max_seq, dtype=torch.bool), 1),
                    persistent=False)
                self.ln2 = nn.LayerNorm(embed)
                self.fc1 = nn.Linear(embed, mlp_ratio * embed)
                self.act = nn.GELU()
                self.fc2 = nn.Linear(mlp_ratio * embed, embed)

            def forward(self, x):
                h = self.ln1(x)
                a, _ = self.attn(h, h, h, need_weights=False,
                                 attn_mask=self.mask, is_causal=True)
                x = x + a
                h = self.ln2(x)
                return x + self.fc2(self.act(self.fc1(h)))

        class Gpt(nn.Module):
            def __init__(self, vocab, embed, heads, layers, mlp_ratio,
                         max_seq):
                super().__init__()
                import torch

                self.wte = nn.Embedding(vocab, embed)
                # learned positional table read directly in forward
                # (an fx get_attr node -> literal constant on import)
                self.wpe = nn.Parameter(
                    torch.randn(max_seq, embed) * 0.02)
                self.blocks = nn.ModuleList(
                    Block(embed, heads, mlp_ratio, max_seq)
                    for _ in range(layers))
                self.ln_f = nn.LayerNorm(embed)
                self.lm_head = nn.Linear(embed, vocab, bias=False)

            def forward(self, ids):
                # ids must be exactly (B, max_seq): the positional table
                # and causal mask are full-length (dynamic ids.size(1)
                # slicing is not fx-traceable; the serving engine handles
                # variable-length prompts, serving/engine.py)
                x = self.wte(ids) + self.wpe
                for blk in self.blocks:
                    x = blk(x)
                return self.lm_head(self.ln_f(x))

        return Gpt(*a, **kw)
