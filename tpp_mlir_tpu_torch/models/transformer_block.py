"""Torch-defined transformer encoder block, imported through torch.fx —
benchmarks the frontend -> pipeline -> fused-attention + GEMM kernel path
end to end (the reference's torch-dynamo benchmark role,
benchmarks/config/pytorch/torch_dynamo.json, extended to the attention
model family)."""

from __future__ import annotations


def build_transformer_block(batch: int = 8, seq: int = 256,
                            embed: int = 1024, heads: int = 16,
                            mlp_ratio: int = 4, seed: int = 0,
                            dtype: str = "f32", layers: int = 1,
                            causal: bool = False):
    """causal=True builds the DECODER block (GPT-style causal
    self-attention via is_causal, imported through the same fx path) —
    the end-to-end context for the causal-attention kernels."""
    import torch
    import torch.nn as nn

    from ..frontend import import_torch_fx

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(embed)
            self.attn = nn.MultiheadAttention(embed, heads,
                                              batch_first=True)
            if causal:
                # torch treats bare is_causal=True as a hint and silently
                # runs NON-causal without a mask (verified, torch 2.13);
                # the explicit mask keeps torch-side semantics honest. On
                # import the mask kwarg is subsumed by the attention op's
                # causal attr and never materializes.
                self.register_buffer(
                    "mask", torch.triu(
                        torch.ones(seq, seq, dtype=torch.bool), 1),
                    persistent=False)
            self.ln2 = nn.LayerNorm(embed)
            self.fc1 = nn.Linear(embed, mlp_ratio * embed)
            self.act = nn.GELU()
            self.fc2 = nn.Linear(mlp_ratio * embed, embed)

        def forward(self, x):
            h = self.ln1(x)
            if causal:
                a, _ = self.attn(h, h, h, need_weights=False,
                                 attn_mask=self.mask, is_causal=True)
            else:
                a, _ = self.attn(h, h, h, need_weights=False)
            x = x + a
            h = self.ln2(x)
            return x + self.fc2(self.act(self.fc1(h)))

    class Encoder(nn.Module):
        """`layers` stacked blocks — the multi-layer import exercises
        residual-accumulator + LN-prologue + QKV-merge fusion ACROSS block
        boundaries (each block's output residual feeds the next block's
        LN-prologue GEMM)."""

        def __init__(self):
            super().__init__()
            self.blocks = nn.ModuleList(Block() for _ in range(layers))

        def forward(self, x):
            for blk in self.blocks:
                x = blk(x)
            return x

    torch.manual_seed(seed)
    model = (Block() if layers == 1 else Encoder()).eval()
    return import_torch_fx(model, (batch, seq, embed), dtype=dtype)
