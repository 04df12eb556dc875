"""Torch-defined Vision Transformer block, imported through torch.fx —
the third imported model family (conv + attention in ONE program):
strided-conv patch embedding, learned positional table, pre-LN
transformer encoder, mean-pooled linear classifier head.

Exercises the importer's shape-plumbing methods (flatten / transpose
between the conv patch grid and the token sequence) and the pipeline's
conv + attention + GEMM fusion in a single region — the reference's
torch-dynamo benchmark role (its benchmarks/config/pytorch/
torch_dynamo.json) extended to the vision family. A copy of
`tpp_mlir_tpu/models/vit.py`.
"""

from __future__ import annotations


def build_vit_block(batch: int = 8, image: int = 32, patch: int = 4,
                    channels: int = 3, embed: int = 256, heads: int = 4,
                    mlp_ratio: int = 4, layers: int = 1,
                    classes: int = 0, seed: int = 0, dtype: str = "f32"):
    """ViT-class model -> tensor-IR module. classes=0 returns the
    encoder output (B, N, E); classes>0 adds mean-pool + linear head.
    heads must divide embed; patch must divide image."""
    import torch
    import torch.nn as nn

    from ..frontend import import_torch_fx

    assert image % patch == 0 and embed % heads == 0
    n_tok = (image // patch) ** 2

    class ViT(nn.Module):
        def __init__(self):
            super().__init__()
            self.patch = nn.Conv2d(channels, embed, kernel_size=patch,
                                   stride=patch)
            self.register_buffer(
                "pos", torch.randn(1, n_tok, embed) * 0.02)
            enc = nn.TransformerEncoderLayer(
                embed, heads, mlp_ratio * embed, batch_first=True,
                activation="gelu", norm_first=True, dropout=0.0)
            self.encoder = nn.TransformerEncoder(enc, num_layers=layers)
            # flatten-all-tokens head (supported-op form: token
            # selection/mean-pool are fx call_methods the importer
            # doesn't model; the flattened linear reads every token)
            self.head = nn.Linear(n_tok * embed, classes) \
                if classes else None

        def forward(self, x):
            x = self.patch(x)                 # (B, E, H', W')
            x = x.flatten(2).transpose(1, 2)  # (B, N, E)
            x = x + self.pos
            x = self.encoder(x)
            if self.head is not None:
                x = self.head(x.flatten(1))   # (B, classes)
            return x

    torch.manual_seed(seed)
    model = ViT().eval()
    m = import_torch_fx(model, (batch, channels, image, image),
                        dtype=dtype, name="entry")
    return m, model
