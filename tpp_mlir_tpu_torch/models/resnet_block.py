"""Torch-defined residual block, imported through torch.fx — benchmarks the
frontend -> pipeline -> conv-BRGEMM kernel path end to end (the reference's
torch-dynamo benchmark role, benchmarks/config/pytorch/torch_dynamo.json)."""

from __future__ import annotations


def build_resnet_block(batch: int = 8, channels: int = 128, hw: int = 16,
                       seed: int = 0, dtype: str = "f32"):
    import torch

    from ..frontend import import_torch_fx

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = torch.nn.Conv2d(channels, channels, 3, padding=1)
            self.bn1 = torch.nn.BatchNorm2d(channels)
            self.c2 = torch.nn.Conv2d(channels, channels, 3, padding=1)
            self.bn2 = torch.nn.BatchNorm2d(channels)

        def forward(self, x):
            y = torch.relu(self.bn1(self.c1(x)))
            y = self.bn2(self.c2(y))
            return torch.relu(y + x)

    torch.manual_seed(seed)
    model = Block().eval()
    return import_torch_fx(model, (batch, channels, hw, hw), dtype=dtype)
