"""Model builders the port runs: the tpp-gen MLP/GEMM chain (`mlp.py`), the
MHA benchmark pieces (`mha.py`), the conv suite's nets (`convnet.py`) and
the torch-defined GPT, encoder block, ResNet block and ViT imported through
torch.fx (`gpt.py`, `transformer_block.py`, `resnet_block.py`, `vit.py`).
Copies of the same modules of `tpp_mlir_tpu/models/`, so both packages
build the same IR; `tests/test_torch_ir.py` holds them to the originals."""

from .convnet import ConvConfig, build_convnet, conv_flops
from .mha import (build_mha, build_mha_block, build_projection, build_qk,
                  build_softmax_v)
from .mlp import MlpConfig, build_gemm, build_mlp, mlp_flops

__all__ = ["ConvConfig", "MlpConfig", "build_convnet", "build_gemm",
           "build_mha", "build_mha_block", "build_mlp", "build_projection", "build_qk", "build_softmax_v",
           "conv_flops", "mlp_flops"]
