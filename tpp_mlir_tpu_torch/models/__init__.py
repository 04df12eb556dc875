"""Model builders the port runs: the tpp-gen MLP/GEMM chain (`mlp.py`), the
MHA benchmark pieces (`mha.py`) and the torch-defined GPT and encoder block
imported through torch.fx (`gpt.py`, `transformer_block.py`). Copies of
the same modules of `tpp_mlir_tpu/models/`, so both packages build the same
IR; `tests/test_torch_ir.py` holds them to the originals."""

from .mha import (build_mha, build_mha_block, build_projection, build_qk,
                  build_softmax_v)
from .mlp import MlpConfig, build_gemm, build_mlp, mlp_flops

__all__ = ["MlpConfig", "build_gemm", "build_mha", "build_mha_block",
           "build_mlp", "build_projection", "build_qk", "build_softmax_v",
           "mlp_flops"]
