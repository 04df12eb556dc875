"""Model builders the port runs: the tpp-gen MLP/GEMM chain (`mlp.py`) and
the torch-defined GPT and encoder block imported through torch.fx
(`gpt.py`, `transformer_block.py`). Copies of the same modules of
`tpp_mlir_tpu/models/`, so both packages build the same IR;
`tests/test_torch_ir.py` holds them to the originals."""

from .mlp import MlpConfig, build_gemm, build_mlp, mlp_flops

__all__ = ["MlpConfig", "build_gemm", "build_mlp", "mlp_flops"]
