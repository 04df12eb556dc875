"""Kernel keys, wrappers, plain versions and the kernel cache."""

from .cache import (KernelCache, brgemm_dispatch, fused_brgemm_dispatch,
                    gemm_dispatch, global_cache)
from .flags import (BatchMatmulKey, BinaryKey, BlockedMatmulKey, BrgemmKey,
                    ChainKey, ConvBrgemmKey, ConvNhwcKey, DecodeAttnKey,
                    FlashMhaKey, FlashTrainBwdKey, FlashTrainKey,
                    GroupedGemmKey, GroupedWgradKey, Int8GemmKey,
                    LayerNormKey, UnaryKey)
from .kernels import (Kernel, blocked_warm_fits_smem, build_kernel,
                      chain_fits_smem)
from .reference import reference_kernel

__all__ = [
    "BatchMatmulKey", "BinaryKey", "BlockedMatmulKey", "BrgemmKey", "ChainKey", "ConvBrgemmKey",
    "ConvNhwcKey", "DecodeAttnKey", "FlashMhaKey",
    "FlashTrainBwdKey", "FlashTrainKey", "GroupedGemmKey", "GroupedWgradKey",
    "Int8GemmKey", "LayerNormKey",
    "UnaryKey", "Kernel", "KernelCache", "blocked_warm_fits_smem",
    "brgemm_dispatch", "build_kernel", "chain_fits_smem",
    "fused_brgemm_dispatch", "gemm_dispatch", "global_cache",
    "reference_kernel",
]
