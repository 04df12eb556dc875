"""Kernel keys, wrappers, plain versions and the kernel cache."""

from .cache import KernelCache, global_cache
from .flags import (BatchMatmulKey, BinaryKey, BrgemmKey, ChainKey,
                    DecodeAttnKey, FlashMhaKey, FlashTrainBwdKey,
                    FlashTrainKey, GroupedGemmKey, GroupedWgradKey,
                    Int8GemmKey, LayerNormKey, UnaryKey)
from .kernels import Kernel, build_kernel, chain_fits_smem
from .reference import reference_kernel

__all__ = [
    "BatchMatmulKey", "BinaryKey", "BrgemmKey", "ChainKey", "DecodeAttnKey", "FlashMhaKey",
    "FlashTrainBwdKey", "FlashTrainKey", "GroupedGemmKey", "GroupedWgradKey",
    "Int8GemmKey", "LayerNormKey",
    "UnaryKey", "Kernel", "KernelCache",
    "build_kernel", "chain_fits_smem", "global_cache", "reference_kernel",
]
