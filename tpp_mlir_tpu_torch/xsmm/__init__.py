"""Kernel keys, wrappers, plain versions and the kernel cache."""

from .cache import KernelCache, global_cache
from .flags import (BinaryKey, BrgemmKey, ChainKey, DecodeAttnKey,
                    FlashMhaKey, FlashTrainBwdKey, FlashTrainKey, Int8GemmKey,
                    LayerNormKey, UnaryKey)
from .kernels import Kernel, build_kernel, chain_fits_smem
from .reference import reference_kernel

__all__ = [
    "BinaryKey", "BrgemmKey", "ChainKey", "DecodeAttnKey", "FlashMhaKey",
    "FlashTrainBwdKey", "FlashTrainKey", "Int8GemmKey", "LayerNormKey",
    "UnaryKey", "Kernel", "KernelCache",
    "build_kernel", "chain_fits_smem", "global_cache", "reference_kernel",
]
