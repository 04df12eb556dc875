"""The device target: what the kernels and passes may assume of the card.

Counterpart of `tpp_mlir_tpu/utils/target.py:94 current_target`. On a CUDA
device every number is read from `torch.cuda.get_device_properties`; the
"cpu" target (CPU tests) carries no device numbers, only the sm_90 shared
memory a block may opt into, which the pipeline's chain gate plans for
because the port's kernels are built for sm_90a alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..xsmm.kernels import SM90_SMEM_OPTIN


@dataclass(frozen=True)
class TargetInfo:
    name: str                      # device name, or "cpu"
    device: str                    # torch device string
    sm_count: int = 0              # streaming multiprocessors (0 on cpu)
    smem_per_block_optin: int = SM90_SMEM_OPTIN
    l2_bytes: int = 0
    capability: tuple[int, int] = (0, 0)


# the reference's minimum (sublane, lane) tile per dtype
# (tpp_mlir_tpu/utils/target.py:35-38): packed parity mode's tile rule
# (passes/pack.py default_tiles, pack-conv2d) keeps it so that the packed IR
# is the JAX package's. It is a layout, not the Hopper kernels' blocking.
PACK_SUBLANES = {"f32": 8, "bf16": 16, "f16": 16, "i8": 32, "i32": 8}
PACK_LANES = 128


def pack_min_tile(dtype: str) -> tuple[int, int]:
    return PACK_SUBLANES.get(dtype, 8), PACK_LANES


def resolve_device(device: str | torch.device) -> torch.device:
    """`device` as a torch.device; a CUDA device when torch finds no card
    raises. Every entry point of the port defaults to "cuda" and goes
    through this rule: nothing falls back to the CPU, which a caller asks
    for by name (device="cpu", as the CPU tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}, but torch finds no CUDA device; "
                           f"the port does not fall back to the CPU (pass "
                           f"device='cpu' or --device cpu to run the plain "
                           f"versions)")
    return dev


def current_target(device: str | torch.device = "cuda") -> TargetInfo:
    dev = torch.device(device)
    if dev.type == "cpu":
        return TargetInfo(name="cpu", device="cpu")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for target {dev}")
    p = torch.cuda.get_device_properties(dev)
    return TargetInfo(
        name=p.name, device=str(dev), sm_count=p.multi_processor_count,
        smem_per_block_optin=getattr(p, "shared_memory_per_block_optin",
                                     SM90_SMEM_OPTIN),
        l2_bytes=getattr(p, "L2_cache_size", 0),
        capability=(p.major, p.minor))
