"""Dispatch/invoke kernel cache, keyed by the frozen kernel keys.

The counterpart of `tpp_mlir_tpu/xsmm/cache.py`: `dispatch(key)` builds a
kernel wrapper once per key and returns the memoized one afterwards, with hit
and miss counts. The wrappers' launch counters let a run show which kernels
it went through. The module ends with the libxsmm-shaped GEMM dispatch
functions (the reference's XsmmRunnerUtils.cpp dispatch/invoke split), with
the JAX package's names and arguments; other keys go through
`global_cache().dispatch(key)`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from .flags import BrgemmKey
from .kernels import Kernel, build_kernel


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0


class KernelCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._kernels: dict = {}
        self.stats = CacheStats()

    def dispatch(self, key) -> Kernel:
        with self._lock:
            fn = self._kernels.get(key)
            if fn is not None:
                self.stats.hits += 1
                return fn
            self.stats.misses += 1
        fn = build_kernel(key)
        with self._lock:
            return self._kernels.setdefault(key, fn)

    def kernels(self) -> list[Kernel]:
        with self._lock:
            return list(self._kernels.values())

    def reset_launches(self) -> None:
        for fn in self.kernels():
            fn.launches = 0

    def launches_by_kind(self) -> dict[str, int]:
        """Launch counts summed by key type name (BrgemmKey, ChainKey)."""
        out: dict[str, int] = {}
        for fn in self.kernels():
            name = type(fn.key).__name__
            out[name] = out.get(name, 0) + fn.launches
        return out

    def clear(self) -> None:
        with self._lock:
            self._kernels.clear()
            self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._kernels)


_GLOBAL = KernelCache()


def global_cache() -> KernelCache:
    return _GLOBAL


# -- C-ABI-shaped convenience wrappers (runtime/Xsmm/XsmmRunnerUtils.cpp) ----
# The JAX functions' `interpret` argument picks a Pallas mode and has no
# counterpart here: the operands' device chooses (Kernel.__call__), the CUDA
# kernel for CUDA tensors and the plain version for CPU tensors.

def gemm_dispatch(m, n, k, dtype="f32", beta0=False, transpose_b=False,
                  **kw):
    """`gemm(a, b, c=None)`: one GEMM, the batch-1 BRGEMM kernel with the
    batch dim added to A and B; transpose_b (B given as [n, k]) stays in
    the key and the kernel reads B so."""
    fn = _GLOBAL.dispatch(BrgemmKey(batch=1, m=m, n=n, k=k, dtype=dtype,
                                    beta0=beta0, transpose_b=transpose_b,
                                    **kw))

    def gemm(a, b, c=None):
        return fn(a[None], b[None], c)
    return gemm


def brgemm_dispatch(batch, m, n, k, dtype="f32", beta0=False, vnni=0,
                    **kw) -> Kernel:
    return _GLOBAL.dispatch(BrgemmKey(batch=batch, m=m, n=n, k=k,
                                      dtype=dtype, beta0=beta0, vnni=vnni,
                                      **kw))


def fused_brgemm_dispatch(batch, m, n, k, dtype="f32", beta0=False, vnni=0,
                          binary_kind="add", binary_bcast="bcast_col",
                          unary_kind="relu", **kw) -> Kernel:
    return _GLOBAL.dispatch(BrgemmKey(
        batch=batch, m=m, n=n, k=k, dtype=dtype, beta0=beta0, vnni=vnni,
        binary_kind=binary_kind, binary_bcast=binary_bcast,
        unary_kind=unary_kind, **kw))
