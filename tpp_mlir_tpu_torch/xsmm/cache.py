"""Dispatch/invoke kernel cache, keyed by the frozen kernel keys.

The counterpart of `tpp_mlir_tpu/xsmm/cache.py`: `dispatch(key)` builds a
kernel wrapper once per key and returns the memoized one afterwards, with hit
and miss counts. The wrappers' launch counters let a run show which kernels
it went through.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

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
