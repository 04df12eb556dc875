"""Build the port's CUDA kernels and load them with ctypes.

At first use, every `csrc/*.cu` is compiled by `nvcc` for sm_90a into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds rather than minutes), under `tpp_mlir_tpu_torch/build/`, which
`.gitignore` lists. The library's name carries a hash of the sources, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing is
downloaded: the sources in the package are the only input.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (restype, argtypes)
    "tpp_brgemm": (_I, [_P, _P, _P, _P, _P] + [_I] * 12 + [_P]),
    "tpp_chain": (_I, [_P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
                       ctypes.POINTER(_I)] + [_I] * 10 + [_P]),
    "tpp_chain_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    "tpp_error_string": (ctypes.c_char_p, [_I]),
}


@dataclass(frozen=True)
class BuildInfo:
    """What a build did: the library path, whether it compiled now, the
    seconds it took, and nvcc's output (the ptxas register/spill report)."""

    path: Path
    compiled: bool
    seconds: float
    log: str


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless a library of the same sources exists."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libtpp_kernels-{_digest()}.so"
    if path.exists():
        return BuildInfo(path, False, 0.0, "")
    cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildInfo(path, True, time.perf_counter() - t0,
                     proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build().path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc:
        msg = library().tpp_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
