"""Build the port's CUDA kernels and load them with ctypes.

At first use, every `csrc/*.cu` is compiled by `nvcc` for sm_90a, one nvcc
process per source, all started together, and the objects are linked into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds rather than minutes), under `tpp_mlir_tpu_torch/build/`,
which `.gitignore` lists. The library's name carries a hash of the sources,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is downloaded: the sources in the package are the only input.
`csrc/hopper.cuh` (TMA, bulk copies, mbarriers, wgmma) is shared by the
kernels that use Hopper's asynchronous copies, and `csrc/gemm_sm90.cuh`
(the pipelined TMA + wgmma GEMM mainloop) by brgemm.cu, blocked_matmul.cu,
conv.cu, grouped_gemm.cu and int8_gemm.cu, and `csrc/warm_panel.cuh` (the cluster-split
row-panel engine) by chain.cu and blocked_matmul.cu; the tensor-map
encoder, a driver API, is taken through the runtime's
cudaGetDriverEntryPoint, so the link needs no -lcuda.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: (restype, argtypes)
    "tpp_brgemm": (_I, [_P] * 6 + [_I] * 16 + [_F] + [_P] * 4 + [_I]
                   + [_P] * 2 + [ctypes.POINTER(_L), _P]),
    "tpp_gemm_plan": (_I, [_I] * 7 + [ctypes.POINTER(_I),
                                      ctypes.POINTER(_L)]),
    "tpp_attention": (_I, [_P] * 4 + [_I] * 11 + [_F, _P]),
    "tpp_batch_matmul": (_I, [_P] * 4 + [_I] * 11 + [_P]),
    "tpp_layer_norm": (_I, [_P] * 4 + [_I] * 6 + [_F, _P]),
    "tpp_empty_kernel": (_I, [_P]),
    "tpp_chain": (_I, [_P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
                       ctypes.POINTER(_I)] + [_I] * 11
                  + [ctypes.POINTER(_I), _P]),
    "tpp_warm_max_clusters": (_I, [_I] * 3 + [ctypes.POINTER(_I)]),
    "tpp_decode_attn": (_I, [_P] * 9 + [_I] * 12 + [_F, _P]),
    "tpp_int8_gemm": (_I, [_P] * 6 + [_I] * 5 + [_P]),
    "tpp_int8_gemm_wgmma": (_I, [_P] * 7 + [_I] * 8
                            + [ctypes.POINTER(_I), _P]),
    "tpp_flash_train_fwd": (_I, [_P] * 5 + [_I] * 6 + [_F, _I, _P]),
    "tpp_flash_train_bwd": (_I, [_P] * 9 + [_I] * 6 + [_F, _F, _I, _P]),
    "tpp_grouped_gemm": (_I, [_P] * 5 + [_I] * 12 + [_P]),
    "tpp_grouped_wgrad": (_I, [_P] * 4 + [_I] * 5 + [_L, _L] + [_I] * 3
                          + [_P]),
    "tpp_conv_nhwc": (_I, [_P] * 6 + [_I] * 24 + [_P]),
    "tpp_conv_blocked": (_I, [_P] * 6 + [_I] * 24 + [_P]),
    "tpp_blocked_matmul": (_I, [_P] * 6 + [_I] * 17
                           + [ctypes.POINTER(_L), ctypes.POINTER(_I), _P]),
    "tpp_blocked_warm_smem_bytes": (ctypes.c_longlong, [_I, _I]),
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
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    procs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj = work / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, err = proc.communicate()
            log.append(f"{src.name}:\n{out}{err}")
            if proc.returncode:
                failed.append(f"nvcc {src.name} failed ({proc.returncode}):"
                              f"\n{out}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = work / path.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, path)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return BuildInfo(path, True, time.perf_counter() - t0, "".join(log))


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
