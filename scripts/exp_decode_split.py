"""Where csrc/decode_attn.cu's time goes, at the serving keys on the card.

Builds variants of the committed kernel source with nvcc (into the
git-ignored build directory) and times them with their launches walking
the 12 stacked layers from a CUDA graph, as a decode step reads them
(scripts/port_decode_conv_times.py's keys and inputs):

  1. the chunk sweep: chunks of 64, 128, 192 and 256 rows (the source's
     two-tile cap raised to four for the sweep) at the MHA, GQA kv4 and
     int8-KV keys;
  2. stop-early variants at the plan's chunk (reference.decode_attn_plan):
     "pos" returns once pos is read, "no load" skips the copies (the
     tiles' barriers complete at once), "no passes" skips the three
     passes, "no merge" skips the split merge (the outputs are wrong: the
     variants time the steps left, nothing else);

    python scripts/exp_decode_split.py

Needs an NVIDIA card and nvcc; prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import port_decode_conv_times as times  # noqa: E402

SRC = ROOT / "tpp_mlir_tpu_torch" / "csrc" / "decode_attn.cu"
OUT = ROOT / "tpp_mlir_tpu_torch" / "build" / "exp_decode_split"

# (marker in the source, text put after it) per stop-early variant
STOPS = {
    "pos": [("  if (s0 >= live) return;          // no live row in this split",
             "\n  if (tid == 0 && sp == 0) a.out[(size_t)b * a.heads * G * D]"
             " = 0.f;\n  return;")],
    "no load": [("  constexpr uint32_t row_bytes = D * sizeof(Tkv);",
                 "\n  if (tid == 0) {\n    for (int t = 0; t < tiles; ++t)"
                 " hw::mbar_init(&bar[t], 1);\n    hw::mbar_fence_init();"
                 "\n    for (int t = 0; t < tiles; ++t)"
                 " hw::mbar_arrive(&bar[t]);\n  }\n  __syncthreads();"
                 "\n  if (0)")],
    "no passes": [("  // pass 1: the scores of the chunk's rows, sc[g][r] "
                   "(scaled, x ks)",
                   "\n  for (int t = 0; t < tiles; ++t)"
                   " hw::mbar_wait(&bar[t], 0);\n  __syncthreads();"
                   "\n  if (tid < G) { ml[2 * tid] = "
                   "0.f; ml[2 * tid + 1] = 1.f; }\n  for (int i = tid; i < "
                   "WARPS * G * D; i += THREADS) red[i] = 0.f;\n  "
                   "__syncthreads();\n  if (0) {"),
                  ("  // the block's sums, warps in order: the output, or "
                   "this split's partial", "\n  }")],
    "no merge": [("  if (nsplit == 1) return;", "\n  return;")],
}


def variant_source(stops, max_tiles: int = 2) -> str:
    """The committed source with the stop-early edits (each marker must be
    found once) and the tile cap raised to max_tiles."""
    s = SRC.read_text()
    s = s.replace("TILE = 64, MAX_TILES = 2;", f"TILE = 64, MAX_TILES = "
                  f"{max_tiles};")
    for marker, text in stops:
        if s.count(marker) != 1:
            raise RuntimeError(f"marker not found once: {marker!r}")
        if text.startswith("\n  }"):    # closes a block opened before
            s = s.replace(marker, text.lstrip("\n") + "\n" + marker)
        else:
            s = s.replace(marker, marker + text)
    return s


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Each named source compiled by its own nvcc, all at once, and
    loaded."""
    from torch.utils.cpp_extension import CUDA_HOME
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        cu = OUT / f"{name.replace(' ', '_')}.cu"
        cu.write_text(source)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [str(Path(CUDA_HOME) / "bin" / "nvcc"), "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", str(SRC.parent), "-o",
             str(cu.with_suffix(".so")), str(cu)]))
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (so, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for the {name!r} variant")
        lib = ctypes.CDLL(str(so))
        lib.tpp_decode_attn.argtypes = [P] * 9 + [I] * 12 + [ctypes.c_float,
                                                             P]
        lib.tpp_decode_attn.restype = I
        libs[name] = lib
    return libs


def caller(lib, key, args, chunk: int):
    """call(li): one launch of lib's tpp_decode_attn on layer li."""
    import torch

    from tpp_mlir_tpu_torch.xsmm.kernels import _decode_counts
    q, k, v, pos, k_s, v_s = args
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    splits = -(-S // chunk)
    out = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    work = torch.empty(B * H * splits * G * (D + 2), dtype=torch.float32,
                       device="cuda")
    counts = _decode_counts(q.device, B * H)
    kv = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[k.dtype]

    def call(li):
        rc = lib.tpp_decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_s.data_ptr() if k_s is not None else None,
            v_s.data_ptr() if v_s is not None else None, pos.data_ptr(),
            out.data_ptr(), work.data_ptr(), counts.data_ptr(), B, H, S, D,
            G, li, int(key.slotted), int(key.pack2),
            0 if key.dtype == "f32" else 1, kv, chunk, splits, D ** -0.5,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"decode_attn launch failed: {rc}")
    return call


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    from tpp_mlir_tpu_torch.xsmm.reference import decode_attn_plan
    libs = build({"full": variant_source([], max_tiles=4),
                  **{name: variant_source(edits)
                     for name, edits in STOPS.items()}})
    sweep = libs.pop("full")
    g = torch.Generator(device="cuda").manual_seed(3)
    for label, key in [times.decode_cases()[i] for i in (0, 2, 3)]:
        args = times.decode_args(key, g)

        def walk_ms(lib, chunk):
            return times.graph_ms(times.walk(caller(lib, key, args, chunk)))
        ms = [f"{c} rows {walk_ms(sweep, c):.4f}" for c in (64, 128, 192, 256)]
        print(f"decode {label}: walk by chunk: {', '.join(ms)} ms",
              flush=True)
        chunk = decode_attn_plan(key)[0]
        ms = [f"{name} {walk_ms(lib, chunk):.4f}"
              for name, lib in [("full", sweep)] + list(libs.items())]
        print(f"decode {label}: chunk {chunk}, walk: {', '.join(ms)} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
