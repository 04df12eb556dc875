"""Where a tile's time goes in csrc/int8_gemm.cu's wgmma body (B15).

Builds edited copies of the committed csrc/int8_gemm.cu with nvcc into the
git-ignored build directory and times them from a CUDA graph at the int8
prefill's keys (QKV/out projection, fc1 + gelu, the LM head), each beside
the committed kernel:
  - "timeline": clock64 stamps, summed over block 0's tiles, in
    kilocycles: of consumer thread 0, the mainloop (consume_ring), the wait
    for the staging buffer to be free, the s32 tile into it; of the
    epilogue warpgroup's thread 0, its wait for the warpgroup and the row
    scales into shared memory, the wait for the next tile's sums, the rows
    (scales, bias, unary, stores); written over the output's first
    elements once the block is done (the output is then wrong);
  - "nostore": the timeline with the rows' global stores skipped;
  - "norows": the timeline with the rows skipped.
Each variant's ptxas report is printed.

    python scripts/exp_int8_epilogue.py

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

import port_int8_ln_times as times  # noqa: E402

CSRC = ROOT / "tpp_mlir_tpu_torch" / "csrc"
OUT = ROOT / "tpp_mlir_tpu_torch" / "build" / "exp_int8_epilogue"

# (marker in csrc/int8_gemm.cu, what replaces it): the timeline's stamps;
# the consumer's go through shared memory to the epilogue's thread 0,
# which writes all six after its last tile (named barrier 4)
TIMELINE = [
    ("  int32_t* staged = reinterpret_cast<int32_t*>(smem + T::tile_off);\n",
     "  int32_t* staged = reinterpret_cast<int32_t*>(smem + T::tile_off);\n"
     "  __shared__ long long stamps[3];\n"),
    ("    const int etid = tid - NCW * sm::WG;\n",
     "    const int etid = tid - NCW * sm::WG;\n"
     "    long long ea = 0, eb = 0, ec = 0;\n"),
    ("      hw::bar_sync(T::BAR_EPI, sm::WG);   // the last tile's rows are "
     "out\n",
     "      const long long e0 = clock64();\n"
     "      hw::bar_sync(T::BAR_EPI, sm::WG);\n"),
    ("      hw::bar_sync(T::BAR_FULL, T::HANDOFF);\n",
     "      const long long e1 = clock64();\n      ea += e1 - e0;\n"
     "      hw::bar_sync(T::BAR_FULL, T::HANDOFF);\n"
     "      const long long e2 = clock64();\n      eb += e2 - e1;\n"),
    ("      if (t + (int)gridDim.x < g.tiles)\n"
     "        hw::bar_arrive(T::BAR_EMPTY, T::HANDOFF);\n    }\n"
     "    return;\n",
     "      ec += clock64() - e2;\n"
     "      if (t + (int)gridDim.x < g.tiles)\n"
     "        hw::bar_arrive(T::BAR_EMPTY, T::HANDOFF);\n    }\n"
     "    hw::bar_sync(4, T::HANDOFF);\n"
     "    if (blockIdx.x == 0 && etid == 0) {\n"
     "      float* o = static_cast<float*>(g.out);\n"
     "      for (int i = 0; i < 3; ++i) o[i] = stamps[i] / 1e3f;\n"
     "      o[3] = ea / 1e3f; o[4] = eb / 1e3f; o[5] = ec / 1e3f;\n"
     "    }\n    return;\n"),
    ("  sm::RingPos pos;\n",
     "  sm::RingPos pos;\n  long long tm = 0, tw = 0, ts = 0;\n"),
    ("    int acc[BN / 2];\n",
     "    const long long c0 = clock64();\n    int acc[BN / 2];\n"),
    ("    // the epilogue warpgroup is done with the last tile's sums\n",
     "    const long long c1 = clock64();\n    tm += c1 - c0;\n"),
    ("    // acc[4 jj + 2 h + e]: row 16 warp",
     "    const long long c2 = clock64();\n    tw += c2 - c1;\n"
     "    // acc[4 jj + 2 h + e]: row 16 warp"),
    ("    hw::bar_arrive(T::BAR_FULL, T::HANDOFF);\n  }\n}\n",
     "    hw::bar_arrive(T::BAR_FULL, T::HANDOFF);\n"
     "    ts += clock64() - c2;\n  }\n"
     "  if (tid == 0) {\n"
     "    stamps[0] = tm; stamps[1] = tw; stamps[2] = ts;\n  }\n"
     "  hw::bar_arrive(4, T::HANDOFF);\n}\n"),
]
VARIANTS = {
    "timeline": [],
    "nostore": [("      if (p < g.m) i8_store<U>(",
                 "      if (p < g.m && g.m < 0) i8_store<U>(")],
    "norows": [("      switch (g.split > 1 ? tpp::kIdentity : g.unary) {",
                "      if (g.m >= 0) {\n      } else\n"
                "      switch (g.split > 1 ? tpp::kIdentity : g.unary) {")],
}


def edit(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"marker not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build(variants: dict) -> dict:
    """Each variant's edited copy built by its own nvcc, all started
    together; returns the loaded libraries by name."""
    from tpp_mlir_tpu_torch.xsmm.build import NVCC_FLAGS, _nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, pairs in variants.items():
        cu = OUT / f"int8_{name}.cu"
        cu.write_text(edit((CSRC / "int8_gemm.cu").read_text(), pairs))
        so = OUT / f"libint8_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{out}\n{err}")
        fn = ""
        for line in (out + err).splitlines():
            if "Function properties for" in line:
                fn = line.split("for", 1)[1].strip()
            if "int8_wgmma_kernelILi2ELi192" in fn and (
                    "registers" in line or "spill" in line):
                print(f"  {name} ptxas: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.tpp_int8_gemm_wgmma
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
            [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        libs[name] = lib
    return libs


def launcher(lib, key, args):
    import torch

    from tpp_mlir_tpu_torch.xsmm import kernels, reference
    xq, wq, xs, ws, bias, wt = args
    p = reference.int8_gemm_plan(key)
    plan = (ctypes.c_int * 6)(p.bm, p.bn, p.split, p.tiles, p.grid, p.smem)
    out = torch.empty(key.m, key.n, device="cuda")
    unary = kernels._UNARY_CODE[key.unary_kind]

    def run():
        rc = lib.tpp_int8_gemm_wgmma(
            xq.data_ptr(), wt.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            None, key.m, key.n, key.k, unary, 0, 0, 0,
            1 if bias is not None else 0, plan,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
    return run, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("exp_int8_epilogue: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    from tpp_mlir_tpu_torch.xsmm import build_kernel
    libs = build({name: TIMELINE + extra for name, extra in VARIANTS.items()})
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, key in times.int8_keys()[:4]:
        if "fc2" in label:
            continue
        args = times.int8_args(key, g)
        kern = build_kernel(key)
        call = (args[:4] + ((args[4],) if args[4] is not None else ()))
        iters = 5 if key.n > 10000 else 20
        base = times.graph_ms(lambda: kern(*call, wt=args[5]), iters)
        line = [f"committed {base:.4f} ms"]
        for name, lib in libs.items():
            run, out = launcher(lib, key, args)
            ms = times.graph_ms(run, iters)
            run()
            torch.cuda.synchronize()
            tiles = -(-key.m // 128) * -(-key.n // 192)
            mine = len(range(0, tiles, min(tiles, 132)))
            st = out[0, :6].tolist()
            line.append(f"{name} {ms:.4f} ms (block 0, {mine} tiles; "
                        f"consumer: mainloop {st[0]:.1f}, waiting for the "
                        f"staging {st[1]:.1f}, staging {st[2]:.1f}; "
                        f"epilogue: row scales {st[3]:.1f}, waiting for sums "
                        f"{st[4]:.1f}, rows {st[5]:.1f} kcycles)")
        print(f"{label}: " + "; ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
