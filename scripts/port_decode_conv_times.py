"""Time the port's decode attention and conv kernels on the card.

B13 (tpp_mlir_tpu_torch/csrc/decode_attn.cu) at the serving keys of
chip_smoke.py's phase 3 (B 8, S 1024, D 64, a 12-layer stacked cache at
pos 639; slotted with a free slot, GQA kv4 g3, int8 KV, pack2, f32), from a
CUDA graph two ways: its launches walking the 12 layers (as a decode step
reads them: 12 slabs, more than L2 holds) and layer 5 replayed alone
(whose slab L2 can hold), beside SDPA on the same live rows (a mask for
the slotted key). Then csrc/conv.cu (B24/B25 and B23's channel-blocked
entry) at the conv suite's keys, from a CUDA graph and eagerly, beside
F.conv2d + the epilogue (TF32 off) in the key's dtype and, for f32
"default" keys, on bf16 copies of I and W (the copies untimed), and its
tile body forced to "wmma" where the checkout has that route. Each kernel
is held against its plain version first.

    python scripts/port_decode_conv_times.py [--repo PATH]

--repo imports tpp_mlir_tpu_torch from another checkout (for example the
parent commit, unpacked with git archive) instead of this one; its kernels
are built there. Run both in one command, in turns, to compare them on one
card. Needs an NVIDIA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import subprocess
import sys
from pathlib import Path

TOL_F32, TOL_BF16 = 1e-4, 1e-2
LAYERS, LAYER = 12, 5


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 24) -> float:
    """Mean device ms of fn() from one CUDA graph of `iters` calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=3, warmup=1) / iters


def rel(got, want) -> float:
    return (got.float() - want.float()).abs().max().item() / \
        max(want.float().abs().max().item(), 1e-30)


def decode_cases():
    from tpp_mlir_tpu_torch.xsmm import DecodeAttnKey
    geo = dict(batch=8, seq=1024, head_dim=64, stacked=LAYERS)
    return [
        ("mha b8 h12 s1024 d64 bf16", DecodeAttnKey(heads=12, **geo)),
        ("slotted, one free slot", DecodeAttnKey(heads=12, slotted=True,
                                                 **geo)),
        ("gqa kv4 g3", DecodeAttnKey(heads=4, groups=3, **geo)),
        ("int8 kv", DecodeAttnKey(heads=12, kv_quant=True, **geo)),
        ("pack2", DecodeAttnKey(heads=12, pack2=True, **geo)),
        ("mha f32", DecodeAttnKey(heads=12, dtype="f32", **geo)),
    ]


def decode_args(key, g):
    """q, the stacked K/V cache (int8 payloads with per-row scales for
    kv_quant), pos (slotted: rows at their own positions, one free slot)."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    if key.pack2:
        q_shape, slab = (B, H // 2, 2 * D), (LAYERS, B, H // 2, S, 2 * D)
    else:
        q_shape = (B, H, D) if G == 1 else (B, H, G, D)
        slab = (LAYERS, B, H, S, D)
    q = torch.randn(q_shape, generator=g, device="cuda").to(dt)
    k = torch.randn(slab, generator=g, device="cuda")
    v = torch.randn(slab, generator=g, device="cuda")
    k_s = v_s = None
    if key.kv_quant:
        k_s = k.abs().amax(-1) / 127
        v_s = v.abs().amax(-1) / 127
        k = torch.round(k / k_s[..., None]).to(torch.int8)
        v = torch.round(v / v_s[..., None]).to(torch.int8)
    else:
        k, v = k.to(dt), v.to(dt)
    pos = [639, S, 0, 511, S - 1, 100, 639, 300] if key.slotted else [639]
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda"), \
        k_s, v_s


def decode_sdpa(key, q, k, v, pos):
    """SDPA on each layer's live rows (copied contiguous, untimed) as
    call(li), a mask for a slotted key; None where SDPA computes another
    function (GQA, int8 scales, pack2)."""
    import torch
    import torch.nn.functional as F
    if key.groups != 1 or key.kv_quant or key.pack2:
        return None
    live = int(torch.clamp(pos.long() + 1, max=key.seq).max())
    kl = [t[:, :, :live].contiguous() for t in k]
    vl = [t[:, :, :live].contiguous() for t in v]
    mask = torch.arange(live, device=q.device) <= pos.reshape(-1, 1, 1, 1) \
        if key.slotted else None
    return lambda li: F.scaled_dot_product_attention(
        q[:, :, None], kl[li], vl[li], attn_mask=mask,
        scale=key.head_dim ** -0.5)


def walk(fn):
    layers = itertools.count()
    return lambda: fn(next(layers) % LAYERS)


def plan_note(key) -> str:
    from tpp_mlir_tpu_torch.xsmm import DecodeAttnKey, reference
    if isinstance(key, DecodeAttnKey):
        plan = getattr(reference, "decode_attn_plan", None)
        if plan is None:
            return "one block per (KV head, batch row)"
        chunk, splits = plan(key)
        return f"chunk {chunk}, splits {splits}"
    route = getattr(reference, "conv_kernel_route", None)
    if route is None:
        return "the WMMA / FMA tile"
    name = route(key)
    if name in ("tma", "convert"):
        bm, bn, split = reference.conv_plan(key)
        return f"route {name}, tile {bm}x{bn}, split {split}"
    return f"route {name}"


def time_decode() -> None:
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    g = torch.Generator(device="cuda").manual_seed(3)
    for label, key in decode_cases():
        q, k, v, pos, k_s, v_s = decode_args(key, g)
        kern, plain = build_kernel(key), reference_kernel(key)

        def run(fn, li):
            return fn(q, k, v, pos, li, k_s, v_s)
        got = run(kern, LAYER)
        err = rel(got, run(plain, LAYER))
        same = torch.equal(run(kern, LAYER), got)
        sdpa = decode_sdpa(key, q, k, v, pos)
        k_walk = graph_ms(walk(lambda li: run(kern, li)))
        k_one = graph_ms(lambda: run(kern, LAYER))
        lib = "SDPA none"
        if sdpa is not None:
            lib = f"SDPA walk {graph_ms(walk(sdpa)):.4f} ms, layer " \
                f"{LAYER} {graph_ms(lambda: sdpa(LAYER)):.4f} ms"
        ok = err <= TOL_F32 and same
        print(f"decode {label}: kernel walk {k_walk:.4f} ms, layer "
              f"{LAYER} {k_one:.4f} ms (from a CUDA graph); {lib}; rel "
              f"{err:.3e} tol {TOL_F32:.0e}, repeat bit-equal {same} "
              f"{'ok' if ok else 'FAIL'}; {plan_note(key)}", flush=True)
        del q, k, v, sdpa


def conv_cases():
    from tpp_mlir_tpu_torch.xsmm import ConvBrgemmKey, ConvNhwcKey
    c128 = ConvNhwcKey(N=8, H=30, W=30, C=128, K=128, R=3, S=3,
                       out_dtype="f32", binary_bcast="none",
                       unary_kind="relu")
    packed = dict(N=8, H=30, W=30, Cb=1, c=128, Kb=1, k=128, R=3, S=3,
                  beta0=True, binary_kind="add", unary_kind="relu")
    return [
        ("B24 conv3x3_fp32_b8_c128_k128_30 +C +relu", c128),
        ("B25 the same, forced fullrow",
         dataclasses.replace(c128, strategy="fullrow")),
        ("B24 conv3x3_bf16_b8_c128_k128_30",
         dataclasses.replace(c128, dtype="bf16", out_dtype="bf16")),
        ("B24 conv3x3_fp32_b8_c256_k256_16",
         dataclasses.replace(c128, H=16, W=16, C=256, K=256)),
        ("B24 resnet_block_nhwc_bf16 same + residual",
         ConvNhwcKey(N=8, H=16, W=16, C=128, K=128, R=3, S=3, dtype="bf16",
                     out_dtype="bf16", binary_kind="add",
                     binary_bcast="none", unary_kind="relu",
                     pad=(1, 1, 1, 1))),
        ("B23 conv3x3_fp32_b8_c128_k128_30 packed +bias +relu",
         ConvBrgemmKey(**packed)),
        ("B23 conv3x3_bf16_b8_c128_k128_30 packed",
         ConvBrgemmKey(**packed, dtype="bf16")),
        ("B23 conv3x3_fp32_b8_c256_k256_16 packed (Cb 2)",
         ConvBrgemmKey(**dict(packed, H=16, W=16, Cb=2, Kb=2))),
    ]


def conv_args(key, g):
    import torch
    from tpp_mlir_tpu_torch.xsmm import ConvBrgemmKey
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]

    def rnd(*shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)
    if isinstance(key, ConvBrgemmKey):
        out = (key.N, key.Kb, key.P, key.Q, key.k)
        i = rnd(key.N, key.Cb, key.H, key.W, key.c)
        w = rnd(key.Kb, key.Cb, key.R, key.S, key.c, key.k,
                scale=(key.R * key.S * key.Cb * key.c) ** -0.5)
        bias = (key.Kb * key.k,)
    else:
        out = (key.N, key.P, key.Q, key.K)
        i = rnd(key.N, key.H, key.W, key.C)
        w = rnd(key.R, key.S, key.C, key.K,
                scale=(key.R * key.S * key.C) ** -0.5)
        bias = (key.K,)
    c = None if key.beta0 else rnd(*out, dtype=torch.float32)
    d = None
    if key.binary_kind:
        d = rnd(*(out if key.binary_bcast == "none" else bias),
                dtype=torch.float32)
    return i, w, c, d


def conv_library(key, i, w, c, d):
    """F.conv2d on the NCHW views (channels_last, the blocked layout
    unpacked here, untimed), TF32 off, then the plain version's epilogue;
    None for an asymmetric padding."""
    import torch
    import torch.nn.functional as F

    from tpp_mlir_tpu_torch.xsmm import ConvBrgemmKey
    from tpp_mlir_tpu_torch.xsmm.reference import (_conv_epilogue,
                                                   conv_blocked_nhwc,
                                                   no_tf32_conv)
    if isinstance(key, ConvBrgemmKey):
        key, ops = conv_blocked_nhwc(key)
        i, w, c, d = (None if t is None else t.contiguous()
                      for t in ops(i, w, c, d))
    pt, pb, pl, pr = key.pad
    if pt != pb or pl != pr:
        return None
    x = i.permute(0, 3, 1, 2)
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def call():
        with no_tf32_conv():
            y = F.conv2d(x, wt, padding=(pt, pl))
        acc = y.permute(0, 2, 3, 1).reshape(-1, key.K).float()
        return _conv_epilogue(key, acc, c, d)
    return call


def time_conv() -> None:
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, kernels, reference_kernel
    build_conv = getattr(kernels, "build_conv", None)
    g = torch.Generator(device="cuda").manual_seed(4)
    for label, key in conv_cases():
        args = conv_args(key, g)
        kern = build_kernel(key)
        got = kern(*args)
        err = rel(got, reference_kernel(key)(*args))
        tol = TOL_F32 if (key.out_dtype or key.dtype) == "f32" else TOL_BF16
        lib = conv_library(key, *args)
        parts = [f"kernel graph {graph_ms(lambda: kern(*args)):.4f} ms, "
                 f"eager {cuda_ms(lambda: kern(*args)):.4f} ms"]
        if lib is not None:
            parts.append(f"F.conv2d {key.dtype} graph {graph_ms(lib):.4f} "
                         f"ms, eager {cuda_ms(lib):.4f} ms")
        if key.dtype == "f32" and key.precision == "default":
            half = conv_library(key, args[0].to(torch.bfloat16),
                                args[1].to(torch.bfloat16), *args[2:])
            if half is not None:
                parts.append(f"F.conv2d bf16 graph {graph_ms(half):.4f} ms, "
                             f"eager {cuda_ms(half):.4f} ms")
        if build_conv is not None:
            wmma = build_conv(key, "wmma")
            err = max(err, rel(wmma(*args), reference_kernel(key)(*args)))
            parts.append(f"forced wmma graph "
                         f"{graph_ms(lambda: wmma(*args)):.4f} ms")
        print(f"conv {label}: {'; '.join(parts)}; rel {err:.3e} tol "
              f"{tol:.0e} {'ok' if err <= tol else 'FAIL'}; "
              f"{plan_note(key)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path, default=None,
                    help="checkout whose tpp_mlir_tpu_torch to import")
    args = ap.parse_args()
    if args.repo is not None:
        sys.path.insert(0, str(args.repo.resolve()))
    else:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import tpp_mlir_tpu_torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    pkg = Path(tpp_mlir_tpu_torch.__file__).parent
    print(f"tpp_mlir_tpu_torch from {pkg}", flush=True)
    from tpp_mlir_tpu_torch.xsmm import build
    info = build.build()
    print(f"build {info.seconds:.1f} s", flush=True)
    time_decode()
    time_conv()
    return 0


if __name__ == "__main__":
    sys.exit(main())
