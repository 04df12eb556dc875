"""Time the port's int8 GEMM (B15) and row LayerNorm (B12) on the card.

For every key of chip_smoke.py's B15 cases (the int8 prefill's QKV/out
projection, fc1 + gelu, fc2 and LM head at B 8 x S 512 = 4096 rows, and a
ragged m) and B12 cases (GPT-2's ln_f 2048 x 768 bf16, the encoder's 2048 x
1024 f32): the kernel's time replayed from a CUDA graph, its bound (the
larger of bytes over 3.35 TB/s and operations over 1,979 int8 TOP/s) and
its share of it, and a yardstick: for B15 the composed PyTorch chain
torch._int_mm (s8 x s8 -> s32) + the scales, the bias and gelu (composed,
not one call; _int_mm's column-major weight is made outside the timed
region), for B12 F.layer_norm, both from a CUDA graph. Where the checkout
has them, each key's first design forced (build_int8 "wmma",
build_layer_norm "strided") and, for B12, an empty kernel's launch from the
same graph (the card's floor). Each output's bytes on seeded inputs are
hashed (sha256, 16 hex digits) so that two checkouts' B15 outputs can be
compared bit for bit. Then the gpt2_small_serve_b8_int8 prefill (B 8,
prompt 512, random weights from seed 0, as chip_smoke.py phase 5 makes it):
its time with the kernels on, eagerly and replayed from a CUDA graph,
and its logits against the kernels-off engine. --parts kernels or
--parts prefill runs one of the two.

    python scripts/port_int8_ln_times.py [--repo PATH] [--parts PARTS]

--repo imports tpp_mlir_tpu_torch from another checkout (for example the
parent commit, unpacked with git archive) instead of this one; its kernels
are built there. Run both in one command, in turns (parent, change, change,
parent), to compare them on one card. Needs an NVIDIA card; prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def graph_ms(fn, iters: int = 20) -> float:
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


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of t's bytes."""
    import torch
    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def int8_keys():
    from tpp_mlir_tpu_torch.xsmm import Int8GemmKey
    return [
        ("qkv/wo 4096x768x768 +bias", Int8GemmKey(
            m=4096, n=768, k=768, has_bias=True)),
        ("fc1 4096x3072x768 +bias+gelu", Int8GemmKey(
            m=4096, n=3072, k=768, has_bias=True, unary_kind="gelu")),
        ("fc2 4096x768x3072 +bias", Int8GemmKey(
            m=4096, n=768, k=3072, has_bias=True)),
        ("lm head 4096x50304x768", Int8GemmKey(m=4096, n=50304, k=768)),
        ("ragged 33x768x768 +bias+gelu", Int8GemmKey(
            m=33, n=768, k=768, has_bias=True, unary_kind="gelu")),
    ]


def int8_args(key, g):
    """Activations quantized per row and weights per column, as the engine
    makes them, a bf16 bias, and the weight's K-major copy."""
    import torch

    from tpp_mlir_tpu_torch.serving import quantize, quantize_tokens
    xq, xs = quantize_tokens(torch.randn(key.m, key.k, generator=g,
                                         device="cuda"))
    w = quantize(torch.randn(key.k, key.n, generator=g, device="cuda")
                 * key.k ** -0.5)
    bias = torch.randn(key.n, generator=g, device="cuda").to(torch.bfloat16)
    return xq, w.q, xs, w.scale, bias if key.has_bias else None, \
        w.q.t().contiguous()


def int_mm_chain(key, xq, wq, xs, ws, bias, wt):
    """torch._int_mm + scales + bias + F.gelu (the exact-erf gelu that
    gelu_exp2 rounds to within an ulp), the operands laid out beforehand."""
    import torch
    import torch.nn.functional as F
    w = wt.t()          # (k, n) column-major, the layout cuBLASLt wants
    try:
        torch._int_mm(xq, w)
    except RuntimeError:
        w = wq
    xs2, ws2 = xs.reshape(-1, 1), ws.reshape(1, -1)
    b = bias.float().reshape(1, -1) if bias is not None else None

    def run():
        y = torch._int_mm(xq, w).float() * xs2 * ws2
        if b is not None:
            y = y + b
        return F.gelu(y) if key.unary_kind == "gelu" else y
    return run


def time_int8() -> None:
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, kernels, reference
    new = hasattr(kernels, "build_int8")
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, key in int8_keys():
        xq, wq, xs, ws, bias, wt = int8_args(key, g)
        args = (xq, wq, xs, ws) + ((bias,) if bias is not None else ())
        kern = build_kernel(key)

        def call(k=kern):
            return k(*args, wt=wt) if new else k(*args)
        out, again = call(), call()
        want = reference.reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel = ((out - want).abs().max() / want.abs().max()).item()
        iters = 5 if key.n > 10000 else 20
        ms = graph_ms(call, iters)
        bound_b = (nbytes(xq, wt, xs, ws, bias) + out.numel() * 4) \
            / HBM_BYTES_PER_S * 1e3
        bound_o = 2 * key.m * key.n * key.k / INT8_OPS_PER_S * 1e3
        bound = max(bound_b, bound_o)
        chain = graph_ms(int_mm_chain(key, xq, wq, xs, ws, bias, wt), iters)
        note = ""
        if new:
            old = kernels.build_int8(key, "wmma")
            forced = old(*args)
            p = reference.int8_gemm_plan(key)
            note = (f"; route {reference.int8_gemm_route(key)}, tile "
                    f"{p.bm}x{p.bn}, {p.stages} stages, split {p.split}, "
                    f"{p.tiles} tiles, grid {p.grid}"
                    f"{' persistent' if p.persistent else ''}, {p.smem} B; "
                    f"forced wmma {graph_ms(lambda: old(*args), iters):.4f} "
                    f"ms, bit-equal {torch.equal(forced, out)}")
            del forced
        print(f"int8 {label}: graph {ms:.4f} ms, bound {bound:.4f} ms "
              f"({'operations' if bound_o > bound_b else 'bytes'}), share "
              f"{bound / ms:.3f}; composed _int_mm chain (not one call) "
              f"graph {chain:.4f} ms; rel {rel:.3e}; second launch bit-equal "
              f"{torch.equal(out, again)}; sha256 {digest(out)}{note}",
              flush=True)
        del out, again, want


def time_layer_norm() -> None:
    import torch
    import torch.nn.functional as F

    from tpp_mlir_tpu_torch.xsmm import LayerNormKey, build_kernel, kernels
    from tpp_mlir_tpu_torch.xsmm import reference
    new = hasattr(kernels, "build_layer_norm")
    if hasattr(kernels, "empty_kernel"):
        print(f"empty kernel from a CUDA graph: "
              f"{graph_ms(kernels.empty_kernel, 100):.4f} ms a launch",
              flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, key in (("ln_f gpt2 2048x768 bf16",
                        LayerNormKey(2048, 768, "bf16")),
                       ("ln enc 2048x1024 f32",
                        LayerNormKey(2048, 1024, "f32"))):
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
        x = (torch.randn(key.m, key.n, generator=g, device="cuda") * 3
             + 1).to(dt)
        gamma = torch.randn(key.n, generator=g, device="cuda")
        beta = torch.randn(key.n, generator=g, device="cuda")
        kern = build_kernel(key)
        out = kern(x, gamma, beta)
        want = reference.reference_kernel(key)(x, gamma, beta)
        torch.cuda.synchronize()
        rel = ((out.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        ms = graph_ms(lambda: kern(x, gamma, beta), 50)
        bound = (nbytes(x, gamma, beta) + out.numel() * out.element_size()) \
            / HBM_BYTES_PER_S * 1e3
        g2, b2 = gamma.to(dt), beta.to(dt)
        lib = graph_ms(lambda: F.layer_norm(x, (key.n,), g2, b2, key.eps),
                       50)
        note = ""
        if new:
            old = kernels.build_layer_norm(key, "strided")
            note = (f"; route {reference.layer_norm_route(key)}; forced "
                    f"strided {graph_ms(lambda: old(x, gamma, beta), 50):.4f}"
                    f" ms")
        print(f"layer_norm {label}: graph {ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes), share {bound / ms:.3f}; F.layer_norm graph "
              f"{lib:.4f} ms; rel {rel:.3e}; sha256 {digest(out)}{note}",
              flush=True)


def time_prefill() -> None:
    """The int8 serving prefill with the kernels on: eagerly (CUDA events,
    10 rounds of 5 prefills after 3 warm-ups: the median and quartiles of
    the rounds' means; the eager prefill waits on the host between its
    kernels, so a round can read high) and replayed from a CUDA graph (its
    device time); and its logits against the kernels-off engine."""
    import dataclasses

    import torch

    from tpp_mlir_tpu_torch.serving import make_prefill
    from tpp_mlir_tpu_torch.tools.tpp_serve import setup
    spec = dict(vocab=50304, embed=768, heads=12, layers=12, mlp_ratio=4,
                max_seq=1024, dtype="bf16", kv_quant="int8",
                int8_compute=True, batch=8, prompt=512, quant=True)
    cfg, params, ids = setup(spec, device="cuda")
    prefill = make_prefill(cfg)
    rounds = [cuda_ms(lambda: prefill(params, ids), iters=5,
                      warmup=3 if r == 0 else 0) for r in range(10)]
    q = sorted(rounds)
    graph = graph_ms(lambda: prefill(params, ids), iters=1)
    la, _ = prefill(params, ids)
    off = dataclasses.replace(cfg, decode_attn="xla")
    lb, _ = make_prefill(off, use_kernels=False)(params, ids)
    rel = ((la.float() - lb.float()).abs().max()
           / lb.float().abs().max()).item()
    print(f"prefill gpt2_small_serve_b8_int8 (b8 s512): eager median "
          f"{(q[4] + q[5]) / 2:.4f} ms (quartiles {q[2]:.4f}-{q[7]:.4f}; "
          f"rounds {', '.join(f'{r:.4f}' for r in rounds)}), replayed from "
          f"a CUDA graph {graph:.4f} ms; logits vs kernels off rel "
          f"{rel:.3e}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", type=Path, default=None,
                        help="import tpp_mlir_tpu_torch from this checkout")
    parser.add_argument("--parts", choices=("all", "kernels", "prefill"),
                        default="all", help="the kernels, the int8 serving "
                        "prefill, or both")
    args = parser.parse_args()
    root = args.repo or Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("port_int8_ln_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    import tpp_mlir_tpu_torch
    print(f"package {Path(tpp_mlir_tpu_torch.__file__).parent}", flush=True)
    from tpp_mlir_tpu_torch.xsmm import build
    print(f"build {build.build().seconds:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.parts in ("all", "kernels"):
        time_int8()
        time_layer_norm()
    if args.parts in ("all", "prefill"):
        time_prefill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
