#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpp_mlir_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build csrc/*.cu with nvcc (one process per source, in parallel) and
     print the build seconds;
  3. hold each Hopper kernel against its plain PyTorch version on the card,
     at the main paths' shapes, with the tolerance stated per case (for
     serving: the prefill attention at B 8, S 512, H 12, D 64 with split
     q/k/v; decode attention at B 8, H 12, S 1024, D 64, L 12 and its
     slotted, GQA, int8-KV, pack2 and f32 variants; the int8 GEMM at the
     four prefill shapes and a ragged m; for training: B1 forward and
     transpose_b (dx) at the MLP rows' shapes, B14 and B18 at the GPT-2
     training key B 8, S 512, H 12, D 64 causal bf16, an f32 key at D 128
     and a GQA case through the autograd op, B18 twice bit-equal; for MoE:
     B16 at the prefill's fc1 (gelu) and fc2, the training step's z1 and
     its two transpose_b dgrads (9216 padded rows), a bm 16 key, a stacked
     `layers` key and a skewed routing, padding rows exactly zero; B17 at
     dw2 and dw1 and a skewed routing, twice bit-equal, an expert no token
     chose exactly zero);
  4. run the main paths, each with the launch counts set to 0 just before
     and read just after:
     a. the MLP path through tpp_mlir_tpu_torch.tools.tpp_run.run_module on
        tpp-gen output (flagship MLP 256 x 1024x4 bias+relu in bf16 and f32,
        the fc 256x1024x1024 bias+relu, the matmul 256x1024x1024): the
        flagship must lower to one xsmm.fused_chain, both kernels' launch
        counts must move, and each output must match --linalg-to-loops;
     b. the transformer path: GPT-2 small (gpt2_small_s1024_bf16: batch 2,
        seq 1024, vocab 50304, E 768, 12 heads, 12 layers, bf16, random
        weights from seed 0) and the encoder block
        (transformer_block_d128_fp32: batch 8, seq 256, E 1024, 8 heads,
        f32), built by tpp_mlir_tpu_torch.tools.bench_driver and run through
        run_module: the lowered op counts, the attention / layer_norm /
        brgemm launch counts, finite outputs, and the outputs against
        --linalg-to-loops;
     c. the serving path: tpp_mlir_tpu_torch.serving make_generate at full
        width (batch 8, prompt 512, random weights from seed 0) for
        gpt2_small_serve_b8 (128 greedy steps), gpt2_small_serve_b8_int8
        (int8 weights, int8 KV, int8 compute; 128 steps) and
        llama_gqa_serve_b8 (RoPE/RMSNorm/SwiGLU, 4 KV heads; 32 steps): the
        launch counts of an eager generate (attention 12, decode_attn
        12 x (steps - 1), int8_gemm 73 for the int8 configuration), finite
        logits, prefill and teacher-forced decode logits against the same
        engine with its kernels off (composed prefill attention, einsum
        decode attention, the int8 GEMM's plain version), the kernels-on
        prefill with the composed attention in B7's place against it too
        (the witness of B7's share of the prefill error), and the tokens of
        the CUDA-graph-replayed generate equal to the eager ones; then
        gpt2_small_serve_b8's prefill with flash_attn (B14, 12 launches);
     d. the training path (scripts/bench_train.py's rows): the MLP SGD step
        (tpp_mlir_tpu_torch.parallel.make_train_step, 1024x4 at b256 bf16,
        b256 f32 "highest", b2048 bf16), 3 steps with B1 against 3 with the
        kernels off, B1 forward and dx launches counted, then timed; GPT-2
        small's AdamW step (make_gpt_train_step: B 8, S 512, bf16, random
        weights from seed 0, ids from default_rng(1)) with B14/B18 against
        the composed attention: the step-0 loss against the CE of the
        port's prefill logits, step-0 grads leaf by leaf, a falling loss,
        12 B14 and 12 B18 launches per step, then 10 timed steps of each
        (ms/step, tokens/s, TFLOP/s);
     e. the MoE slice, GPT-2 small MoE-8 top-2 at full width (bm 128,
        bf16, random weights from seed 0): gpt2_small_moe8_serve_b8
        (make_generate with the grouped prefill, 32 steps at b8 in the scan
        decode form and 8 at b1 in the slice form; 24 B16 launches a
        prefill; logits against the kernels-off engine with the router
        pinned to the kernel run's choices, the unpinned routing-flip
        share printed) and gpt2_small_moe8_train_b8_s512_bf16
        (make_gpt_train_step, AdamW 1e-3, the grouped form against the
        scan form: step-0 CE, grads, falling losses, 48 B16 and 24 B17
        launches a step, 5 timed steps each);
     f. the MHA suite (benchmarks/configs/mha.json's thirteen rows at their
        own sizes: mha_qk, mha_softmax_v, mha_projection, mha_block,
        mha_full and the eight flash_attention rows) through
        tpp_mlir_tpu_torch.tools.bench_driver.run_entry with -n 20: the
        lowered op list, the launch counts of each entry, finite outputs
        against --linalg-to-loops, and which bench lowering ran (B11 in
        the kernel, B4, or the loop for bench_mode "scan"); then fc.json's
        fc_128x768x2304 and fc_128x3072x768 through tpp_run -n 100 (B5 in
        the kernel where chain.cu holds the row block, else the loop);
     g. the conv family (benchmarks/configs/conv.json's fourteen rows and
        vit.json's three, at their own sizes) through
        tpp_mlir_tpu_torch.tools.bench_driver.run_entry with each row's -n
        (its iters, or 20 for the ViT rows, which time the loop): the
        lowered invokes, the route of each conv (csrc/conv.cu for every
        stride-1 conv; xla, F.conv2d with TF32 off, for the ViT's strided
        patch conv), each row's launch counts, finite outputs against
        --linalg-to-loops, ms/iter of both;
     h. packed parity mode (default-tpp-passes-packed) at the suites' own
        sizes, through tpp_mlir_tpu_torch.tools.bench_driver.run_entry with
        each entry's `pipeline`: base.json's fc_{fp32,bf16}_packed_warm_1024
        with -n 200 (one B19 a forward, the bench in the kernel: B20) beside
        their flat twins; the flagship MLP 256 x 1024x4 f32 and bf16 with -n
        100 (one tl.pack, three B19, one tl.unpack a forward) and its
        tpp-gen --tiles=256,512,512 form under the default pipeline;
        conv.json's five NCHW rows and two imported ResNet rows (one or two
        B23 a forward; the 1x1 row lowers to B21) beside their flat runs of
        phase g; vit.json's three rows with -n 20 (twelve B19 a forward, B7
        and B12 as in phase g, the strided patch conv a tl.blocked_conv2d
        through F.conv2d); mha.json's three pack/unpack `file` rows with -n
        100, bit-exact against --linalg-to-loops. Each row: the lowered
        invokes, its launch counts, the bench lowering, finite outputs
        against --linalg-to-loops, ms/iter of both;
  5. time the same paths: the MLP at -n 100 beside torch.matmul+bias+relu,
     each transformer forward lowered beside --linalg-to-loops (GPT-2
     tokens/s), each serving configuration's prefill and decode step
     (eager and graph-replayed) beside the kernels-off engine, with a
     torch.profiler trace of 8 decode steps, the MoE prefill in its three
     forms and its decode step in each decode form at b8 and b1, and each
     kernel beside its
     plain version, one PyTorch call computing the same function where
     there is one, and its bound (bytes over HBM's rate or operations over
     the peak rate of their type, whichever is larger); for the MHA suite
     the flat attention at each TPU kernel's own key (B9 at the S 1024
     rows, B8 at S 2048, B10b/B10a at causal S 2048, B6 with forced
     blocks), B11 at -n 20, the batched matmul at mha_qk's and
     mha_softmax_v's keys and B5 at fc_128x768x2304 with -n 100; csrc/conv.cu
     at the conv kernel cases' keys beside F.conv2d + the epilogue (TF32
     off); B19 at the fc rows' keys beside torch.addmm on the unpacked
     operands, B20 at them with -n 200 as repeats, B23 at the packed conv
     rows' keys beside F.conv2d on the unpacked operands + the epilogue;
     each of these held against its plain version there too, the kernel
     line's max_abs_err for the three taken at the key whose ms it shows.
Phase 3 also holds the MHA suite's kernels: flat attention at every
flash_attention key and mha_full's, each forced strategy (grouped, qblock,
twocall, twocall2 on the flat layout; flash_heads and xla on the token
layout), B11 at repeats 3 (bf16 S 1024 D 128, and a causal key), the
batched matmul at mha_qk's and mha_softmax_v's keys, an lhs_shared and a
non-beta0 key, and B5 at fc_128x768x2304 with repeats 2 and 3; and
csrc/conv.cu (B24/B25) at the keys default-tpp-passes makes of the conv
suite (conv3x3_fp32_b8_c128_k128_30's layer at f32 "default" and "highest",
its bf16 form, c256 at 16x16, the 1x1 W 14 key, the same-padded residual
bf16 key, forced fullrow and window), and the xla route at the ViT's patch
conv at "highest" against the same plain version (TF32 would miss it); and
packed parity mode's kernels: csrc/blocked_matmul.cu (B19) at the fc rows'
key in f32 "default", f32 "highest" and bf16 VNNI, a masked mb 8 key and
the ViT's gelu fc1, B20 at repeats 3 in f32 "default" (the fc_fp32 row's
own key, which its -n runs), f32 "highest" and bf16, and
csrc/conv.cu's channel-blocked entry (B23) at the c128/30 key in f32 and
bf16, the c256/16 key (Cb 2) and the imported ResNet block's two keys (a C
accumulator). Phase 5 times B19, B20 and B23 at those rows' keys.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time

BATCH, WIDTH, LAYERS = 256, 1024, 4     # the flagship: batch 256, 1024x4
TOL_BF16 = 1e-2     # a bf16 output, or a chain of bf16 roundings
TOL_F32 = 1e-4      # same operand rounding on both sides: sum order only
# a whole model's output against --linalg-to-loops (f32 oracle, exact f32
# operands): 12 bf16 layers, or one f32 "default" block whose kernels round
# operands to bf16
TOL_MODEL = 3e-2
TOL_INT8 = 1e-5     # exact s32 product on both sides, the same f32 epilogue

GPT2 = ('gpt:{"batch": 2, "seq": 1024, "vocab": 50304, "embed": 768, '
        '"heads": 12, "layers": 12, "dtype": "bf16"}')
ENCODER = ('transformer_block:{"batch": 8, "seq": 256, "embed": 1024, '
           '"heads": 8}')

# the serving path: (label, GptConfig fields, LLaMA preset, int8 weights,
# greedy steps), each at batch 8 with a 512-token prompt
SERVE_BATCH, SERVE_PROMPT = 8, 512
GPT2_SERVE = dict(vocab=50304, embed=768, heads=12, layers=12, mlp_ratio=4,
                  max_seq=1024, dtype="bf16")
SERVING = (
    ("gpt2_small_serve_b8", GPT2_SERVE, False, False, 128),
    ("gpt2_small_serve_b8_int8",
     dict(GPT2_SERVE, kv_quant="int8", int8_compute=True), False, True, 128),
    ("llama_gqa_serve_b8", dict(embed=768, heads=12, kv_heads=4, layers=12,
                                max_seq=1024, dtype="bf16"), True, False, 32),
)

# the training path (bench_train.py's rows): the MLP 1024x4 at (batch,
# dtype, precision), f32 at "highest" so that it is held to 1e-4; GPT-2
# small at B 8, S 512, bf16, AdamW(1e-3), ids from default_rng(1)
TRAIN_MLP = ((256, "bf16", "default"), (256, "f32", "highest"),
             (2048, "bf16", "default"))
TRAIN_LAYERS = (WIDTH,) * 4
GPT2_TRAIN = dict(vocab=50304, embed=768, heads=12, layers=12, mlp_ratio=4,
                  max_seq=512, dtype="bf16")
TRAIN_B, TRAIN_S = 8, 512
TRAIN_STEPS, TIMED_STEPS = 3, 10
TOL_GRAD = 3e-2     # relative Frobenius error of a grad, flash vs composed
TOL_LSE = 1e-4      # lse2: f32 on both sides, sum order only

# the card's peaks (NVIDIA's H100 SXM data sheet, dense, 700 W) for the
# bound columns: operations at the rate of their type, bytes at HBM's
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def say(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref| / max |ref|, max |got - ref|), in f32."""
    d = (got.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30), d


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
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
    """Mean device milliseconds of fn(), from one CUDA graph of `iters`
    calls replayed after a warm-up: no host launch time between calls, so a
    kernel of a few microseconds reads as its own time."""
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


def phase_device() -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    say(card)       # the nvidia-smi line as it is: name, power limit
    from tpp_mlir_tpu_torch.utils import current_target
    from tpp_mlir_tpu_torch.xsmm.kernels import SM90_SMEM_OPTIN
    t = current_target("cuda")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} target "
        f"{t.name} sm_{t.capability[0]}{t.capability[1]} {t.sm_count} SMs, "
        f"{t.smem_per_block_optin} B shared memory per block, "
        f"{t.l2_bytes} B L2, count {torch.cuda.device_count()}")
    if t.smem_per_block_optin < SM90_SMEM_OPTIN:
        raise AssertionError("the chain gate plans for more shared memory "
                             "than this card offers a block")
    return card


def phase_build() -> None:
    from tpp_mlir_tpu_torch.xsmm import build
    info = build.build()
    lib = build.library()
    say(f"build: {info.seconds:.2f} s "
        f"({'compiled' if info.compiled else 'cached'}) {info.path.name}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            say(f"  ptxas: {line.strip()}")
    import torch

    from tpp_mlir_tpu_torch.xsmm.kernels import (blocked_warm_smem_bytes,
                                                 chain_smem_bytes)
    for mxu, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        want = lib.tpp_chain_smem_bytes(WIDTH, code)
        if want != chain_smem_bytes(WIDTH, mxu):
            raise AssertionError(f"chain_smem_bytes {chain_smem_bytes(WIDTH, mxu)}"
                                 f" != kernel's {want}")
        for K in (WIDTH, 1856):
            want = lib.tpp_blocked_warm_smem_bytes(K, code)
            if want != blocked_warm_smem_bytes(K, mxu):
                raise AssertionError(f"blocked_warm_smem_bytes "
                                     f"{blocked_warm_smem_bytes(K, mxu)} != "
                                     f"kernel's {want} at K {K}")


def _tol(key) -> float:
    """max|kernel - plain| / max|plain| allowed for `key`. A single GEMM with
    an f32 output rounds its operands exactly as its plain version does
    (f32 "default" included: bf16 operands on both sides), so only the sum
    order differs; so does a conv (its taps are such GEMMs). A chain
    re-rounds each layer's input to the MXU dtype, and so does a LayerNorm
    prologue its normalized rows, where a sum-order
    difference can flip a bf16 rounding: only their f32 "highest" forms are
    held to TOL_F32. Attention holds f32 "highest" to TOL_F32 and else
    TOL_BF16 (the kernel rounds the unnormalized P and divides after P.V,
    the plain version normalizes first, as B7 does), B14 under strategy
    flash_heads 2 * TOL_BF16 as phase 3 holds B14; LayerNorm an f32 output
    to TOL_F32. A batched matmul is a single GEMM, but its softmax_lhs
    rounds P to bf16 at "default", where an ulp of exp between kernel and
    plain version can flip a rounding: TOL_BF16 there. Packed mode's B19
    and B23 are single GEMMs; B20 re-rounds its state as a chain does."""
    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                         BrgemmKey, ConvBrgemmKey,
                                         ConvNhwcKey, DecodeAttnKey,
                                         Int8GemmKey, LayerNormKey)
    if isinstance(key, BlockedMatmulKey) and key.repeats:
        out_f32 = (key.out_dtype or key.dtype) == "f32"
        return TOL_F32 if out_f32 and key.precision == "highest" \
            else TOL_BF16
    if isinstance(key, DecodeAttnKey):
        return TOL_F32      # f32 math from the same values: sum order only
    if getattr(key, "strategy", None) == "flash_heads":
        return 2 * TOL_BF16
    if isinstance(key, BatchMatmulKey) and key.softmax_lhs and \
            key.precision == "default":
        return TOL_BF16
    if isinstance(key, Int8GemmKey):
        return TOL_INT8 if key.out_dtype == "f32" else TOL_BF16
    out_f32 = (key.out_dtype or key.dtype) == "f32"
    if isinstance(key, LayerNormKey):
        return TOL_F32 if out_f32 else TOL_BF16
    if isinstance(key, (BatchMatmulKey, ConvNhwcKey, BlockedMatmulKey,
                        ConvBrgemmKey)) or (
            isinstance(key, BrgemmKey) and not key.prologue):
        return TOL_F32 if out_f32 else TOL_BF16
    return TOL_F32 if out_f32 and key.precision == "highest" else TOL_BF16


def _brgemm_cases():
    """(label, key, make_inputs) at the main path's shapes."""
    from tpp_mlir_tpu_torch.xsmm import BrgemmKey
    M, N, K = BATCH, WIDTH, WIDTH
    cases = []
    for dt in ("f32", "bf16"):
        cases += [
            (f"gemm {dt} beta0", BrgemmKey(1, M, N, K, dt, beta0=True)),
            (f"gemm {dt} +C", BrgemmKey(1, M, N, K, dt)),
            (f"fc {dt} bias+relu", BrgemmKey(
                1, M, N, K, dt, beta0=True, binary_kind="add",
                unary_kind="relu")),
        ]
    cases += [
        ("gemm f32 highest", BrgemmKey(1, M, N, K, "f32", beta0=True,
                                       precision="highest")),
        ("bcast_row mul", BrgemmKey(1, M, N, K, "bf16", beta0=True,
                                    binary_kind="mul",
                                    binary_bcast="bcast_row")),
        ("bcast_scalar sub gelu", BrgemmKey(1, M, N, K, "bf16", beta0=True,
                                            binary_kind="sub",
                                            binary_bcast="bcast_scalar",
                                            unary_kind="gelu")),
        ("full add tanh", BrgemmKey(1, M, N, K, "f32", binary_kind="add",
                                    binary_bcast="none", unary_kind="tanh")),
        ("transpose_b", BrgemmKey(1, M, N, K, "bf16", beta0=True,
                                  transpose_b=True)),
        ("batch 4", BrgemmKey(4, M, N, K, "bf16", beta0=True)),
        ("vnni 2", BrgemmKey(1, M, N, K, "bf16", beta0=True, vnni=2,
                             binary_kind="add", unary_kind="relu")),
        ("ragged 1024x352x512", BrgemmKey(1, 1024, 352, 512, "f32",
                                          beta0=True, binary_kind="add",
                                          unary_kind="relu")),
    ]
    # the MLP training step's keys (phase 4d) not above: its rows at f32
    # "highest" and at batch 2048, forward and dx = g @ W^T (transpose_b)
    hi = dict(beta0=True, precision="highest")
    cases += [
        ("train fc f32 highest", BrgemmKey(1, M, N, K, "f32", **hi,
                                           binary_kind="add",
                                           unary_kind="relu")),
        ("train dx f32 highest transpose_b", BrgemmKey(
            1, M, N, K, "f32", **hi, transpose_b=True)),
        ("train fc 2048 bf16", BrgemmKey(1, 2048, N, K, "bf16", beta0=True,
                                         binary_kind="add",
                                         unary_kind="relu")),
        ("train gemm 2048 bf16", BrgemmKey(1, 2048, N, K, "bf16",
                                           beta0=True)),
        ("train dx 2048 bf16 transpose_b", BrgemmKey(
            1, 2048, N, K, "bf16", beta0=True, transpose_b=True)),
    ]
    return cases


def _brgemm_inputs(key, g):
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    dev = "cuda"

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    a = rnd((key.batch, key.m, key.k))
    if key.vnni:
        b = rnd((key.batch, key.k // key.vnni, key.n, key.vnni), 0.05)
    elif key.transpose_b:
        b = rnd((key.batch, key.n, key.k), 0.05)
    else:
        b = rnd((key.batch, key.k, key.n), 0.05)
    c = None if key.beta0 else rnd((key.m, key.n))
    d = None
    if key.binary_kind:
        shape = {"bcast_col": (key.n,), "bcast_row": (key.m, 1),
                 "bcast_scalar": (), "none": (key.m, key.n)}[key.binary_bcast]
        d = rnd(shape)
    return a, b, c, d


def _chain_cases():
    from tpp_mlir_tpu_torch.xsmm import ChainKey
    dims = (WIDTH,) * (LAYERS)
    out = []
    for dt, prec in (("bf16", "default"), ("f32", "default"),
                     ("f32", "highest")):
        for rep in (1, 8):
            out.append((f"chain {dt} {prec} repeats={rep}",
                        ChainKey(m=BATCH, dims=dims, dtype=dt,
                                 precision=prec, repeats=rep)))
    return out


def _chain_inputs(key, g):
    """x ~ N(0,1); W ~ N(0,1/k), so a ReLU layer shrinks the state and 8
    repeats stay in range; bias ~ N(0, 0.1^2)."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    x = torch.randn(key.m, key.dims[0], generator=g, device="cuda").to(dt)
    wb = []
    for i in range(len(key.dims) - 1):
        wb.append((torch.randn(key.dims[i], key.dims[i + 1], generator=g,
                               device="cuda") / key.dims[i] ** 0.5).to(dt))
        wb.append((torch.randn(key.dims[i + 1], generator=g,
                               device="cuda") * 0.1).to(dt))
    return (x, *wb)


def _ln_gemm_cases():
    """The LayerNorm-prologue GEMMs of the transformer path: GPT-2's QKV
    (bias) and fc1 (bias + gelu) in bf16, the encoder's in f32 "default",
    and one f32 "highest" case."""
    from tpp_mlir_tpu_torch.xsmm import BrgemmKey
    out = []
    for label, m, n, k, dt, unary in (
            ("gpt2 qkv 2048x2304x768", 2048, 2304, 768, "bf16", None),
            ("gpt2 fc1 2048x3072x768", 2048, 3072, 768, "bf16", "gelu"),
            ("enc qkv 2048x3072x1024", 2048, 3072, 1024, "f32", None),
            ("enc fc1 2048x4096x1024", 2048, 4096, 1024, "f32", "gelu")):
        out.append((f"ln {label} {dt}", BrgemmKey(
            1, m, n, k, dt, beta0=True, binary_kind="add", unary_kind=unary,
            prologue="layer_norm")))
    out.append(("ln enc qkv f32 highest", BrgemmKey(
        1, 2048, 3072, 1024, "f32", beta0=True, binary_kind="add",
        precision="highest", prologue="layer_norm")))
    return out


def _ln_gemm_inputs(key, g):
    """Raw A rows with a mean and scale away from 0 and 1, so the
    normalization shows; W ~ N(0, 1/k); bias, gamma, beta ~ N(0, 1)."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]

    def rnd(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device="cuda") * scale + shift
    a = rnd((1, key.m, key.k), 2.0, 0.5).to(dt)
    b = rnd((1, key.k, key.n), key.k ** -0.5).to(dt)
    return a, b, None, rnd((key.n,)), rnd((key.k,)), rnd((key.k,))


def _attention_cases():
    """Attention at the main paths' shapes: GPT-2 (B 2, S 1024, H 12, D 64,
    causal, bf16) with [Q|K|V] packed as qkv-merge leaves it; the serving
    prefill (B 8, S 512, H 12, D 64, causal, bf16) with split q/k/v, as
    the engine passes them (the LLaMA GQA configuration's key too, once its
    KV heads are repeated); the encoder (B 8, S 256, H 8, D 128,
    non-causal, f32 "default", packed), and its shape at "highest"."""
    from tpp_mlir_tpu_torch.xsmm import FlashMhaKey
    return [
        ("attn gpt2 b2 s1024 h12 d64 causal bf16", FlashMhaKey(
            2, 1024, 1024, 64, "bf16", scale=0.125, causal=True, heads=12,
            qkv_packed=True)),
        ("attn serve b8 s512 h12 d64 causal split", FlashMhaKey(
            8, 512, 512, 64, "bf16", scale=0.125, causal=True, heads=12)),
        ("attn enc b8 s256 h8 d128 f32", FlashMhaKey(
            8, 256, 256, 128, "f32", scale=128 ** -0.5, heads=8,
            qkv_packed=True)),
        ("attn enc b8 s256 h8 d128 highest", FlashMhaKey(
            8, 256, 256, 128, "f32", scale=128 ** -0.5, heads=8,
            qkv_packed=True, precision="highest")),
    ]


def _attention_inputs(key, g):
    """The packed (B, S, 3E) operand (passed thrice, as the executor does),
    or three separate (B, S, E) tensors for split q/k/v."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    E = key.heads * key.head_dim
    if key.qkv_packed:
        x = torch.randn(key.batch, key.seq, 3 * E, generator=g,
                        device="cuda").to(dt)
        return x, x, x
    return tuple(torch.randn(key.batch, s, E, generator=g,
                             device="cuda").to(dt)
                 for s in (key.seq, key.seq_kv, key.seq_kv))


def _layer_norm_cases():
    from tpp_mlir_tpu_torch.xsmm import LayerNormKey
    return [("ln_f gpt2 2048x768 bf16", LayerNormKey(2048, 768, "bf16")),
            ("ln enc 2048x1024 f32", LayerNormKey(2048, 1024, "f32"))]


def _layer_norm_inputs(key, g):
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    x = (torch.randn(key.m, key.n, generator=g, device="cuda") * 3 + 1)
    return (x.to(dt), torch.randn(key.n, generator=g, device="cuda"),
            torch.randn(key.n, generator=g, device="cuda"))


def _decode_attn_cases():
    """Decode attention at the serving geometry (B 8, 12 heads, S 1024,
    D 64, the stacked 12-layer cache read at layer 5, pos 639 = prompt 512
    + 127 steps) and its variants."""
    from tpp_mlir_tpu_torch.xsmm import DecodeAttnKey
    geo = dict(batch=8, seq=1024, head_dim=64, stacked=12)
    return [
        ("mha b8 h12 s1024 d64 bf16", DecodeAttnKey(heads=12, **geo)),
        ("slotted, one sentinel", DecodeAttnKey(heads=12, slotted=True,
                                                **geo)),
        ("gqa kv4 g3", DecodeAttnKey(heads=4, groups=3, **geo)),
        ("int8 kv", DecodeAttnKey(heads=12, kv_quant=True, **geo)),
        ("pack2", DecodeAttnKey(heads=12, pack2=True, **geo)),
        ("mha f32", DecodeAttnKey(heads=12, dtype="f32", **geo)),
    ]


def _decode_attn_inputs(key, g):
    """q, the stacked K/V cache (normal values, or int8 payloads with
    scales as quantize_tokens makes them), pos, the layer index 5, and the
    int8 cache's scales."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    if key.pack2:
        q_shape, slab = (B, H // 2, 2 * D), (key.stacked, B, H // 2, S, 2 * D)
    else:
        q_shape = (B, H, D) if G == 1 else (B, H, G, D)
        slab = (key.stacked, B, H, S, D)
    q = torch.randn(q_shape, generator=g, device="cuda").to(dt)
    k = torch.randn(slab, generator=g, device="cuda")
    v = torch.randn(slab, generator=g, device="cuda")
    k_s = v_s = None
    if key.kv_quant:
        from tpp_mlir_tpu_torch.serving import quantize_tokens
        (k, k_s), (v, v_s) = quantize_tokens(k), quantize_tokens(v)
    else:
        k, v = k.to(dt), v.to(dt)
    # slotted: rows at their own positions, one free slot (pos == S)
    pos = [639, S, 0, 511, S - 1, 100, 639, 300] if key.slotted else [639]
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q, k, v, pos, 5, k_s, v_s


def _int8_cases():
    """The int8 GEMMs of the int8 prefill (B 8 x S 512 = 4096 rows): QKV and
    the out projection, fc1 + gelu, fc2, the LM head; and a ragged m."""
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


def _int8_inputs(key, g):
    """Activations quantized per row and weights per column, as the engine
    makes them (quantize_tokens, quantize), and a bf16 bias."""
    import torch

    from tpp_mlir_tpu_torch.serving import quantize, quantize_tokens
    xq, xs = quantize_tokens(torch.randn(key.m, key.k, generator=g,
                                         device="cuda"))
    w = quantize(torch.randn(key.k, key.n, generator=g, device="cuda")
                 * key.k ** -0.5)
    bias = torch.randn(key.n, generator=g, device="cuda").to(torch.bfloat16)
    return (xq, w.q, xs, w.scale) + ((bias,) if key.has_bias else ())


def phase_kernels() -> dict:
    """Each kernel against its plain version on the same inputs."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    stats = {}
    for kind, cases, make in (
            ("brgemm", _brgemm_cases(), _brgemm_inputs),
            ("brgemm", _ln_gemm_cases(), _ln_gemm_inputs),
            ("chain", _chain_cases(), _chain_inputs),
            ("attention", _attention_cases(), _attention_inputs),
            ("layer_norm", _layer_norm_cases(), _layer_norm_inputs),
            ("decode_attn", _decode_attn_cases(), _decode_attn_inputs),
            ("int8_gemm", _int8_cases(), _int8_inputs)):
        worst = stats.get(kind, {}).get("max_abs_err", 0.0)
        for label, key in cases:
            args = make(key, g)
            got = build_kernel(key)(*args)
            ref = reference_kernel(key)(*args)
            torch.cuda.synchronize()
            rel, ab = rel_err(got, ref)
            tol = _tol(key)
            ok = rel <= tol and torch.isfinite(got.float()).all().item()
            note = ""
            if kind == "chain" and key.dtype == "f32" and \
                    key.precision == "default" and key.repeats == 1:
                # pins the meaning of f32 "default": a kernel that ran true
                # f32 would sit nearer the "highest" plain version (at
                # repeats 8 the bf16 feedback blurs the two, so only here)
                hi = reference_kernel(dataclasses.replace(
                    key, precision="highest"))(*args)
                rel_hi, _ = rel_err(got, hi)
                ok = ok and rel < rel_hi
                note = f" (vs highest plain {rel_hi:.3e}, must be farther)"
            say(f"kernel {kind:10s} {label:38s} rel {rel:.3e} abs {ab:.3e} "
                f"tol {tol:.0e}{note} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} {label}: rel {rel} > {tol}")
            worst = max(worst, ab)
        stats[kind] = {"max_abs_err": worst}
    return stats


# B14/B18 cases: (label, key, KV heads of a GQA case or None). The GPT-2
# training key, an f32 key (no tensor cores: f32 FMA) and a GQA case whose
# K/V are repeated to the query heads before the kernels, as
# flash_attention_train does
def _flash_train_cases():
    from tpp_mlir_tpu_torch.xsmm import FlashTrainKey
    return [
        ("gpt2 train b8 s512 h12 d64 causal bf16",
         FlashTrainKey(TRAIN_B, 12, TRAIN_S, 64, "bf16", True, 0.125), None),
        ("f32 b2 s256 h4 d128", FlashTrainKey(2, 4, 256, 128, "f32", False,
                                              128 ** -0.5), None),
        ("gqa b2 s256 h12 kv4 d64 causal bf16",
         FlashTrainKey(2, 12, 256, 64, "bf16", True, 0.125), 4),
    ]


def _flash_train_inputs(key, g, kv_heads=None):
    """q, k, v (k/v with kv_heads heads for GQA) and a cotangent dO, all
    (B, S, H, D) in the key's dtype."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    B, S, H, D = key.batch, key.seq, key.heads, key.head_dim

    def rnd(h):
        return torch.randn(B, S, h, D, generator=g, device="cuda").to(dt)
    return rnd(H), rnd(kv_heads or H), rnd(kv_heads or H), rnd(H)


def _flash_delta(do, o):
    """B18's (B, H, S) f32 operand delta = rowsum(dO * O)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def phase_flash_train() -> dict:
    """B14 and B18 against their plain versions on the same inputs: O and
    dq/dk/dv within 2e-2 (bf16: P and dS rounded on both sides, online vs
    whole-row softmax) or 1e-4 (f32), lse2 within 1e-4; B18 twice on the
    same inputs bit-equal (no atomics). The GQA case also runs the autograd
    op flash_attention_train on 4 KV heads against the plain versions with
    the group sums of dk/dv taken by hand."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (FlashTrainBwdKey, build_kernel,
                                         reference_kernel)
    from tpp_mlir_tpu_torch.xsmm.flash_train import flash_attention_train
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {"flash_train_fwd": 0.0, "flash_train_bwd": 0.0}
    for label, key, kvh in _flash_train_cases():
        tol = TOL_F32 if key.dtype == "f32" else 2 * TOL_BF16
        q, k, v, do = _flash_train_inputs(key, g, kvh)
        rep = key.heads // (kvh or key.heads)
        kr, vr = (x.repeat_interleave(rep, dim=2) for x in (k, v))
        o, lse2 = build_kernel(key)(q, kr, vr)
        po, plse2 = reference_kernel(key)(q, kr, vr)
        bkey = FlashTrainBwdKey(**dataclasses.asdict(key))
        args = (q, kr, vr, do, plse2, _flash_delta(do, po))
        bwd = build_kernel(bkey)
        got, again = bwd(*args), bwd(*args)
        want = reference_kernel(bkey)(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rels = {"o": rel_err(o, po), "lse2": rel_err(lse2, plse2)}
        rels.update({n: rel_err(a, b) for n, a, b in
                     zip(("dq", "dk", "dv"), got, want)})
        if kvh:     # the autograd op: repeat outside, group sums by autograd
            ql, kl, vl = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            flash_attention_train(ql, kl, vl, key.scale).backward(do)
            B, S, D = key.batch, key.seq, key.head_dim
            gsum = lambda x: x.float().reshape(B, S, kvh, rep, D).sum(3)
            rels.update({"op dq": rel_err(ql.grad, want[0]),
                         "op dk": rel_err(kl.grad, gsum(want[1])),
                         "op dv": rel_err(vl.grad, gsum(want[2]))})
        finite = all(torch_isfinite(x) for x in (o, lse2, *got))
        ok = same and finite and all(
            r <= (TOL_LSE if n == "lse2" else tol)
            for n, (r, _) in rels.items())
        say(f"kernel flash_train {label:38s} " + " ".join(
            f"{n} rel {r:.3e}" for n, (r, _) in rels.items())
            + f"; B18 repeat bit-equal {same}; tol {tol:.0e} (lse2 "
            f"{TOL_LSE:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_train {label}: {rels}, bit-equal "
                                 f"{same}, finite {finite}")
        worst["flash_train_fwd"] = max(worst["flash_train_fwd"],
                                       rels["o"][1], rels["lse2"][1])
        worst["flash_train_bwd"] = max(worst["flash_train_bwd"], *(
            rels[n][1] for n in ("dq", "dk", "dv")))
    return {kind: {"max_abs_err": e} for kind, e in worst.items()}


# the main path's modules: (label, tpp-gen flags, invoke the flagship needs)
MODULES = (
    ("flagship bf16", "--batch=256 --layers=1024,1024,1024,1024 --bias "
     "--relu --float-type=bf16", "xsmm.fused_chain"),
    ("flagship f32", "--batch=256 --layers=1024,1024,1024,1024 --bias "
     "--relu", "xsmm.fused_chain"),
    ("fc 256x1024x1024", "--batch=256 --layers=1024,1024 --bias --relu",
     "xsmm.fused_brgemm"),
    ("matmul 256x1024x1024", "--batch=256 --layers=1024,1024", "xsmm.gemm"),
)


_GENERATED: dict[str, str] = {}


def _module(flags: str):
    """`tpp-gen <flags> | tpp_run -`: the port's tpp-gen prints the module
    and the port parses its text."""
    from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser,
                                                   config_from_args,
                                                   generate_text)
    from tpp_mlir_tpu_torch.tools.tpp_run import load_module
    if flags not in _GENERATED:
        _GENERATED[flags] = generate_text(config_from_args(
            build_parser().parse_args(flags.split())))
    return load_module(_GENERATED[flags])


KINDS = {"BrgemmKey": "brgemm", "ChainKey": "chain",
         "FlashMhaKey": "attention", "LayerNormKey": "layer_norm",
         "DecodeAttnKey": "decode_attn", "Int8GemmKey": "int8_gemm",
         "FlashTrainKey": "flash_train_fwd",
         "FlashTrainBwdKey": "flash_train_bwd",
         "GroupedGemmKey": "grouped_gemm", "GroupedWgradKey": "grouped_wgrad",
         "BatchMatmulKey": "batch_matmul", "ConvNhwcKey": "conv_nhwc",
         "BlockedMatmulKey": "blocked_matmul", "ConvBrgemmKey": "conv_blocked"}
# kinds that share a key type with an earlier kernel: the MHA suite's, and
# B20, blocked_matmul.cu's warm bench
SHARED_KINDS = ("attention_flat", "attention_bench", "chain_pingpong",
             "blocked_matmul_warm")


def _kind(key) -> str | None:
    """The kernel a key launches, as the kernel line names it: the flat
    layout and the warm bench of attention.cu apart from its token layout,
    B5's ping-pong loop apart from chain.cu's others, strategy flash_heads
    under B14, and None for attention's and conv's strategy xla (no
    kernel)."""
    kind = KINDS[type(key).__name__]
    if kind == "conv_nhwc":
        from tpp_mlir_tpu_torch.xsmm.reference import conv_route
        return kind if conv_route(key) == "kernel" else None
    if kind == "attention":
        if key.strategy == "xla":
            return None
        if key.strategy == "flash_heads":
            return "flash_train_fwd"
        if key.repeats:
            return "attention_bench"
        if not key.heads:
            return "attention_flat"
    if kind == "chain" and key.pingpong and key.repeats > 1:
        return "chain_pingpong"
    if kind == "blocked_matmul" and key.repeats:
        return "blocked_matmul_warm"
    return kind


def _launches(cache) -> dict:
    out = dict.fromkeys((*KINDS.values(), *SHARED_KINDS), 0)
    for fn in cache.kernels():
        kind = _kind(fn.key)
        if kind:
            out[kind] += fn.launches
    return out


def phase_main_path() -> dict:
    """The MLP modules through run_module on the card, each held against
    --linalg-to-loops; the launch counts of this path alone."""
    from tpp_mlir_tpu_torch.tools.tpp_run import run_module
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    cache.reset_launches()
    runs = [(label, invoke, run_module(_module(flags), device="cuda",
                                       out_stream=sys.stderr))
            for label, flags, invoke in MODULES]
    launches = _launches(cache)
    for (label, invoke, res), (_, flags, _) in zip(runs, MODULES):
        ops = [op.opname for op in res["module"]["entry"].ops
               if op.opname.startswith("xsmm.")
               and not op.opname.endswith("_dispatch")]
        if ops != [invoke]:
            raise AssertionError(f"{label}: lowered to {ops}, expected "
                                 f"one {invoke}")
        ref = run_module(_module(flags), device="cuda", linalg_to_loops=True,
                         out_stream=sys.stderr)
        got, want = res["outputs"][0], ref["outputs"][0]
        rel, _ = rel_err(got, want)
        ok = tuple(got.shape) == tuple(want.shape) and rel <= TOL_BF16 \
            and torch_isfinite(got)
        say(f"main {label:22s} -> one {invoke:18s} shape "
            f"{tuple(got.shape)} vs --linalg-to-loops rel {rel:.3e} "
            f"tol {TOL_BF16:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel} vs --linalg-to-loops")
    say(f"main path (MLP) launches: brgemm {launches['brgemm']} "
        f"chain {launches['chain']}")
    if not (launches["brgemm"] and launches["chain"]):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return launches


# the transformer path: (label, bench_driver entry, lowered invokes the
# module must hold, kernels that must launch). "+ln" marks a fused_brgemm
# with the LayerNorm prologue.
TRANSFORMERS = (
    ("gpt2_small_s1024_bf16", GPT2,
     {"xsmm.attention": 12, "xsmm.fused_brgemm+ln": 24,
      "xsmm.fused_brgemm": 24, "xsmm.layer_norm": 1, "xsmm.gemm": 1,
      "xsmm.binary": 1}, ("attention", "layer_norm", "brgemm")),
    ("transformer_block_d128_fp32", ENCODER,
     {"xsmm.attention": 1, "xsmm.fused_brgemm+ln": 2,
      "xsmm.fused_brgemm": 2}, ("attention", "brgemm")),
)


def _invoke_counts(module) -> dict:
    ops = module["entry"].ops
    out: dict[str, int] = {}
    for op in ops:
        if not op.opname.startswith("xsmm.") or \
                op.opname.endswith("_dispatch"):
            continue
        name = op.opname
        if op.operands[0].owner.attrs.get("prologue") == "layer_norm":
            name += "+ln"
        out[name] = out.get(name, 0) + 1
    return out


def phase_transformer_path() -> dict:
    """GPT-2 small and the encoder block through the port's bench driver
    (build_module, then run_module on the card, lowered after the
    --linalg-to-loops run of the same module); each path's launch counts
    set to 0 just before it and read just after."""
    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    total: dict[str, int] = {}
    for label, entry, want_ops, kinds in TRANSFORMERS:
        t0 = time.perf_counter()
        cache.reset_launches()
        res = run_entry({"model": entry}, device="cuda",
                        out_stream=sys.stderr)
        launches = _launches(cache)
        ops = _invoke_counts(res["lowered"]["module"])
        got = res["lowered"]["outputs"][0]
        want = res["baseline"]["outputs"][0]
        rel, ab = rel_err(got, want)
        finite = torch_isfinite(got)
        ok = ops == want_ops and finite and rel <= TOL_MODEL and \
            tuple(got.shape) == tuple(want.shape) and \
            all(launches[k] for k in kinds)
        say(f"main {label}: lowered to {ops}; output "
            f"{tuple(got.shape)} {str(got.dtype)[6:]} finite {finite}, vs "
            f"--linalg-to-loops rel {rel:.3e} abs {ab:.3e} tol "
            f"{TOL_MODEL:.0e}; launches {launches} "
            f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: ops {ops} (want {want_ops}), "
                                 f"rel {rel}, finite {finite}, launches "
                                 f"{launches} (must move: {kinds})")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _serving_setup(kw: dict, llama: bool, quant: bool):
    """(cfg, params, ids) on the card: random weights and prompt ids from
    seed 0, as tools/tpp_serve.py makes them."""
    from tpp_mlir_tpu_torch.tools.tpp_serve import setup
    return setup(dict(kw, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
                      llama=llama, quant=quant), device="cuda")


def _kernels_off(cfg):
    """The same engine with no hand-written kernel: composed prefill
    attention, einsum decode attention, the int8 GEMM's plain version."""
    return dataclasses.replace(cfg, decode_attn="xla")


def _prefill_composed_attention(cfg, params, ids):
    """Prefill logits with the kernels on but the composed attention in
    B7's place."""
    from tpp_mlir_tpu_torch.serving import engine
    full = engine._attention_full
    engine._attention_full = lambda q, k, v, c, kernels: full(q, k, v, c,
                                                              False)
    try:
        return engine.make_prefill(cfg)(params, ids)[0]
    finally:
        engine._attention_full = full


def phase_serving_path() -> tuple[dict, list]:
    """The three serving configurations through make_generate on the card,
    each with the launch counts set to 0 just before its eager generate and
    read just after; then its CUDA-graph generate and the logits against
    the kernels-off engine (prefill, and teacher-forced decode over the
    kernel run's own tokens). Returns the launches and the setups."""
    import torch

    from tpp_mlir_tpu_torch.serving import (make_decode_step, make_generate,
                                            make_prefill)
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    total: dict[str, int] = {}
    setups = []
    for label, kw, llama, quant, steps in SERVING:
        t0 = time.perf_counter()
        cfg, params, ids = _serving_setup(kw, llama, quant)
        cache.reset_launches()
        toks = make_generate(cfg, steps, graph=False)(params, ids)
        torch.cuda.synchronize()
        launches = _launches(cache)
        want = {"attention": cfg.layers,
                "decode_attn": cfg.layers * (steps - 1),
                "int8_gemm": 6 * cfg.layers + 1 if cfg.int8_compute else 0}
        graphed = make_generate(cfg, steps)(params, ids)
        same = torch.equal(graphed, toks)
        off = _kernels_off(cfg)
        la, ca = make_prefill(cfg)(params, ids)
        lb, cb = make_prefill(off, use_kernels=False)(params, ids)
        finite = torch_isfinite(la)
        rel_p, _ = rel_err(la, lb)
        del la
        # the witness of B7's share: the kernels-on prefill with the
        # composed attention in its place differs from the kernels-off one
        # only by the other prefill kernel, B15 (0 without int8 compute)
        rel_w, _ = rel_err(_prefill_composed_attention(cfg, params, ids), lb)
        del lb
        step_a = make_decode_step(cfg)
        step_b = make_decode_step(off, use_kernels=False)
        rel_d, agree = 0.0, 0
        for t in range(steps - 1):
            la, ca = step_a(params, ca, toks[:, t])
            lb, cb = step_b(params, cb, toks[:, t])
            finite = finite and torch_isfinite(la)
            rel_d = max(rel_d, rel_err(la, lb)[0])
            agree += int((lb.argmax(-1).to(torch.int32)
                          == toks[:, t + 1]).sum())
        ok = (all(launches[k] == n for k, n in want.items()) and same
              and finite and max(rel_p, rel_w, rel_d) <= TOL_MODEL
              and tuple(toks.shape) == (SERVE_BATCH, steps))
        say(f"main {label}: generate {tuple(toks.shape)} (b{SERVE_BATCH} "
            f"prompt {SERVE_PROMPT}); eager launches {launches} (want "
            f"{want}); graph tokens == eager {same}; logits finite {finite}"
            f"; vs kernels off: prefill rel {rel_p:.3e} (composed attention"
            f" in B7's place {rel_w:.3e}), teacher-forced "
            f"decode rel {rel_d:.3e} (tol {TOL_MODEL:.0e}); greedy tokens "
            f"agreeing {agree / (SERVE_BATCH * (steps - 1)):.3f} (for "
            f"information) ({time.perf_counter() - t0:.1f} s) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: launches {launches} (want "
                                 f"{want}), graph == eager {same}, finite "
                                 f"{finite}, rel {rel_p} / {rel_w} / "
                                 f"{rel_d}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        setups.append((label, cfg, params, ids, steps))
        del ca, cb
    return total, setups


def phase_serving_timing(setups) -> None:
    """Per configuration, for the kernels and the kernels-off engine: the
    prefill (B 8 x 512, CUDA events), the decode step eager and replayed
    from a CUDA graph (32 steps from the prompt's end), tokens/s of the
    replayed decode; then a torch.profiler trace of 8 decode steps."""
    import torch

    from tpp_mlir_tpu_torch.serving import (DecodeRunner, make_decode_step,
                                            make_prefill)
    from tpp_mlir_tpu_torch.tools.trace import print_trace, trace_serving
    for label, cfg, params, ids, steps in setups:
        n = min(steps - 1, 32)
        for engine, c, uk in (("kernels", cfg, None),
                              ("kernels off", _kernels_off(cfg), False)):
            prefill, step = make_prefill(c, uk), make_decode_step(c, uk)
            p_ms = cuda_ms(lambda: prefill(params, ids), iters=3, warmup=1)
            logits, kv = prefill(params, ids)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            del logits
            eager = DecodeRunner(step, params, kv, tok, graph=False)
            e_ms = cuda_ms(lambda: eager.repeat(tok, n), iters=1,
                           warmup=1) / n
            eager.reset()
            replay = DecodeRunner(step, params, kv, tok, graph=True)
            g_ms = cuda_ms(lambda: replay.repeat(tok, n), iters=3,
                           warmup=1) / n
            say(f"time serve {label} {engine}: prefill b{SERVE_BATCH} "
                f"s{SERVE_PROMPT} {p_ms:.4f} ms "
                f"({SERVE_BATCH * SERVE_PROMPT / p_ms * 1e3:.1f} tokens/s); "
                f"decode eager {e_ms:.4f} ms/step, graph {g_ms:.4f} ms/step "
                f"({SERVE_BATCH / g_ms * 1e3:.1f} tokens/s)")
            del kv, eager, replay
        print_trace(trace_serving(cfg, params, ids, 8),
                    label=f"trace {label} ")


def _brgemm_launches(cache) -> tuple[int, int]:
    """(forward, dx) launches of the BrgemmKey wrappers: dx is transpose_b."""
    fwd = dx = 0
    for fn in cache.kernels():
        if type(fn.key).__name__ == "BrgemmKey":
            if fn.key.transpose_b:
                dx += fn.launches
            else:
                fwd += fn.launches
    return fwd, dx


def _mlp_flops(batch: int) -> int:
    """bench_train.py's count: fwd, dgrad and wgrad, 2MNK each per layer."""
    return 3 * sum(2 * batch * k * n for k, n in
                   zip(TRAIN_LAYERS[:-1], TRAIN_LAYERS[1:]))


def phase_mlp_training() -> dict:
    """The MLP SGD step (tpp_mlir_tpu_torch.parallel.make_train_step) at
    each of bench_train.py's rows: 3 steps with the kernels (B1 forward,
    B1 transpose_b for dx), launches counted, against 3 steps with
    use_kernels=False from the same params; then 20 timed steps of each."""
    import numpy as np
    import torch

    from tpp_mlir_tpu_torch.parallel import make_train_step, mlp_init
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    total = 0
    for batch, dtype, prec in TRAIN_MLP:
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
        params = mlp_init(TRAIN_LAYERS, dtype, seed=0)
        rng = np.random.default_rng(0)
        x, y = (torch.from_numpy(rng.standard_normal(
            (batch, WIDTH), dtype=np.float32)).to("cuda", dt)
            for _ in range(2))
        runs = {}
        for kernels in (True, False):
            step = make_train_step(TRAIN_LAYERS, use_kernels=kernels,
                                   precision=prec)
            cache.reset_launches()
            p, losses = params, []
            for _ in range(TRAIN_STEPS):
                p, loss = step(p, x, y)
                losses.append(loss.item())
            runs[kernels] = (p, losses, _brgemm_launches(cache))
        (pk, lk, (fwd, dx)), (pp, lp, off) = runs[True], runs[False]
        total += fwd + dx
        # the params as one vector: a bias starts at 0 and moves by lr * a
        # sum over the batch, so its own max is a poor scale for its error
        flat = lambda ps: torch.cat([t.float().reshape(-1) for wb in ps
                                     for t in wb])
        rel = rel_err(flat(pk), flat(pp))[0]
        tol = TOL_F32 if dtype == "f32" else TOL_BF16
        n_layers = len(TRAIN_LAYERS) - 1
        want = n_layers * TRAIN_STEPS
        finite = all(torch_isfinite(w) for wb in pk for w in wb)
        ok = rel <= tol and finite and fwd == dx == want and off == (0, 0)
        times = {}
        for kernels in (True, False):
            step = make_train_step(TRAIN_LAYERS, use_kernels=kernels,
                                   precision=prec)
            times[kernels] = cuda_ms(lambda: step(params, x, y))
        say(f"main train mlp b{batch} {dtype} {prec}: losses {lk} (kernels "
            f"off {lp}); all params after {TRAIN_STEPS} steps vs kernels "
            f"off rel {rel:.3e} tol {tol:.0e}; launches B1 forward {fwd}, dx "
            f"{dx} "
            f"(want {want} each; kernels off {off}); step {times[True]:.4f} "
            f"ms ({_mlp_flops(batch) / times[True] / 1e9:.2f} TFLOP/s), "
            f"kernels off {times[False]:.4f} ms "
            f"({_mlp_flops(batch) / times[False] / 1e9:.2f} TFLOP/s) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mlp train b{batch} {dtype}: rel {rel}, "
                                 f"finite {finite}, launches {fwd}/{dx}, "
                                 f"kernels off {off}")
    return {"brgemm": total}


def _leaf_names(tree, prefix="") -> list[str]:
    """Names of tree_leaves(tree), in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree)
                for n in _leaf_names(x, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _gpt_flops() -> int:
    """bench_train.py:152-158's count: 3x the forward's matmul flops, the
    attention squares included."""
    B, S, E, L, V = (TRAIN_B, TRAIN_S, GPT2_TRAIN["embed"],
                     GPT2_TRAIN["layers"], GPT2_TRAIN["vocab"])
    F = GPT2_TRAIN["mlp_ratio"] * E
    per_layer = (2 * B * S * E * 3 * E + 2 * 2 * B * S * S * E
                 + 2 * B * S * E * E + 2 * 2 * B * S * E * F)
    return 3 * (L * per_layer + 2 * B * S * E * V)


def phase_gpt_training() -> dict:
    """GPT-2 small's AdamW step (make_gpt_train_step, B 8, S 512, bf16) with
    B14/B18 and with the composed attention, from the same params and ids:
    the step-0 loss within 1e-2 of the CE of the port's prefill logits,
    every step-0 grad within 3e-2 (relative Frobenius) of the composed
    step's, the loss falling over 3 steps, 12 B14 and 12 B18 launches per
    step; then 10 timed steps of each after 2 warm-ups and a
    torch.profiler breakdown of 2 more."""
    import numpy as np
    import torch

    from tpp_mlir_tpu_torch.parallel import (adamw, make_gpt_train_step,
                                             next_token_loss, tree_leaves)
    from tpp_mlir_tpu_torch.serving import GptConfig, init_params, make_prefill
    from tpp_mlir_tpu_torch.tools.trace import print_trace, trace_steps
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    cfg = GptConfig(**GPT2_TRAIN)
    params0 = init_params(cfg, seed=0)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)).cuda()
    with torch.no_grad():
        ce = next_token_loss(make_prefill(cfg)(params0, ids)[0], ids).item()
    names = _leaf_names(params0)
    runs, launches = {}, {}
    for flash in (True, False):
        params = _clone(params0)
        step, init = make_gpt_train_step(cfg, adamw(1e-3), flash_attn=flash)
        state = init(params)
        cache.reset_launches()
        losses = []
        for i in range(TRAIN_STEPS):
            params, state, loss = step(params, state, ids)
            losses.append(loss.item())
            if i == 0:
                grads = [t.grad.clone() for t in tree_leaves(params)]
        launches[flash] = _launches(cache)
        ms = cuda_ms(lambda: step(params, state, ids), iters=TIMED_STEPS,
                     warmup=2)
        print_trace(trace_steps(lambda: step(params, state, ids)),
                    label=f"trace train gpt2 small "
                          f"{'B14/B18' if flash else 'composed'} ")
        runs[flash] = (losses, grads, ms)
        del params, state
    (lf, gf, msf), (lc, gc, msc) = runs[True], runs[False]
    # bk's true gradient is 0 (softmax is invariant to a shift of every
    # key by one vector), so its grad is rounding noise on both sides and
    # has no relative error to hold
    errs = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
            for n, a, b in zip(names, gf, gc) if not n.endswith(".bk")}
    worst = max(errs, key=errs.get)
    per_step = {k: launches[True][k] / TRAIN_STEPS
                for k in ("flash_train_fwd", "flash_train_bwd")}
    off = (launches[False]["flash_train_fwd"],
           launches[False]["flash_train_bwd"])
    finite = all(torch_isfinite(g) for g in gf)
    ok = (max(abs(lf[0] - ce), abs(lc[0] - ce)) <= TOL_BF16
          and errs[worst] <= TOL_GRAD and lf[-1] < lf[0] and lc[-1] < lc[0]
          and per_step == {"flash_train_fwd": cfg.layers,
                           "flash_train_bwd": cfg.layers}
          and off == (0, 0) and finite)
    flops, tokens = _gpt_flops(), TRAIN_B * TRAIN_S
    say(f"main train gpt2 small b{TRAIN_B} s{TRAIN_S} bf16 adamw: losses "
        f"B14/B18 {lf}, composed {lc}; prefill CE {ce:.6f} (step-0 tol "
        f"{TOL_BF16:.0e}); step-0 grads rel Frobenius max {errs[worst]:.3e} "
        f"({worst}) tol {TOL_GRAD:.0e} over {len(errs)} leaves (bk "
        f"excluded); launches per step {per_step} (composed run: {off}) "
        f"{'ok' if ok else 'FAIL'}")
    for label, ms in (("B14/B18", msf), ("composed attention", msc)):
        say(f"time train gpt2 small {label}: {ms:.4f} ms/step over "
            f"{TIMED_STEPS} steps, {tokens / ms * 1e3:.1f} tokens/s, "
            f"{flops / ms / 1e9:.2f} TFLOP/s ({flops / 1e12:.4f} TFLOP a "
            f"step)")
    if not ok:
        raise AssertionError(f"gpt2 train: losses {lf} / {lc} vs CE {ce}, "
                             f"grad {worst} {errs[worst]}, launches "
                             f"{per_step} / {off}, finite {finite}")
    return {k: launches[True][k] for k in ("flash_train_fwd",
                                           "flash_train_bwd")}


def phase_serving_flash(setup) -> dict:
    """gpt2_small_serve_b8's prefill with GptConfig.flash_attn: B14's
    forward in each layer (12 launches), logits against the kernels-off
    engine (B14's plain version) within the model tolerance."""
    import torch

    from tpp_mlir_tpu_torch.serving import make_prefill
    from tpp_mlir_tpu_torch.xsmm import global_cache
    label, cfg, params, ids, _ = setup
    fcfg = dataclasses.replace(cfg, flash_attn=True)
    cache = global_cache()
    cache.reset_launches()
    got = make_prefill(fcfg, use_kernels=True)(params, ids)[0]
    torch.cuda.synchronize()
    launches = _launches(cache)
    want = make_prefill(_kernels_off(fcfg), use_kernels=False)(params, ids)[0]
    rel, _ = rel_err(got, want)
    finite = torch_isfinite(got)
    ok = launches["flash_train_fwd"] == cfg.layers and \
        launches["attention"] == 0 and rel <= TOL_MODEL and finite
    say(f"main {label} flash_attn prefill: launches {launches} (want "
        f"flash_train_fwd {cfg.layers}, attention 0); logits finite "
        f"{finite}, vs kernels off rel {rel:.3e} tol {TOL_MODEL:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} flash prefill: launches {launches}, "
                             f"rel {rel}, finite {finite}")
    return launches


# the MoE slice: GPT-2 small MoE-8 top-2 at full width, bm 128, bf16;
# serving as scripts/bench_serving.py:148-158 runs it with --experts 8
# --top-k-experts 2 --moe-prefill grouped (max_seq 640, b8, prompt 512),
# training as scripts/exp_moe_train.py:89-95 (B 8, S 512, AdamW 1e-3)
MOE = dict(n_experts=8, top_k=2, moe_group_bm=128,
           moe_prefill_form="grouped")
MOE_SERVE = dict(GPT2_SERVE, max_seq=640, **MOE)
MOE_STEPS, MOE_B1_STEPS = 32, 8
MOE_TRAIN = dict(GPT2_TRAIN, **MOE)
MOE_TIMED_STEPS = 5


def _moe_routing(g, T, n_e, bm, skew=False):
    """The engine's dispatch maps of a top-2 routing of T tokens from
    random logits; skewed: expert 0 favoured and expert n_e - 1 chosen by
    no token (it keeps only its padding block)."""
    import torch

    from tpp_mlir_tpu_torch.serving.engine import _grouped_dispatch
    logits = torch.randn(T, n_e, generator=g, device="cuda")
    if skew:
        logits[:, 0] += 2.0
        logits[:, n_e - 1] -= 100.0
    return _grouped_dispatch(logits.topk(2, -1).indices, T, n_e, bm, 2)


# B16 at the slice's keys: (label, tokens T, bm, n, k, key fields, skewed
# routing). T 4096 is the b8 x 512 serving prefill and the training step,
# so A_pad = (8192 / 128 + 8) * 128 = 9216 rows
_B16 = dict(dtype="bf16")
GROUPED_GEMM_CASES = (
    ("fc1 9216x3072x768 gelu bf16", 4096, 128, 3072, 768,
     dict(_B16, unary_kind="gelu"), False),
    ("fc2 9216x768x3072 bf16", 4096, 128, 768, 3072, _B16, False),
    ("train z1 9216x3072x768 f32 out", 4096, 128, 3072, 768,
     dict(_B16, out_dtype="f32"), False),
    ("train da tb 9216x3072x768 f32 out", 4096, 128, 3072, 768,
     dict(_B16, out_dtype="f32", transpose_b=True), False),
    ("train dxs tb 9216x768x3072 f32 out", 4096, 128, 768, 3072,
     dict(_B16, out_dtype="f32", transpose_b=True), False),
    ("small bm 16 2128x768x256", 1000, 16, 768, 256, _B16, False),
    ("layers 3 bm 64 1536x3072x768 gelu", 512, 64, 3072, 768,
     dict(_B16, unary_kind="gelu", layers=3), False),
    ("skewed fc1 9216x3072x768 gelu", 4096, 128, 3072, 768,
     dict(_B16, unary_kind="gelu"), True),
)
# B17: (label, T, bm, k, n, skewed): dw2 (a^T dys) and dw1 (xs^T dz1)
GROUPED_WGRAD_CASES = (
    ("dw2 k3072 n768 over 9216", 4096, 128, 3072, 768, False),
    ("dw1 k768 n3072 over 9216", 4096, 128, 768, 3072, False),
    ("skewed dw1 k768 n3072", 4096, 128, 768, 3072, True),
)


def _grouped_gemm_inputs(g, T, bm, n, k, fields, skew):
    """(key, args, padding-row mask): the tokens' rows gathered into the
    padded slot order as the engine makes xs, weights ~ N(0, 1/k)."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import GroupedGemmKey
    d = _moe_routing(g, T, 8, bm, skew)
    key = GroupedGemmKey(n_groups=8, m=d["A_pad"], n=n, k=k, bm=bm,
                         **fields)
    h = torch.randn(T, k, generator=g, device="cuda").bfloat16()
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    shape = (n, k) if key.transpose_b else (k, n)
    lead = (key.layers,) if key.layers else ()
    w = (torch.randn(*lead, 8, *shape, generator=g, device="cuda")
         * k ** -0.5).bfloat16()
    args = ((1,) if key.layers else ()) + (d["ge"], xs, w)
    return key, args, d["tt"] == T


def _grouped_wgrad_inputs(g, T, bm, k, n, skew):
    """(key, args, experts no token chose): xt the transpose of the
    (A_pad, k) slot rows, read in place as the training backward passes
    it, and dY with zero padding rows."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import GroupedWgradKey
    d = _moe_routing(g, T, 8, bm, skew)
    key = GroupedWgradKey(n_groups=8, m=d["A_pad"], k=k, n=n, bm=bm,
                          dtype="bf16")
    h = torch.randn(T, k, generator=g, device="cuda").bfloat16()
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    dy = torch.randn(d["A_pad"], n, generator=g, device="cuda")
    live = d["tt"] < T
    dy = (dy * live[:, None]).bfloat16()
    chosen = set(d["ge"][live.reshape(-1, bm).any(1)].tolist())
    return key, (d["ge"], xs.t(), dy), sorted(set(range(8)) - chosen)


def phase_grouped_kernels() -> dict:
    """B16 and B17 against their plain versions at the MoE slice's keys:
    1e-2 for a bf16 output, 1e-4 for an f32 one (the same operand rounding
    on both sides: sum order only); padding rows of B16 exactly zero; B17
    twice on the same inputs bit-equal, and the dW of an expert no token
    chose exactly zero."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    g = torch.Generator(device="cuda").manual_seed(3)
    worst = {"grouped_gemm": 0.0, "grouped_wgrad": 0.0}
    for label, T, bm, n, k, fields, skew in GROUPED_GEMM_CASES:
        key, args, pad = _grouped_gemm_inputs(g, T, bm, n, k, fields, skew)
        got = build_kernel(key)(*args)
        ref = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        tol = TOL_F32 if key.out_dtype == "f32" else TOL_BF16
        zero = not got[pad].any().item()
        ok = rel <= tol and zero and torch_isfinite(got)
        say(f"kernel grouped_gemm {label:38s} rel {rel:.3e} abs {ab:.3e} "
            f"tol {tol:.0e}; {int(pad.sum())} padding rows zero {zero} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grouped_gemm {label}: rel {rel}, "
                                 f"padding zero {zero}")
        worst["grouped_gemm"] = max(worst["grouped_gemm"], ab)
    for label, T, bm, k, n, skew in GROUPED_WGRAD_CASES:
        key, args, untouched = _grouped_wgrad_inputs(g, T, bm, k, n, skew)
        kern = build_kernel(key)
        got, again = kern(*args), kern(*args)
        ref = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        same = torch.equal(got, again)
        zero = not got[untouched].any().item()
        ok = rel <= TOL_F32 and same and zero and torch_isfinite(got) \
            and bool(untouched) == skew
        say(f"kernel grouped_wgrad {label:37s} rel {rel:.3e} abs {ab:.3e} "
            f"tol {TOL_F32:.0e}; repeat bit-equal {same}; experts no token "
            f"chose {untouched} zero {zero} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grouped_wgrad {label}: rel {rel}, "
                                 f"bit-equal {same}, untouched {untouched} "
                                 f"zero {zero}")
        worst["grouped_wgrad"] = max(worst["grouped_wgrad"], ab)
    return {kind: {"max_abs_err": e} for kind, e in worst.items()}


def _route(run, pin=None):
    """(run(), the top-2 expert ids the engine's router chose in each of its
    calls, in call order). With `pin` (such a list), each call takes the
    next pinned selection instead, with gates from its own logits there:
    two runs then differ by their numerics alone, not by a token whose
    experts flip at a near-tie."""
    import torch

    from tpp_mlir_tpu_torch.serving import engine
    router, seen = engine._moe_gates, []
    pinned = None if pin is None else iter(pin)

    def spy(h, wr, top_k, mm=None):
        if pinned is None:
            gates, idx = router(h, wr, top_k, mm)
        else:
            idx = next(pinned)
            logits = (mm or engine._mm)(h, wr)
            gates = torch.softmax(logits.gather(-1, idx), dim=-1)
        seen.append(idx)
        return gates, idx
    engine._moe_gates = spy
    try:
        return run(), seen
    finally:
        engine._moe_gates = router


def _flip_share(a, b) -> float:
    """The share of tokens whose top-k expert sets differ."""
    return float((a.sort(-1).values != b.sort(-1).values).any(-1)
                 .float().mean())


def phase_moe_serving() -> tuple[dict, tuple]:
    """gpt2_small_moe8_serve_b8 through make_generate at b8 (32 greedy
    steps: the scan decode form, as the auto policy picks at b8) and b1
    (8 steps: the slice form). Per batch: the launch counts of an eager
    generate (B16 24 = fc1 + fc2 in 12 layers, B7 12, B13 12 a step), the
    CUDA-graph generate's tokens equal to its, and the prefill and
    teacher-forced decode logits against the kernels-off engine (the
    grouped form's plain version, composed attention, einsum decode
    attention) within the model tolerance, the kernels-off run's router
    pinned to the kernels-on run's choices; the share of tokens whose
    top-2 experts differ when it is not pinned is printed per layer."""
    import torch

    from tpp_mlir_tpu_torch.serving import (make_decode_step, make_generate,
                                            make_prefill)
    from tpp_mlir_tpu_torch.serving.engine import moe_decode_form
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    cfg, params, ids = _serving_setup(MOE_SERVE, False, False)
    off = _kernels_off(cfg)
    total: dict[str, int] = {}
    for batch, steps in ((SERVE_BATCH, MOE_STEPS), (1, MOE_B1_STEPS)):
        t0 = time.perf_counter()
        bids = ids[:batch]
        cache.reset_launches()
        toks = make_generate(cfg, steps, graph=False)(params, bids)
        torch.cuda.synchronize()
        launches = _launches(cache)
        want = {"grouped_gemm": 2 * cfg.layers, "attention": cfg.layers,
                "decode_attn": cfg.layers * (steps - 1)}
        same = torch.equal(make_generate(cfg, steps)(params, bids), toks)
        prefill_a = make_prefill(cfg)
        prefill_b = make_prefill(off, use_kernels=False)
        (la, ca), ra = _route(lambda: prefill_a(params, bids))
        (lf, _), rf = _route(lambda: prefill_b(params, bids))
        flips = [round(_flip_share(a, b), 5) for a, b in zip(ra, rf)]
        rel_free = rel_err(la, lf)[0]
        del lf
        (lb, cb), _ = _route(lambda: prefill_b(params, bids), pin=ra)
        rel_p, finite = rel_err(la, lb)[0], torch_isfinite(la)
        del la, lb
        step_a = make_decode_step(cfg)
        step_b = make_decode_step(off, use_kernels=False)
        rel_d = 0.0
        for t in range(steps - 1):
            (la, ca), r = _route(lambda: step_a(params, ca, toks[:, t]))
            (lb, cb), _ = _route(lambda: step_b(params, cb, toks[:, t]),
                                 pin=r)
            finite = finite and torch_isfinite(la)
            rel_d = max(rel_d, rel_err(la, lb)[0])
        ok = (all(launches[k] == n for k, n in want.items()) and same
              and finite and max(rel_p, rel_d) <= TOL_MODEL
              and tuple(toks.shape) == (batch, steps))
        say(f"main gpt2_small_moe8_serve_b{batch}: generate "
            f"{tuple(toks.shape)} (prompt {SERVE_PROMPT}, grouped prefill "
            f"bm {cfg.moe_group_bm}, decode form "
            f"{moe_decode_form(cfg, batch)}); eager launches {launches} "
            f"(want {want}); graph tokens == eager {same}; logits finite "
            f"{finite}; vs kernels off, routing pinned: prefill rel "
            f"{rel_p:.3e}, teacher-forced decode rel {rel_d:.3e} (tol "
            f"{TOL_MODEL:.0e}); unpinned: prefill rel {rel_free:.3e}, "
            f"routing-flip share by layer {flips} "
            f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"moe serve b{batch}: launches {launches} "
                                 f"(want {want}), graph == eager {same}, "
                                 f"finite {finite}, rel {rel_p} / {rel_d}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del ca, cb
    return total, (cfg, params, ids)


def phase_moe_serving_timing(setup) -> None:
    """gpt2_small_moe8_serve_b8's prefill (b8 x 512, CUDA events) in the
    grouped (B16), sorted and scan forms, and the grouped form with the
    kernels off; the decode step replayed from a CUDA graph (16 steps from
    the prompt's end) in each decode form at b8 and b1, beside the form the
    auto policy picks; then a torch.profiler trace of the grouped prefill
    and 8 decode steps."""
    import torch

    from tpp_mlir_tpu_torch.serving import (DecodeRunner, make_decode_step,
                                            make_prefill)
    from tpp_mlir_tpu_torch.serving.engine import moe_decode_form
    from tpp_mlir_tpu_torch.tools.trace import print_trace, trace_serving
    cfg, params, ids = setup
    tokens = SERVE_BATCH * SERVE_PROMPT
    for form, uk in (("grouped", None), ("sorted", None), ("scan", None),
                     ("grouped", False)):
        c = dataclasses.replace(cfg, moe_prefill_form=form)
        if uk is False:
            c = _kernels_off(c)
        prefill = make_prefill(c, uk)
        ms = cuda_ms(lambda: prefill(params, ids), iters=3, warmup=1)
        say(f"time serve gpt2_small_moe8 prefill b{SERVE_BATCH} "
            f"s{SERVE_PROMPT} {form}{' kernels off' if uk is False else ''}:"
            f" {ms:.4f} ms ({tokens / ms * 1e3:.1f} tokens/s)")
    n = 16
    for batch in (SERVE_BATCH, 1):
        bids = ids[:batch]
        auto = moe_decode_form(cfg, batch)
        for form in (("slice", "gather", "scan") if batch == 1
                     else ("gather", "scan")):
            c = dataclasses.replace(cfg, moe_decode_form=form)
            logits, kv = make_prefill(c)(params, bids)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            del logits
            replay = DecodeRunner(make_decode_step(c), params, kv, tok,
                                  graph=True)
            ms = cuda_ms(lambda: replay.repeat(tok, n), iters=3,
                         warmup=1) / n
            say(f"time serve gpt2_small_moe8 decode b{batch} {form}"
                f"{' (auto)' if form == auto else ''}: graph {ms:.4f} "
                f"ms/step ({batch / ms * 1e3:.1f} tokens/s)")
            del kv, replay
    print_trace(trace_serving(cfg, params, ids, 8),
                label="trace gpt2_small_moe8_serve_b8 ")


def _moe_flops() -> int:
    """scripts/exp_moe_train.py:106-108's count: 3x the forward's matmul
    flops with the top-2 experts' FFNs (not all 8), attention squares
    included."""
    B, S, E, L, V = (TRAIN_B, TRAIN_S, MOE_TRAIN["embed"],
                     MOE_TRAIN["layers"], MOE_TRAIN["vocab"])
    F, k, H, T = MOE_TRAIN["mlp_ratio"] * E, MOE_TRAIN["top_k"], \
        MOE_TRAIN["heads"], TRAIN_B * TRAIN_S
    blk = (4 * 2 * T * E * E + k * (2 * 2 * T * E * F)
           + 2 * 2 * B * H * S * S * (E // H))
    return 3 * (L * blk + 2 * T * E * V)


def phase_moe_training() -> dict:
    """gpt2_small_moe8_train_b8_s512_bf16: make_gpt_train_step (AdamW 1e-3,
    B14/B18 attention) in the grouped form (B16 forward and dgrad, B17) and
    in the scan form (PyTorch GEMMs), from the same params and ids: the
    grouped step's step-0 loss within 1e-2 of the grouped prefill's CE,
    its step-0 grads within 3e-2 (relative Frobenius, bk excluded) of the
    scan step's, whose step 0 runs at the grouped step's routing (see
    _route); falling losses over 3 steps, 48 B16 and 24 B17 launches a
    step (none in the scan step); then 5 timed steps of each, the peak
    memory, and a torch.profiler breakdown of the grouped step."""
    import numpy as np
    import torch

    from tpp_mlir_tpu_torch.parallel import (adamw, make_gpt_train_step,
                                             next_token_loss, tree_leaves)
    from tpp_mlir_tpu_torch.serving import GptConfig, init_params, make_prefill
    from tpp_mlir_tpu_torch.tools.trace import print_trace, trace_steps
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    cfg = GptConfig(**MOE_TRAIN)
    params0 = init_params(cfg, seed=0)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)).cuda()
    with torch.no_grad():
        ce = next_token_loss(make_prefill(cfg)(params0, ids)[0], ids).item()
    names = _leaf_names(params0)
    runs, launches, routes = {}, {}, None
    for form in ("grouped", "scan"):
        params = _clone(params0)
        step, init = make_gpt_train_step(
            dataclasses.replace(cfg, moe_prefill_form=form), adamw(1e-3))
        state = init(params)
        torch.cuda.reset_peak_memory_stats()
        cache.reset_launches()
        losses = []
        for i in range(TRAIN_STEPS):
            if i == 0:      # the scan step at the grouped step's routing
                (params, state, loss), routes = _route(
                    lambda: step(params, state, ids), pin=routes)
                grads = [t.grad.clone() for t in tree_leaves(params)]
            else:
                params, state, loss = step(params, state, ids)
            losses.append(loss.item())
        launches[form] = _launches(cache)
        ms = cuda_ms(lambda: step(params, state, ids),
                     iters=MOE_TIMED_STEPS, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if form == "grouped":
            print_trace(trace_steps(lambda: step(params, state, ids)),
                        label="trace train gpt2_small_moe8 grouped ")
        runs[form] = (losses, grads, ms, peak)
        del params, state, grads
    (lg, gg, msg, pkg), (ls, gs, mss, pks) = runs["grouped"], runs["scan"]
    errs = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
            for n, a, b in zip(names, gg, gs) if not n.endswith(".bk")}
    worst = max(errs, key=errs.get)
    per_step = {k: launches["grouped"][k] / TRAIN_STEPS
                for k in ("grouped_gemm", "grouped_wgrad", "flash_train_fwd",
                          "flash_train_bwd")}
    want = {"grouped_gemm": 4 * cfg.layers, "grouped_wgrad": 2 * cfg.layers,
            "flash_train_fwd": cfg.layers, "flash_train_bwd": cfg.layers}
    off = (launches["scan"]["grouped_gemm"], launches["scan"]["grouped_wgrad"])
    finite = all(torch_isfinite(g) for g in gg)
    ok = (abs(lg[0] - ce) <= TOL_BF16 and errs[worst] <= TOL_GRAD
          and lg[-1] < lg[0] and ls[-1] < ls[0] and per_step == want
          and off == (0, 0) and finite)
    flops, tokens = _moe_flops(), TRAIN_B * TRAIN_S
    say(f"main train gpt2_small_moe8 b{TRAIN_B} s{TRAIN_S} bf16 adamw: "
        f"losses grouped {lg}, scan {ls}; grouped prefill CE {ce:.6f} "
        f"(step-0 tol {TOL_BF16:.0e}); step-0 grads rel Frobenius max "
        f"{errs[worst]:.3e} ({worst}) tol {TOL_GRAD:.0e} over {len(errs)} "
        f"leaves; launches per step {per_step} (scan run B16/B17: {off}) "
        f"{'ok' if ok else 'FAIL'}")
    for label, ms, peak in (("grouped (B16/B17)", msg, pkg),
                            ("scan", mss, pks)):
        say(f"time train gpt2_small_moe8 {label}: {ms:.4f} ms/step over "
            f"{MOE_TIMED_STEPS} steps, {tokens / ms * 1e3:.1f} tokens/s, "
            f"{flops / ms / 1e9:.2f} TFLOP/s ({flops / 1e12:.4f} TFLOP a "
            f"step, top-2 experts); peak memory {peak:.2f} GiB")
    if not ok:
        raise AssertionError(f"moe train: losses {lg} / {ls} vs CE {ce}, "
                             f"grad {worst} {errs[worst]}, launches "
                             f"{per_step} / {off}, finite {finite}")
    return {k: n + launches["scan"][k] for k, n in launches["grouped"].items()}


# the MHA suite (benchmarks/configs/mha.json): the rows the bench driver
# runs, at their own sizes, with their bench_mode
MHA_SUITE = (
    {"name": "mha_qk_fp32", "model": 'mha_qk:{"batch": 64, "heads": 16, '
     '"seq": 32, "head_dim": 64}'},
    {"name": "mha_softmax_v_fp32", "model": 'mha_softmax_v:{"batch": 64, '
     '"heads": 16, "seq": 32, "head_dim": 64}'},
    {"name": "mha_projection_fp32", "model": 'mha_projection:{"batch": 64, '
     '"seq": 32, "model_dim": 1024}'},
    {"name": "mha_block_seq32_fp32", "model": 'mha_block:{"batch": 8, '
     '"heads": 16, "seq": 32, "head_dim": 64}'},
    {"name": "mha_full_fp32", "model": 'mha_full:{"batch": 16, "heads": 16, '
     '"seq": 256, "head_dim": 64}'},
    {"name": "flash_attention_fp32_s1024", "model": 'mha_full:{"batch": 4, '
     '"heads": 8, "seq": 1024, "head_dim": 64, "fused": true, '
     '"scale": 0.125}'},
    {"name": "flash_attention_causal_fp32_s1024", "model": 'mha_full:'
     '{"batch": 4, "heads": 8, "seq": 1024, "head_dim": 64, "causal": true, '
     '"scale": 0.125}'},
    {"name": "flash_attention_bf16_s2048", "model": 'mha_full:{"batch": 2, '
     '"heads": 8, "seq": 2048, "head_dim": 64, "fused": true, "dtype": '
     '"bf16", "scale": 0.125}'},
    {"name": "flash_attention_causal_bf16_s2048", "model": 'mha_full:'
     '{"batch": 2, "heads": 8, "seq": 2048, "head_dim": 64, "causal": true, '
     '"dtype": "bf16", "scale": 0.125}', "bench_mode": "scan"},
    {"name": "flash_attention_fp32_s1024_d128", "model": 'mha_full:'
     '{"batch": 4, "heads": 8, "seq": 1024, "head_dim": 128, "fused": true, '
     '"scale": 0.0883883}'},
    {"name": "flash_attention_bf16_s1024_d128", "model": 'mha_full:'
     '{"batch": 4, "heads": 8, "seq": 1024, "head_dim": 128, "fused": true, '
     '"dtype": "bf16", "scale": 0.0883883}'},
    {"name": "flash_attention_bf16_s2048_d128", "model": 'mha_full:'
     '{"batch": 2, "heads": 8, "seq": 2048, "head_dim": 128, "fused": true, '
     '"dtype": "bf16", "scale": 0.0883883}'},
    {"name": "flash_attention_causal_bf16_s2048_d128", "model": 'mha_full:'
     '{"batch": 2, "heads": 8, "seq": 2048, "head_dim": 128, "causal": '
     'true, "dtype": "bf16", "scale": 0.0883883}', "bench_mode": "scan"},
)
MHA_N = 20          # -n of the suite's timed runs
# two f32 rows have unscaled logits (mha_full_fp32: scale 1 at D 64;
# mha_block: N(0, 1) weights at E 1024), where f32 "default"'s bf16 operand
# rounding flips near-ties of a saturated softmax (2.2e-1 and 3.6e-2 from
# the f32 oracle in the port's plain versions on the CPU): they are held
# against --linalg-to-loops at precision "highest" instead
MHA_HIGHEST = ("mha_full_fp32", "mha_block_seq32_fp32")
TOL_MHA_HIGHEST = 1e-3  # f32 FMA kernels vs the f32 oracle: sum order only
# fc.json's non-square rows of the ping-pong bench, through tpp-run -n 100
FC_ROWS = (("fc_128x768x2304", "--batch=128 --layers=768,2304 --bias "
            "--relu"),
           ("fc_128x3072x768", "--batch=128 --layers=3072,768 --bias "
            "--relu"))


def _mha_key(name: str, **kw):
    """The flat FlashMhaKey that attention-fusion and convert-tl-to-xsmm
    make of a MHA_SUITE mha_full row (B*H, S, D), with overrides."""
    from tpp_mlir_tpu_torch.xsmm import FlashMhaKey
    model = json.loads(next(e["model"] for e in MHA_SUITE
                            if e["name"] == name).split(":", 1)[1])
    key = FlashMhaKey(batch=model["batch"] * model["heads"],
                      seq=model["seq"], seq_kv=model["seq"],
                      head_dim=model["head_dim"],
                      dtype=model.get("dtype", "f32"),
                      scale=model.get("scale", 1.0),
                      causal=model.get("causal", False))
    return dataclasses.replace(key, **kw)


def _mha_kernel_cases():
    """(label, key) of the MHA suite's kernels at the suite's keys."""
    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, ChainKey,
                                         FlashMhaKey)
    flash = [e["name"] for e in MHA_SUITE if e["name"].startswith(
        ("flash_attention", "mha_full"))]
    cases = [(f"flat {n}", _mha_key(n)) for n in flash]
    causal = "flash_attention_causal_bf16_s2048"
    cases += [(f"flat forced {st} {n}", _mha_key(n, strategy=st))
              for st, n in (("grouped", "flash_attention_fp32_s1024"),
                            ("qblock", "flash_attention_bf16_s2048"),
                            ("twocall", causal), ("twocall2", causal))]
    cases.append(("flat blocked (B6) bq/bk 256 s1024",
                  _mha_key("flash_attention_fp32_s1024", bq=256, bk=256)))
    serve = FlashMhaKey(8, 512, 512, 64, "bf16", scale=0.125, causal=True,
                        heads=12)
    cases += [("tokens forced flash_heads serve b8 s512",
               dataclasses.replace(serve, strategy="flash_heads")),
              ("tokens forced xla serve b8 s512",
               dataclasses.replace(serve, strategy="xla"))]
    cases += [("bench r3 flash_attention_bf16_s1024_d128",
               _mha_key("flash_attention_bf16_s1024_d128", repeats=3)),
              ("bench r3 flash_attention_causal_fp32_s1024",
               _mha_key("flash_attention_causal_fp32_s1024", repeats=3)),
              ("bench r2 tokens serve b8 s512 causal",
               dataclasses.replace(serve, repeats=2))]
    cases += [
        ("bmm mha_qk 1024x32x32x64 f32", BatchMatmulKey(
            1024, 32, 32, 64, "f32", beta0=True)),
        ("bmm mha_softmax_v 1024x32x64x32 f32", BatchMatmulKey(
            1024, 32, 64, 32, "f32", beta0=True, softmax_lhs=True)),
        ("bmm lhs_shared 64x256x196x128 bf16", BatchMatmulKey(
            64, 256, 196, 128, "bf16", beta0=True, lhs_shared=True)),
        ("bmm +C 16x256x256x512 f32 highest", BatchMatmulKey(
            16, 256, 256, 512, "f32", precision="highest"))]
    cases += [(f"pingpong fc_128x768x2304 repeats={r}", ChainKey(
        m=128, dims=(768, 2304), repeats=r, pingpong=True))
              for r in (2, 3)]
    return cases


def _mha_inputs(key, g):
    """Operands of a suite key: flat (B*H, S, D) q/k/v, token ones as
    _attention_inputs makes them; the batched matmul's A (x2, so the
    softmax is not flat), B and C; the fc's x, W ~ N(0, 1/k) and bias."""
    import torch
    from tpp_mlir_tpu_torch.xsmm import BatchMatmulKey, ChainKey
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dt)
    if isinstance(key, ChainKey):
        return _chain_inputs(key, g)
    if isinstance(key, BatchMatmulKey):
        a = rnd(*((key.m, key.k) if key.lhs_shared
                  else (key.batch, key.m, key.k)), scale=2.0)
        c = None if key.beta0 else rnd(key.batch, key.m, key.n).float()
        return a, rnd(key.batch, key.k, key.n), c
    if key.heads:
        return _attention_inputs(key, g)
    return tuple(rnd(key.batch, s, key.head_dim)
                 for s in (key.seq, key.seq_kv, key.seq_kv))


def phase_mha_kernels() -> dict:
    """The MHA suite's kernels against their plain versions on the same
    inputs: flat attention (one kernel for B6, B8, B9, B10a, B10b) at each
    flash_attention key and mha_full's and under each forced strategy,
    B14 and the composed attention under the token strategies flash_heads
    and xla, B11's repeats loop, the batched matmul (B21/B22) and B5."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(3)
    stats = {}
    for label, key in _mha_kernel_cases():
        args = _mha_inputs(key, g)
        kern = build_kernel(key)
        got = kern(*args)
        ref = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        tol = _tol(key)
        kind = _kind(key)
        ok = rel <= tol and torch_isfinite(got) and \
            kern.launches == (1 if kind else 0)
        say(f"kernel {kind or 'no kernel':16s} {label:44s} rel {rel:.3e} "
            f"abs {ab:.3e} tol {tol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel} > {tol} or launches "
                                 f"{kern.launches}")
        if kind:
            prev = stats.get(kind, {}).get("max_abs_err", 0.0)
            stats[kind] = {"max_abs_err": max(prev, ab)}
    return stats


def _mha_want(entry: dict):
    """(lowered invokes, kernels that must launch, bench lowering) of a
    MHA_SUITE row."""
    scan = entry.get("bench_mode") == "scan"
    name = entry["model"].split(":")[0]
    return {
        "mha_qk": ({"xsmm.unary": 1, "xsmm.batch_gemm": 1},
                   ("batch_matmul",), "loop"),
        "mha_softmax_v": ({"xsmm.batch_gemm": 1}, ("batch_matmul",),
                          "loop"),
        "mha_projection": ({"xsmm.gemm": 1}, ("brgemm", "chain"),
                           "in-kernel B4 (chain.cu repeats)"),
        "mha_block": ({"xsmm.gemm": 4, "xsmm.attention": 1},
                      ("brgemm", "attention"), "loop"),
        "mha_full": ({"xsmm.attention": 1},
                     ("attention_flat",) if scan else
                     ("attention_flat", "attention_bench"),
                     "loop" if scan else
                     "in-kernel B11 (attention.cu repeats)"),
    }[name]


def phase_mha_suite() -> dict:
    """The MHA suite's rows through the bench driver on the card at -n 20,
    each lowered beside --linalg-to-loops; then the ping-pong fc rows
    through tpp-run -n 100. Each row's launch counts are set to 0 just
    before it and read just after; the rows' sum is returned."""
    import torch

    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    from tpp_mlir_tpu_torch.tools.tpp_run import run_module
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    total = dict.fromkeys((*KINDS.values(), *SHARED_KINDS), 0)
    for entry in MHA_SUITE:
        t0 = time.perf_counter()
        want_ops, kinds, want_bench = _mha_want(entry)
        cache.reset_launches()
        res = run_entry(entry, n=MHA_N, device="cuda", out_stream=sys.stderr)
        launches = _launches(cache)
        module = res["lowered"]["module"]
        ops = _invoke_counts(module)
        disp = [op.attrs for op in module["entry"].ops
                if op.opname == "xsmm.batch_gemm_dispatch"]
        got = res["lowered"]["outputs"][0]
        want = res["baseline"]["outputs"][0]
        rel, _ = rel_err(got, want)
        note = ""
        tol = TOL_MODEL
        if entry["name"] in MHA_HIGHEST:
            hi = run_entry(dict(entry, precision="highest"), device="cuda",
                           out_stream=sys.stderr)
            note = f" (\"default\" {rel:.3e}, printed)"
            rel, _ = rel_err(hi["lowered"]["outputs"][0],
                             hi["baseline"]["outputs"][0])
            tol = TOL_MHA_HIGHEST
        softmax = any(a.get("softmax_lhs") for a in disp)
        softmax_ok = entry["model"].startswith("mha_softmax_v") == softmax
        bench = res["lowered"]["bench"]
        ok = ops == want_ops and softmax_ok and torch_isfinite(got) and \
            tuple(got.shape) == tuple(want.shape) and rel <= tol and \
            bench == want_bench and all(launches[k] for k in kinds)
        moved = {k: v for k, v in launches.items() if v}
        ms = res["lowered"]["mean_seconds"] * 1e3
        base = res["baseline"]["mean_seconds"] * 1e3
        say(f"mha {entry['name']}: lowered to {ops}"
            f"{' softmax_lhs' if softmax else ''}; bench "
            f"{bench}; output {tuple(got.shape)} {str(got.dtype)[6:]} vs "
            f"--linalg-to-loops rel {rel:.3e} tol {tol:.0e}{note}; launches "
            f"{moved}; -n {MHA_N} {ms:.4f} ms/iter "
            f"({res['flops'] / ms / 1e9:.2f} TFLOP/s), --linalg-to-loops "
            f"{base:.4f} ms ({time.perf_counter() - t0:.1f} s) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{entry['name']}: ops {ops} (want "
                                 f"{want_ops}), bench {bench} (want "
                                 f"{want_bench}), rel {rel}, launches "
                                 f"{launches} (must move: {kinds})")
        for k, v in launches.items():
            total[k] += v
        del res
        torch.cuda.empty_cache()    # the S 2048 oracle's f32 scores
    for label, flags in FC_ROWS:
        cache.reset_launches()
        res = run_module(_module(flags), n=100, device="cuda",
                         out_stream=sys.stderr)
        launches = _launches(cache)
        ref = run_module(_module(flags), device="cuda", linalg_to_loops=True,
                         out_stream=sys.stderr)
        got, want = res["outputs"][0], ref["outputs"][0]
        rel, _ = rel_err(got, want)
        in_kernel = res["bench"].startswith("in-kernel")
        ok = rel <= TOL_BF16 and torch_isfinite(got) and \
            in_kernel == bool(launches["chain_pingpong"])
        say(f"fc {label} tpp-run -n 100: bench {res['bench']}; "
            f"{res['gflops']:.1f} GFLOP/s ({res['mean_seconds'] * 1e3:.4f} "
            f"ms/iter); vs --linalg-to-loops rel {rel:.3e} tol "
            f"{TOL_BF16:.0e}; launches "
            f"{ {k: v for k, v in launches.items() if v} } "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel}, bench {res['bench']},"
                                 f" launches {launches}")
        for k, v in launches.items():
            total[k] += v
    if not total["chain_pingpong"]:
        raise AssertionError("no fc row ran B5's ping-pong bench")
    return total


# the conv family (benchmarks/configs/conv.json's 14 rows, vit.json's 3), at
# their own sizes: the nets through the bench driver with each row's -n
# (iters; MHA_N for the ViT rows, which time the loop), and csrc/conv.cu
# (B24/B25) at the keys default-tpp-passes makes of them
CONV_CONFIGS = ("benchmarks/configs/conv.json", "benchmarks/configs/vit.json")
# (label, suite row, index of the conv among the row's, key overrides)
CONV_KERNEL_CASES = (
    ("conv3x3_fp32_b8_c128_k128_30", "conv3x3_fp32_b8_c128_k128_30", 0, {}),
    ("conv3x3_fp32_b8_c128_k128_30 highest", "conv3x3_fp32_b8_c128_k128_30",
     0, {"precision": "highest"}),
    ("conv3x3_bf16_b8_c128_k128_30", "conv3x3_bf16_b8_c128_k128_30", 0, {}),
    ("conv3x3_fp32_b8_c256_k256_16", "conv3x3_fp32_b8_c256_k256_16", 0, {}),
    ("conv1x1_nhwc_fp32_b8_c256_k256_14 (W 14)",
     "conv1x1_nhwc_fp32_b8_c256_k256_14", 0, {}),
    ("resnet_block_nhwc_bf16 same + residual",
     "resnet_block_nhwc_bf16", 1, {}),
    ("conv3x3_fp32_b8_c128_k128_30 forced fullrow (B25)",
     "conv3x3_fp32_b8_c128_k128_30", 0, {"strategy": "fullrow"}),
    ("conv3x3_fp32_b8_c128_k128_30 forced window (B24)",
     "conv3x3_fp32_b8_c128_k128_30", 0, {"strategy": "window"}),
    # no kernel: the xla route, held at "highest" to the per-tap plain
    # version, which it meets only with cuDNN's TF32 off
    ("vit_d128_p16_f32 patch conv, xla route, highest", "vit_d128_p16_f32",
     0, {"precision": "highest"}),
)


def _conv_suite() -> list[dict]:
    from pathlib import Path
    root = Path(__file__).resolve().parent
    return [e for cfg in CONV_CONFIGS
            for e in json.loads((root / cfg).read_text())["benchmarks"]]


def _conv_dispatches(module) -> list:
    """(invoke, ConvNhwcKey) of each conv_nhwc invoke of a lowered
    module."""
    from tpp_mlir_tpu_torch.runtime.executor import _dispatch_key
    return [(op, _dispatch_key(op.operands[0].owner, op))
            for op in module["entry"].ops
            if op.opname in ("xsmm.brgemm", "xsmm.fused_brgemm")
            and op.operands[0].owner.attrs.get("layout") == "conv_nhwc"]


@functools.lru_cache(maxsize=None)
def _row_conv_keys(row: str) -> tuple:
    """The conv keys default-tpp-passes makes of a suite row."""
    from tpp_mlir_tpu_torch.passes import run_pipeline
    from tpp_mlir_tpu_torch.tools.bench_driver import build_module
    module = build_module(next(e for e in _conv_suite() if e["name"] == row))
    run_pipeline(module, "default-tpp-passes")
    return tuple(key for _, key in _conv_dispatches(module))


def _conv_key(row: str, index: int, **kw):
    """A suite row's index-th conv key, with overrides."""
    return dataclasses.replace(_row_conv_keys(row)[index], **kw)


def _conv_inputs(key, g):
    """I (N, H, W, C) and W (R, S, C, K) ~ N(0, 1/(R S C)) in the key's
    dtype; the f32 accumulator and D (a channel bias or a full residual)
    where the key reads them."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]

    def rnd(*shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)
    out = (key.N, key.P, key.Q, key.K)
    c = None if key.beta0 else rnd(*out, dtype=torch.float32)
    d = None
    if key.binary_kind:
        d = rnd(*(out if key.binary_bcast == "none" else (key.K,)),
                dtype=torch.float32)
    return (rnd(key.N, key.H, key.W, key.C),
            rnd(key.R, key.S, key.C, key.K,
                scale=(key.R * key.S * key.C) ** -0.5), c, d)


def phase_conv_kernels() -> dict:
    """csrc/conv.cu against its per-tap plain version at the conv suite's
    keys, at f32 "default" and "highest", bf16, the 1x1 W 14 key, the
    same-padded residual key and the forced fullrow (B25) and window (B24)
    strategies; then the xla route (F.conv2d, no kernel) against the same
    plain version at "highest", which cuDNN's default TF32 would miss."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel
    from tpp_mlir_tpu_torch.xsmm.reference import (conv_nhwc_reference,
                                                   conv_route)
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    for label, row, index, kw in CONV_KERNEL_CASES:
        key = _conv_key(row, index, **kw)
        args = _conv_inputs(key, g)
        kern = build_kernel(key)
        got = kern(*args)
        ref = conv_nhwc_reference(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        tol = _tol(key)
        route = conv_route(key)
        ok = rel <= tol and torch_isfinite(got) and \
            kern.launches == (route == "kernel") and \
            torch.backends.cudnn.allow_tf32   # the route restores the flag
        say(f"kernel {_kind(key) or 'no kernel':12s} {label:50s} "
            f"N{key.N} {key.H}x{key.W}x{key.C}->{key.P}x{key.Q}x{key.K} "
            f"R{key.R} pad {key.pad} {key.dtype}/{key.precision} route "
            f"{route} rel {rel:.3e} abs {ab:.3e} tol {tol:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel} > {tol}, launches "
                                 f"{kern.launches}, route {route}")
        if route == "kernel":
            worst = max(worst, ab)
    return {"conv_nhwc": {"max_abs_err": worst}}


# ms/iter of each conv.json row's flat run in phase g, printed beside its
# packed run in phase h
CONV_FLAT_MS: dict[str, float] = {}


def phase_conv_suite() -> dict:
    """Every conv.json and vit.json row through the bench driver on the
    card with its own -n, lowered beside --linalg-to-loops: the invokes it
    lowered to, which route each conv took (csrc/conv.cu, or xla for the
    ViT's strided patch conv), the launch counts of the row alone, finite
    outputs within TOL_MODEL of the oracle, ms/iter of both."""
    import torch

    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    from tpp_mlir_tpu_torch.xsmm import global_cache
    from tpp_mlir_tpu_torch.xsmm.reference import conv_route
    cache = global_cache()
    total = dict.fromkeys((*KINDS.values(), *SHARED_KINDS), 0)
    for entry in _conv_suite():
        t0 = time.perf_counter()
        n = entry.get("iters", MHA_N)
        vit = entry["model"].startswith("vit:")
        cache.reset_launches()
        res = run_entry(entry, n=n, device="cuda", out_stream=sys.stderr)
        launches = _launches(cache)
        module = res["lowered"]["module"]
        ops = _invoke_counts(module)
        routes = [conv_route(key) for _, key in _conv_dispatches(module)]
        got = res["lowered"]["outputs"][0]
        want = res["baseline"]["outputs"][0]
        rel, _ = rel_err(got, want)
        kinds = ("attention", "brgemm") if vit else ("conv_nhwc",)
        ok = torch_isfinite(got) and rel <= TOL_MODEL and \
            tuple(got.shape) == tuple(want.shape) and \
            routes == (["xla"] if vit else ["kernel"] * len(routes)) and \
            all(launches[k] for k in kinds)
        moved = {k: v for k, v in launches.items() if v}
        ms = res["lowered"]["mean_seconds"] * 1e3
        base = res["baseline"]["mean_seconds"] * 1e3
        CONV_FLAT_MS[entry["name"]] = ms
        say(f"conv {entry['name']}: lowered to {ops}; conv routes {routes}; "
            f"output {tuple(got.shape)} {str(got.dtype)[6:]} vs "
            f"--linalg-to-loops rel {rel:.3e} tol {TOL_MODEL:.0e}; launches "
            f"{moved}; -n {n} ({res['lowered']['bench']}) {ms:.4f} ms/iter "
            f"({res['flops'] / ms / 1e9:.2f} TFLOP/s), --linalg-to-loops "
            f"{base:.4f} ms ({time.perf_counter() - t0:.1f} s) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{entry['name']}: rel {rel}, routes "
                                 f"{routes}, launches {launches} (must "
                                 f"move: {kinds})")
        for k, v in launches.items():
            total[k] += v
        del res
        torch.cuda.empty_cache()
    return total


# packed parity mode (default-tpp-passes-packed): the rows of base.json,
# conv.json, vit.json and mha.json it runs, at their own sizes, and
# csrc/blocked_matmul.cu (B19/B20) and csrc/conv.cu's channel-blocked entry
# (B23) at the keys the packed pipeline makes of them
PACKED = "default-tpp-passes-packed"
PACKED_KINDS = ("blocked_matmul", "blocked_matmul_warm", "conv_blocked")
PACKED_CONFIGS = ("benchmarks/configs/base.json",
                  "benchmarks/configs/conv.json",
                  "benchmarks/configs/vit.json",
                  "benchmarks/configs/mha.json")
FLAGSHIP_GEN = f"--batch={BATCH} --layers={','.join([str(WIDTH)] * LAYERS)} " \
    "--bias --relu"
# (row or label, entry overrides, {dispatch layout: invokes a forward},
#  kinds that must launch, the flat twin's row (or "4g": phase g's run),
#  tolerance against --linalg-to-loops)
PACKED_ROWS = (
    ("fc_fp32_packed_warm_1024", {}, {"blocked": 1},
     ("blocked_matmul", "blocked_matmul_warm"), "fc_fp32_flat_warm_1024",
     TOL_BF16),
    ("fc_bf16_packed_warm_1024", {}, {"blocked": 1},
     ("blocked_matmul", "blocked_matmul_warm"), "fc_bf16_flat_warm_1024",
     TOL_BF16),
    ("flagship f32 packed", {"gen": FLAGSHIP_GEN, "pipeline": PACKED,
                             "iters": 100},
     {"blocked": 3}, ("blocked_matmul",), None, TOL_BF16),
    ("flagship bf16 packed", {"gen": FLAGSHIP_GEN + " --float-type=bf16",
                              "pipeline": PACKED, "iters": 100},
     {"blocked": 3}, ("blocked_matmul",), None, TOL_BF16),
    ("flagship f32 --tiles=256,512,512", {
        "gen": FLAGSHIP_GEN + " --tiles=256,512,512", "iters": 100},
     {"blocked": 3}, ("blocked_matmul",), None, TOL_BF16),
    ("conv3x3_fp32_b8_c128_k128_30", {"pipeline": PACKED}, {"conv": 1},
     ("conv_blocked",), "4g", TOL_MODEL),
    ("conv3x3_fp32_b8_c256_k256_16", {"pipeline": PACKED}, {"conv": 1},
     ("conv_blocked",), "4g", TOL_MODEL),
    ("conv3x3_bf16_b8_c128_k128_30", {"pipeline": PACKED}, {"conv": 1},
     ("conv_blocked",), "4g", TOL_MODEL),
    ("conv3x3_fp32_2layer", {"pipeline": PACKED}, {"conv": 2},
     ("conv_blocked",), "4g", TOL_MODEL),
    ("conv1x1_fp32_b8_c256_k256_14", {"pipeline": PACKED}, {},
     ("batch_matmul",), "4g", TOL_MODEL),
    ("resnet_block_torch_import_fp32", {"pipeline": PACKED}, {"conv": 2},
     ("conv_blocked",), "4g", TOL_MODEL),
    ("resnet_block_torch_import_bf16", {"pipeline": PACKED}, {"conv": 2},
     ("conv_blocked",), "4g", TOL_MODEL),
    ("vit_d128_p16_f32", {"pipeline": PACKED}, {"blocked": 12},
     ("blocked_matmul", "attention", "layer_norm"), None, TOL_MODEL),
    ("vit_d128_p16_bf16", {"pipeline": PACKED}, {"blocked": 12},
     ("blocked_matmul", "attention", "layer_norm"), None, TOL_MODEL),
    ("vit_d64_p16_bf16", {"pipeline": PACKED}, {"blocked": 12},
     ("blocked_matmul", "attention", "layer_norm"), None, TOL_MODEL),
    ("pack_gemm_operand_a_fp32", {}, {}, (), None, 0.0),
    ("pack_gemm_operand_b_fp32", {}, {}, (), None, 0.0),
    ("unpack_gemm_operand_a_fp32", {}, {}, (), None, 0.0),
)
# (label, row, index of the packed dispatch among the row's, overrides)
PACKED_KERNEL_CASES = (
    ("fc_fp32_packed_warm_1024 (f32 default)", "fc_fp32_packed_warm_1024",
     0, {}),
    ("fc_fp32_packed_warm_1024 highest", "fc_fp32_packed_warm_1024", 0,
     {"precision": "highest"}),
    ("fc_bf16_packed_warm_1024 (VNNI)", "fc_bf16_packed_warm_1024", 0, {}),
    ("fc f32 masked mb 8", "fc_fp32_packed_warm_1024", 0,
     {"Mb": 2, "mb": 8}),
    ("vit_d128_p16_bf16 fc1 (gelu)", "vit_d128_p16_bf16", 4, {}),
    ("fc_fp32_packed_warm_1024 B20 r3", "fc_fp32_packed_warm_1024", 0,
     {"repeats": 3}),
    ("fc_fp32_packed_warm_1024 B20 highest r3", "fc_fp32_packed_warm_1024",
     0, {"precision": "highest", "repeats": 3}),
    ("fc_bf16_packed_warm_1024 B20 r3", "fc_bf16_packed_warm_1024", 0,
     {"repeats": 3}),
    ("conv3x3_fp32_b8_c128_k128_30", "conv3x3_fp32_b8_c128_k128_30", 0, {}),
    ("conv3x3_bf16_b8_c128_k128_30", "conv3x3_bf16_b8_c128_k128_30", 0, {}),
    ("conv3x3_fp32_b8_c256_k256_16 (Cb 2)", "conv3x3_fp32_b8_c256_k256_16",
     0, {}),
    ("resnet_block_torch_import_fp32 conv1 (C, relu)",
     "resnet_block_torch_import_fp32", 0, {}),
    ("resnet_block_torch_import_fp32 conv2 (C)",
     "resnet_block_torch_import_fp32", 1, {}),
)
# the keys phase 5 times and holds against their plain versions, each
# kernel's first the kernel line's (its ms and max_abs_err): B19 at the fc
# rows' keys, B20 at them with the rows' -n as repeats, B23 at the conv rows'
# keys and the ResNet block's C-accumulator key
PACKED_TIMED = (
    ("fc_fp32_packed_warm_1024", 0, {}), ("fc_bf16_packed_warm_1024", 0, {}),
    ("fc_fp32_packed_warm_1024", 0, {"repeats": 200}),
    ("fc_bf16_packed_warm_1024", 0, {"repeats": 200}),
    ("conv3x3_fp32_b8_c128_k128_30", 0, {}),
    ("conv3x3_bf16_b8_c128_k128_30", 0, {}),
    ("conv3x3_fp32_b8_c256_k256_16", 0, {}),
    ("resnet_block_torch_import_fp32", 1, {}))


@functools.lru_cache(maxsize=None)
def _packed_suite() -> dict:
    from pathlib import Path

    from tpp_mlir_tpu_torch.tools.bench_driver import load_config
    root = Path(__file__).resolve().parent
    return {e["name"]: e for cfg in PACKED_CONFIGS
            for e in load_config(str(root / cfg))}


def _packed_entry(row: str, overrides: dict) -> dict:
    entry = dict(_packed_suite().get(row, {"name": row}), **overrides)
    entry["name"] = row
    return entry


def _packed_layouts(module) -> dict:
    """{dispatch layout: invokes} of a lowered module's blocked and conv
    GEMMs, and the tl.pack/tl.unpack/tl.blocked_conv2d ops it keeps."""
    out: dict[str, int] = {}
    for op in module["entry"].ops:
        if op.opname in ("tl.pack", "tl.unpack", "tl.blocked_conv2d"):
            out[op.opname] = out.get(op.opname, 0) + 1
        elif op.opname in ("xsmm.brgemm", "xsmm.fused_brgemm"):
            layout = op.operands[0].owner.attrs.get("layout", "flat")
            if layout in ("blocked", "conv"):
                out[layout] = out.get(layout, 0) + 1
    return out


@functools.lru_cache(maxsize=None)
def _packed_row_keys(row: str) -> tuple:
    """The BlockedMatmulKey/ConvBrgemmKey of each packed invoke the packed
    pipeline makes of a suite row, in order."""
    from tpp_mlir_tpu_torch.passes import run_pipeline
    from tpp_mlir_tpu_torch.runtime.executor import _dispatch_key
    from tpp_mlir_tpu_torch.tools.bench_driver import build_module
    module = build_module(_packed_entry(row, {}))
    run_pipeline(module, PACKED)
    return tuple(_dispatch_key(op.operands[0].owner, op)
                 for op in module["entry"].ops
                 if op.opname in ("xsmm.brgemm", "xsmm.fused_brgemm")
                 and op.operands[0].owner.attrs.get("layout")
                 in ("blocked", "conv"))


def _packed_key(row: str, index: int, **kw):
    return dataclasses.replace(_packed_row_keys(row)[index], **kw)


def _blocked_inputs(key, g):
    """A [Mb,Kb,mb,kb] and B [Nb,Kb,kb,nb] ~ N(0, 1/K) (VNNI
    [Nb,Kb,kb/2,nb,2] for a vnni key) in the key's dtype; the f32
    accumulator and the bias [Nb, nb] where the key reads them."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]

    def rnd(*shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)
    b = rnd(key.Nb, key.Kb, key.kb, key.nb, scale=(key.Kb * key.kb) ** -0.5)
    if key.vnni:
        b = b.reshape(key.Nb, key.Kb, key.kb // key.vnni, key.vnni, key.nb) \
            .movedim(-2, -1).contiguous()
    c = None if key.beta0 else rnd(key.Mb, key.Nb, key.mb, key.nb,
                                   dtype=torch.float32)
    d = rnd(key.Nb, key.nb, dtype=torch.float32) if key.binary_kind else None
    return rnd(key.Mb, key.Kb, key.mb, key.kb), b, c, d


def _conv_blocked_inputs(key, g):
    """I [N,Cb,H,W,c] and W [Kb,Cb,R,S,c,k] ~ N(0, 1/(R S C)) in the key's
    dtype; the f32 accumulator and the bias [Kb, k] where the key reads
    them."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]

    def rnd(*shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)
    out = (key.N, key.Kb, key.P, key.Q, key.k)
    c = None if key.beta0 else rnd(*out, dtype=torch.float32)
    d = rnd(key.Kb, key.k, dtype=torch.float32) if key.binary_kind else None
    return (rnd(key.N, key.Cb, key.H, key.W, key.c),
            rnd(key.Kb, key.Cb, key.R, key.S, key.c, key.k,
                scale=(key.R * key.S * key.Cb * key.c) ** -0.5), c, d)


def _packed_inputs(key, g):
    from tpp_mlir_tpu_torch.xsmm import BlockedMatmulKey
    return _blocked_inputs(key, g) if isinstance(key, BlockedMatmulKey) \
        else _conv_blocked_inputs(key, g)


def phase_packed_kernels() -> dict:
    """B19, B20 and B23 against their plain versions at the keys the packed
    pipeline makes of the suites' rows (and a masked mb 8 key, B20 at
    repeats 3)."""
    import torch

    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    g = torch.Generator(device="cuda").manual_seed(9)
    stats: dict[str, dict] = {}
    for label, row, index, kw in PACKED_KERNEL_CASES:
        key = _packed_key(row, index, **kw)
        args = _packed_inputs(key, g)
        kern = build_kernel(key)
        got = kern(*args)
        ref = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        tol = _tol(key)
        kind = _kind(key)
        ok = rel <= tol and torch_isfinite(got) and kern.launches == 1 and \
            tuple(got.shape) == tuple(ref.shape)
        say(f"kernel {kind:19s} {label:48s} {describe(key)} rel "
            f"{rel:.3e} abs {ab:.3e} tol {tol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel} > {tol}, launches "
                                 f"{kern.launches}")
        worst = stats.get(kind, {}).get("max_abs_err", 0.0)
        stats[kind] = {"max_abs_err": max(worst, ab)}
    return stats


def phase_packed_suite() -> dict:
    """Packed parity mode's rows through the bench driver on the card at
    their own sizes, each with its own -n, lowered beside
    --linalg-to-loops: the packed invokes a forward, the launch counts of
    the row alone (a forward's kernels times the forwards the run made;
    the fc rows: one B19 forward and B20's four bench launches), the bench
    lowering, outputs within the row's tolerance (the pack/unpack rows
    bit-exact), and ms/iter beside the flat twin's and
    --linalg-to-loops'."""
    import torch

    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    total = dict.fromkeys((*KINDS.values(), *SHARED_KINDS), 0)
    flat_ms: dict[str, float] = {}
    for row, overrides, want_layouts, kinds, twin, tol in PACKED_ROWS:
        t0 = time.perf_counter()
        entry = _packed_entry(row, overrides)
        n = entry.get("iters", MHA_N)
        cache.reset_launches()
        res = run_entry(entry, n=n, device="cuda", out_stream=sys.stderr)
        launches = _launches(cache)
        low = res["lowered"]
        module = low["module"]
        layouts = _packed_layouts(module)
        got, want = low["outputs"][0], res["baseline"]["outputs"][0]
        rel, _ = rel_err(got, want)
        bench = low["bench"]
        per_forward = sum(want_layouts.values())
        kind = "conv_blocked" if "conv" in want_layouts else "blocked_matmul"
        if bench.startswith("in-kernel B20"):
            # the bench in the kernel: a warm-up and 3 timed B20 launches;
            # one B19 forward for the output
            counts_ok = launches["blocked_matmul"] == 1 and \
                launches["blocked_matmul_warm"] == 4
        else:
            forwards = launches[kind] // per_forward if per_forward else 0
            counts_ok = not per_forward or (
                launches[kind] == forwards * per_forward and forwards > n)
        layouts_ok = all(layouts.get(k, 0) == v
                         for k, v in want_layouts.items())
        if row.startswith("flagship") and "tiles" not in row:
            layouts_ok &= layouts.get("tl.pack") == 1 and \
                layouts.get("tl.unpack") == 1
        if row.startswith("vit"):
            layouts_ok &= layouts.get("tl.blocked_conv2d") == 1
        exact = tol == 0.0
        out_ok = torch.equal(got, want) if exact else \
            (rel <= tol and torch_isfinite(got))
        want_bench = "in-kernel B20 (blocked_matmul.cu repeats)" \
            if row.startswith("fc_") else "loop"
        ok = layouts_ok and counts_ok and out_ok and bench == want_bench \
            and tuple(got.shape) == tuple(want.shape) and \
            all(launches[k] for k in kinds)
        ms = low["mean_seconds"] * 1e3
        base = res["baseline"]["mean_seconds"] * 1e3
        twin_note = ""
        if twin == "4g":
            twin_note = f", flat (phase g) {CONV_FLAT_MS[row]:.4f} ms"
        elif twin:
            flat = run_entry(_packed_entry(twin, {}), device="cuda",
                             out_stream=sys.stderr)
            flat_ms[twin] = flat["lowered"]["mean_seconds"] * 1e3
            twin_note = (f", flat twin {twin} {flat_ms[twin]:.4f} ms "
                         f"({flat['lowered']['bench']})")
        moved = {k: v for k, v in launches.items() if v}
        rate = f" ({res['flops'] / ms / 1e9:.2f} TFLOP/s)" \
            if res["flops"] else ""
        say(f"packed {row}: {entry.get('pipeline', 'default-tpp-passes')} "
            f"lowered to {layouts} (want {want_layouts} a forward); bench "
            f"{bench}; output {tuple(got.shape)} {str(got.dtype)[6:]} vs "
            f"--linalg-to-loops {'bit-exact ' + str(out_ok) if exact else f'rel {rel:.3e} tol {tol:.0e}'}; "
            f"launches {moved}; -n {n} {ms:.4f} ms/iter{rate}{twin_note}, "
            f"--linalg-to-loops {base:.4f} ms "
            f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{row}: layouts {layouts} (want "
                                 f"{want_layouts}), bench {bench} (want "
                                 f"{want_bench}), rel {rel}, launches "
                                 f"{launches} (must move: {kinds})")
        for k, v in launches.items():
            total[k] += v
        del res
        torch.cuda.empty_cache()
    return total


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t.float()).all())


def _baseline_ms(module, iters: int) -> float:
    """torch.matmul + bias + ReLU on the module's own weights, chained
    `iters` times like the perf.bench loop, by CUDA events."""
    import torch

    from tpp_mlir_tpu_torch.runtime.executor import _eval_constant
    from tpp_mlir_tpu_torch.tools.tpp_run import init_args
    func = module["entry"]
    values = {id(op.result): _eval_constant(op, "cuda") for op in func.ops
              if op.opname == "tl.constant"}
    layers = []     # [weight, bias or None, relu]
    for op in func.ops:
        if op.opname == "tl.matmul":
            layers.append([values[id(op.operands[1])], None, False])
        elif op.opname == "tl.add":
            layers[-1][1] = values[id(op.operands[1])]
        elif op.opname == "tl.relu":
            layers[-1][2] = True
    x = init_args(module, "entry", "normal", 0, "cuda")[0]

    def step(h):
        for w, b, relu in layers:
            h = torch.matmul(h, w) if b is None else torch.addmm(b, h, w)
            h = torch.relu(h) if relu else h
        return h

    def run():
        h = x
        for _ in range(iters):
            h = step(h)
    return cuda_ms(run, iters=1, warmup=1) / iters


def phase_timing(n: int = 100) -> dict:
    """The MLP modules at -n 100 through the port beside torch.matmul +
    bias + ReLU; each transformer forward (-n 10) beside the same module at
    --linalg-to-loops; then each kernel's time beside its plain version at
    the main paths' shapes."""
    import torch

    from tpp_mlir_tpu_torch.tools.tpp_run import run_module
    from tpp_mlir_tpu_torch.xsmm import (BrgemmKey, ChainKey,
                                         FlashTrainBwdKey, build_kernel,
                                         reference_kernel)
    for label, flags, _ in MODULES:
        res = run_module(_module(flags), n=n, device="cuda",
                         out_stream=sys.stderr)
        module = _module(flags)
        base = _baseline_ms(module, n)
        flops = module.attrs["flops"]
        say(f"time {label:22s} -n {n}: port {res['gflops']:.1f} GFLOP/s "
            f"({res['mean_seconds'] * 1e3:.4f} ms), torch.matmul "
            f"{flops / base / 1e6:.1f} GFLOP/s ({base:.4f} ms)")
    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    for label, entry, _, _ in TRANSFORMERS:
        res = run_entry({"model": entry}, n=10, device="cuda",
                        out_stream=sys.stderr)
        ms = res["lowered"]["mean_seconds"] * 1e3
        base = res["baseline"]["mean_seconds"] * 1e3
        rate = f", {res['tokens'] / ms * 1e3:.1f} tokens/s" \
            if res["tokens"] else ""
        say(f"time {label} -n 10: port forward {ms:.4f} ms{rate} "
            f"({res['flops'] / ms / 1e9:.2f} TFLOP/s), --linalg-to-loops "
            f"{base:.4f} ms")
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    cases = [
        ("brgemm", BrgemmKey(1, BATCH, WIDTH, WIDTH, "f32", beta0=True,
                             binary_kind="add", unary_kind="relu"),
         _brgemm_inputs),
        ("brgemm", BrgemmKey(1, BATCH, WIDTH, WIDTH, "bf16", beta0=True,
                             binary_kind="add", unary_kind="relu"),
         _brgemm_inputs),
        ("chain", ChainKey(m=BATCH, dims=(WIDTH,) * LAYERS, dtype="bf16"),
         _chain_inputs),
        ("chain", ChainKey(m=BATCH, dims=(WIDTH,) * LAYERS, dtype="f32"),
         _chain_inputs)]
    cases += [("brgemm", key, _ln_gemm_inputs)
              for _, key in _ln_gemm_cases()[:2]]
    cases += [("attention", key, _attention_inputs)
              for _, key in _attention_cases()[:3]]
    cases += [("layer_norm", key, _layer_norm_inputs)
              for _, key in _layer_norm_cases()]
    cases += [("decode_attn", key, _decode_attn_inputs)
              for _, key in _decode_attn_cases()[:4]]
    cases += [("int8_gemm", key, _int8_inputs)
              for _, key in _int8_cases()[:4]]
    train_key = _flash_train_cases()[0][1]
    cases += [("flash_train_fwd", train_key, _flash_fwd_timing_inputs),
              ("flash_train_bwd", FlashTrainBwdKey(
                  **dataclasses.asdict(train_key)), _flash_bwd_timing_inputs)]
    # the MoE slice's B16 keys (fc2 first: torch._grouped_mm computes the
    # same function there; fc1's gelu epilogue has no such call) and B17
    moe = [("grouped_gemm", *_grouped_gemm_inputs(
        g, *GROUPED_GEMM_CASES[i][1:])[:2]) for i in (1, 0)]
    moe += [("grouped_wgrad", *_grouped_wgrad_inputs(
        g, *GROUPED_WGRAD_CASES[i][1:])[:2]) for i in (1, 0)]
    # the MHA suite: flat attention at each TPU kernel's own key (B8 at
    # S 2048 first: the kernel line's; B9 at the S 1024 rows and mha_full;
    # B10b and B10a at causal S 2048; B6 with forced blocks), B11 at -n 20,
    # the batched matmul at mha_qk's (B22, the line's) and mha_softmax_v's
    # keys, B5 at fc_128x768x2304 with -n 100
    from tpp_mlir_tpu_torch.xsmm import BatchMatmulKey
    causal = "flash_attention_causal_bf16_s2048"
    mha = [_mha_key("flash_attention_bf16_s2048"),
           _mha_key("flash_attention_fp32_s1024"), _mha_key("mha_full_fp32"),
           _mha_key(causal), _mha_key(causal, strategy="twocall"),
           _mha_key("flash_attention_fp32_s1024", bq=256, bk=256),
           _mha_key("flash_attention_bf16_s1024_d128", repeats=MHA_N),
           BatchMatmulKey(1024, 32, 32, 64, "f32", beta0=True),
           BatchMatmulKey(1024, 32, 64, 32, "f32", beta0=True,
                          softmax_lhs=True),
           ChainKey(m=128, dims=(768, 2304), repeats=100, pingpong=True)]
    moe += [(_kind(key), key, _mha_inputs(key, g)) for key in mha]
    # the conv family: csrc/conv.cu at each kernel case's key (the
    # conv3x3_fp32_b8_c128_k128_30 layer first: the kernel line's), forced
    # fullrow (B25) last
    convs = [_conv_key(row, index, **kw)
             for _, row, index, kw in CONV_KERNEL_CASES[:7]]
    moe += [("conv_nhwc", key, _conv_inputs(key, g)) for key in convs]
    # packed parity mode: B19, B20 and B23 at the packed rows' keys
    packed = [_packed_key(row, index, **kw) for row, index, kw in PACKED_TIMED]
    moe += [(_kind(key), key, _packed_inputs(key, g)) for key in packed]
    from tpp_mlir_tpu_torch.tools.trace import describe
    timed = [(kind, key, make(key, g)) for kind, key, make in cases] + moe
    for kind, key, args in timed:
        kern, plain = build_kernel(key), reference_kernel(key)
        library = _library_call(kind, key, args)
        graphed = kind in ("decode_attn", "int8_gemm", "batch_matmul")
        # the serving kernels run inside the decode step's CUDA graph: their
        # line and the kernel table take graph-replayed times
        timer = graph_ms if graphed else cuda_ms
        ms, plain_ms = timer(lambda: kern(*args)), timer(lambda: plain(*args))
        lib_ms = timer(library) if library else None
        bound, by = _bound(kind, key, args)
        note = " (replayed from a CUDA graph)" if graphed else ""
        if getattr(key, "repeats", 0) > 1:
            note += f" ({ms / key.repeats:.4f} ms per repeat of {key.repeats})"
        if hasattr(key, "bq") and (key.strategy != "auto" or key.bq):
            note += f" (strategy {key.strategy}, bq {key.bq}, bk {key.bk})"
        lib = f"{lib_ms:.4f} ms" if library else "none"
        say(f"time kernel {describe(key):44s} {ms:.4f} ms, plain version "
            f"{plain_ms:.4f} ms, library call {lib}, bound {bound:.4f} ms "
            f"({by}){note}")
        err = {}
        if kind in PACKED_KINDS:
            # packed parity mode's kernels at the timed keys themselves
            # (B20 at the rows' -n): the line's max_abs_err is its ms's key's
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            rel, ab = rel_err(got, want)
            ok = rel <= _tol(key) and torch_isfinite(got)
            say(f"  against its plain version: rel {rel:.3e} abs {ab:.3e} "
                f"tol {_tol(key):.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{describe(key)}: rel {rel} > "
                                     f"{_tol(key)}")
            err = {"max_abs_err": ab}
        # the kernel line keeps the first shape of each kind: the MLP's f32
        # fc for brgemm, the bf16 flagship chain, GPT-2's attention and
        # ln_f, the serving decode attention (MHA), the int8 QKV GEMM,
        # B14/B18 at the GPT-2 training key, B16 at the MoE prefill's fc2
        # and B17 at the training step's dw1
        out.setdefault(kind, {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "bound_by": by,
                              "library_ms": lib_ms, **err})
    return out


def _flash_fwd_timing_inputs(key, g):
    return _flash_train_inputs(key, g)[:3]


def _flash_bwd_timing_inputs(key, g):
    """B18's operands at `key`, from B14's plain forward."""
    from tpp_mlir_tpu_torch.xsmm import FlashTrainKey, reference_kernel
    q, k, v, do = _flash_train_inputs(key, g)
    fwd = FlashTrainKey(**dataclasses.asdict(key))
    o, lse2 = reference_kernel(fwd)(q, k, v)
    return q, k, v, do, lse2, _flash_delta(do, o)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound(kind, key, args) -> tuple[float, str]:
    """The least time the card could take for the kernel's work on `args`:
    the larger of the bytes it must move (each input read once, each output
    written once) over HBM's rate and its operations over the peak rate of
    their type (f32 "default" and bf16 products on the bf16 tensor cores,
    f32 "highest" at the f32 rate). Work that depends on the data counts
    what this run needs: a causal key's triangle, decode's live rows."""
    import torch

    from tpp_mlir_tpu_torch.xsmm.reference import mxu_dtype
    out_bytes = {torch.float32: 4, torch.bfloat16: 2}
    if kind == "brgemm":
        a, b, c, d = args[:4]
        rate = "f32" if mxu_dtype(key.dtype, key.precision) == \
            torch.float32 else "bf16"
        flops = 2 * key.batch * key.m * key.n * key.k
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(a, b, c, d, *args[4:]) + key.m * key.n * size
    elif kind == "chain":
        x, *wb = args
        dims = key.dims
        rate = "f32" if key.precision == "highest" else "bf16"
        flops = 2 * key.m * sum(k * n for k, n in zip(dims[:-1], dims[1:]))
        nbytes = _nbytes(x, *wb) + key.m * dims[-1] * x.element_size()
    elif kind in ("attention", "attention_flat", "attention_bench"):
        q = args[0]
        B, S, H, D = key.batch, key.seq, key.heads or 1, key.head_dim
        pairs = S * (S + 1) // 2 if key.causal else S * key.seq_kv
        rate = "f32" if key.precision == "highest" else "bf16"
        flops = 4 * B * H * pairs * D * max(1, key.repeats)
        nbytes = _nbytes(q) * (1 if key.qkv_packed else 3) + \
            B * S * H * D * q.element_size()
    elif kind == "layer_norm":
        x, gamma, beta = args
        rate, flops = "f32", 8 * key.m * key.n
        nbytes = _nbytes(x, gamma, beta) + key.m * key.n * x.element_size()
    elif kind == "decode_attn":
        q, k, v, pos = args[:4]
        live = int(pos.max()) + 1
        B, H, D, G = key.batch, key.heads, key.head_dim, key.groups
        rows = B * H * live * D
        rate, flops = "f32", 4 * rows * G
        nbytes = 2 * rows * k.element_size() + _nbytes(q, pos) + \
            q.numel() * 4
    elif kind == "int8_gemm":
        rate, flops = "int8", 2 * key.m * key.n * key.k
        nbytes = _nbytes(*args) + key.m * key.n * 4
    elif kind == "flash_train_fwd":
        q, k, v = args
        B, S, H, D = q.shape
        rate = key.dtype
        flops = 4 * B * H * D * (S * (S + 1) // 2 if key.causal else S * S)
        nbytes = 4 * _nbytes(q) + B * H * S * 4
    elif kind == "flash_train_bwd":     # S again, dP, dV, dQ, dK
        q = args[0]
        B, S, H, D = q.shape
        rate = key.dtype
        flops = 10 * B * H * D * (S * (S + 1) // 2 if key.causal else S * S)
        nbytes = _nbytes(*args) + 3 * _nbytes(q)
    elif kind == "batch_matmul":
        a, b, c = args
        rate = "f32" if mxu_dtype(key.dtype, key.precision) == \
            torch.float32 else "bf16"
        flops = 2 * key.batch * key.m * key.n * key.k
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(a, b, c) + key.batch * key.m * key.n * size
    elif kind == "chain_pingpong":     # R contractions of m x k x n
        x, w, bias = args
        rate = "f32" if key.precision == "highest" else "bf16"
        flops = key.repeats * 2 * key.m * key.dims[0] * key.dims[1]
        nbytes = _nbytes(x, w, bias) + key.m * key.dims[1] * x.element_size()
    elif kind == "grouped_gemm":
        # this routing's token rows (padding rows need no work) and the
        # weights of the experts it chose; every output row is written
        ge, a, b = args[-3:]
        rows = int((a != 0).any(-1).sum())
        experts = int(torch.unique(ge).numel())
        rate = "f32" if mxu_dtype(key.dtype, key.precision) == \
            torch.float32 else "bf16"
        flops = 2 * rows * key.n * key.k
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = (rows * key.k + experts * key.k * key.n) * a.element_size() \
            + key.m * key.n * size + _nbytes(ge)
    elif kind == "conv_nhwc":     # each tap's products; I, W, C, D, out
        rate = "f32" if mxu_dtype(key.dtype, key.precision) == \
            torch.float32 else "bf16"
        flops = 2 * key.N * key.P * key.Q * key.K * key.C * key.R * key.S
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(*args) + key.N * key.P * key.Q * key.K * size
    elif kind in ("blocked_matmul", "blocked_matmul_warm"):
        # the packed GEMM (repeats times for B20); A, B, C, bias, out
        rate = "f32" if mxu_dtype(key.dtype, key.precision) == \
            torch.float32 else "bf16"
        flops = 2 * key.Mb * key.Nb * key.Kb * key.mb * key.nb * key.kb * \
            max(1, key.repeats)
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(*args) + key.Mb * key.Nb * key.mb * key.nb * size
    elif kind == "conv_blocked":    # each tap's products; I, W, C, D, out
        rate = "f32" if mxu_dtype(key.dtype, key.precision) == \
            torch.float32 else "bf16"
        flops = 2 * key.N * key.P * key.Q * key.Kb * key.k * key.Cb * \
            key.c * key.R * key.S
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(*args) + \
            key.N * key.Kb * key.P * key.Q * key.k * size
    else:   # grouped_wgrad: the token rows of xt and dY, f32 dW
        ge, xt, dy = args
        rows = int((dy != 0).any(-1).sum())
        rate = "f32" if mxu_dtype(key.dtype, key.precision) == \
            torch.float32 else "bf16"
        flops = 2 * rows * key.k * key.n
        nbytes = rows * (key.k + key.n) * dy.element_size() + _nbytes(ge) \
            + key.n_groups * key.k * key.n * 4
    t_ops, t_bytes = flops / PEAK[rate], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes \
        else "bytes"


def _library_call(kind, key, args):
    """One PyTorch call computing the kernel's function on the same inputs,
    timed as a yardstick and used nowhere in the port; None where there is
    none: a chain of GEMMs (B3), B5's ping-pong, B11's repeats, a batched
    matmul with its softmax, and the int8 GEMM with its scaled epilogue
    (B15) have no single call. B1: torch.addmm (bias) or torch.mm; the
    attention kernels: scaled_dot_product_attention, forward, or for B18
    its backward alone (torch.autograd.grad of a kept forward); B21/B22:
    torch.bmm; B12: F.layer_norm; B19: torch.addmm on the unpacked
    operands; B23: F.conv2d on the unpacked NCHW operands and the
    epilogue, TF32 off; B20's repeats have no single call."""
    import torch
    import torch.nn.functional as F
    if kind == "brgemm" and not key.prologue and key.batch == 1 and \
            not key.transpose_b and not key.vnni:
        a, b, c, d = args[:4]
        if key.binary_kind == "add" and key.binary_bcast == "bcast_col":
            return lambda: torch.addmm(d, a[0], b[0])
        return lambda: torch.mm(a[0], b[0])
    if kind == "attention":
        E = key.heads * key.head_dim
        x = args[0]
        parts = (x[..., :E], x[..., E:2 * E], x[..., 2 * E:]) \
            if key.qkv_packed else args[:3]
        q, k, v = (t.reshape(key.batch, -1, key.heads, key.head_dim)
                   .transpose(1, 2).contiguous() for t in parts)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=key.causal, scale=key.scale)
    if kind == "attention_flat":     # the (B*H, S, D) rows as (1, B*H, S, D)
        q, k, v = (t[None] for t in args)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=key.causal, scale=key.scale)
    if kind == "batch_matmul" and key.beta0 and not key.softmax_lhs \
            and not key.lhs_shared:
        a, b, _ = args
        return lambda: torch.bmm(a, b)
    if kind == "layer_norm":
        x, gamma, beta = args
        gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
        return lambda: F.layer_norm(x, (key.n,), gamma, beta, key.eps)
    if kind == "decode_attn" and key.groups == 1 and not key.kv_quant \
            and not key.pack2:
        q, k, v, pos, li = args[:5]
        live = int(pos.max()) + 1
        kl, vl = (t[li][:, :, :live].contiguous() for t in (k, v))
        q4 = q[:, :, None]
        return lambda: F.scaled_dot_product_attention(
            q4, kl, vl, scale=key.head_dim ** -0.5)
    if kind in ("grouped_gemm", "grouped_wgrad"):
        return _grouped_mm_call(kind, key, args)
    if kind == "conv_nhwc":
        return _conv_library_call(key, args)
    if kind == "blocked_matmul" and key.binary_kind == "add" and key.beta0:
        # torch.addmm on the unpacked operands (unpacked here, untimed)
        a, b, _, d = args
        if key.vnni:
            b = b.movedim(-1, -2).reshape(key.Nb, key.Kb, key.kb, key.nb)
        a2 = a.permute(0, 2, 1, 3).reshape(key.Mb * key.mb, -1)
        b2 = b.permute(1, 2, 0, 3).reshape(key.Kb * key.kb, -1)
        bias = d.reshape(-1).to(a.dtype)
        return lambda: torch.addmm(bias, a2, b2)
    if kind == "conv_blocked":
        return _conv_blocked_library_call(key, args)
    if kind in ("flash_train_fwd", "flash_train_bwd"):
        q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(
            kind == "flash_train_bwd") for t in args[:3])
        if kind == "flash_train_fwd":
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=key.causal, scale=key.scale)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=key.causal,
                                           scale=key.scale)
        g = args[3].transpose(1, 2).contiguous()
        return lambda: torch.autograd.grad(o, (q, k, v), g,
                                           retain_graph=True)
    return None


def _conv_library_call(key, args):
    """F.conv2d on the NCHW view of the NHWC operands (channels_last, no
    copy) in their own dtype, TF32 off, then the plain version's epilogue
    (`reference._conv_epilogue`). None for an asymmetric padding, which
    F.conv2d does not take."""
    import torch
    import torch.nn.functional as F

    from tpp_mlir_tpu_torch.xsmm.reference import _conv_epilogue, no_tf32_conv
    pt, pb, pl, pr = key.pad
    if pt != pb or pl != pr:
        return None
    i, w, c, d = args
    x = i.permute(0, 3, 1, 2)
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def call():
        with no_tf32_conv():
            y = F.conv2d(x, wt, stride=(key.stride_h, key.stride_w),
                         padding=(pt, pl))
        acc = y.permute(0, 2, 3, 1).reshape(-1, key.K).float()
        return _conv_epilogue(key, acc, c, d)
    return call


def _conv_blocked_library_call(key, args):
    """_conv_library_call on B23's NHWC form (reference.conv_blocked_nhwc):
    the operands permuted here, untimed."""
    from tpp_mlir_tpu_torch.xsmm.reference import conv_blocked_nhwc
    nkey, ops = conv_blocked_nhwc(key)
    return _conv_library_call(nkey, [None if t is None else t.contiguous()
                                     for t in ops(*args)])


def _grouped_mm_call(kind, key, args):
    """torch._grouped_mm on the same rows, the groups cut at the padded
    group boundaries (B16: (rows, k) x (G, k, n); B17: the (k, rows) x
    (rows, n) form giving (G, k, n)). It has no epilogue, so a key with a
    unary has no such call, and it writes its operands' dtype (bf16) where
    the kernel writes f32: PyTorch 2.11 refuses an f32 output there."""
    import torch
    if not hasattr(torch, "_grouped_mm") or (
            kind == "grouped_gemm" and (key.unary_kind or key.layers)):
        return None
    ge = args[-3] if kind == "grouped_gemm" else args[0]
    offs = (torch.bincount(ge.long(), minlength=key.n_groups)
            * key.bm).cumsum(0).to(torch.int32)
    if kind == "grouped_gemm":
        _, x, b = args
        y = b.transpose(-2, -1) if key.transpose_b else b    # (G, k, n)
    else:
        _, x, y = args
    return lambda: torch._grouped_mm(x, y, offs=offs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import tpp_mlir_tpu_torch    # noqa: F401  (fail before any output
                                 # outside a checkout)
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    stats = phase_kernels()
    stats.update(phase_flash_train())
    stats.update(phase_grouped_kernels())
    for kind, st in phase_mha_kernels().items():
        worst = max(st["max_abs_err"], stats.get(kind, {}).get(
            "max_abs_err", 0.0))
        stats[kind] = {"max_abs_err": worst}
    stats.update(phase_conv_kernels())
    stats.update(phase_packed_kernels())
    launches = phase_main_path()
    for kind, n in phase_transformer_path().items():
        launches[kind] += n
    serve_launches, setups = phase_serving_path()
    moe_launches, moe_setup = phase_moe_serving()
    for counts in (serve_launches, phase_serving_flash(setups[0]),
                   moe_launches, phase_mlp_training(), phase_gpt_training(),
                   phase_moe_training(), phase_mha_suite(),
                   phase_conv_suite(), phase_packed_suite()):
        for kind, n in counts.items():
            launches[kind] += n
    timing = phase_timing()
    phase_serving_timing(setups)
    phase_moe_serving_timing(moe_setup)
    kernels = []
    for kind, src, replaces in (
            ("brgemm", "brgemm.cu", "kernels.py:580"),
            ("chain", "chain.cu", "kernels.py:1475"),
            ("attention", "attention.cu", "kernels.py:2232"),
            ("layer_norm", "layer_norm.cu", "kernels.py:3257"),
            ("decode_attn", "decode_attn.cu", "decode_attn.py:101"),
            ("int8_gemm", "int8_gemm.cu", "kernels.py:1365"),
            ("flash_train_fwd", "flash_train.cu", "flash_train.py:146"),
            ("flash_train_bwd", "flash_train.cu", "flash_train.py:190"),
            ("grouped_gemm", "grouped_gemm.cu", "kernels.py:1138"),
            ("grouped_wgrad", "grouped_gemm.cu", "kernels.py:1283"),
            # one kernel for the five flat TPU kernels (B6, B8, B9, B10a,
            # B10b: :1660, :2395, :2721, :2496, :2618)
            ("attention_flat", "attention.cu", "kernels.py:1660"),
            ("attention_bench", "attention.cu", "kernels.py:2091"),
            ("batch_matmul", "batch_matmul.cu", "kernels.py:963"),
            ("chain_pingpong", "chain.cu", "kernels.py:1919"),
            # one kernel for B24 (window) and B25 (fullrow, :3117)
            ("conv_nhwc", "conv.cu", "kernels.py:2919"),
            ("blocked_matmul", "blocked_matmul.cu", "kernels.py:763"),
            ("blocked_matmul_warm", "blocked_matmul.cu", "kernels.py:870"),
            # B24's kernel in the channel-blocked layout
            ("conv_blocked", "conv.cu", "kernels.py:2778")):
        also = {"attention_flat": [":2395", ":2496", ":2618", ":2721"],
                "batch_matmul": [":1065"], "conv_nhwc": [":3117"]}.get(kind)
        kernels.append({"name": kind, "route": "cuda",
                        "source": f"tpp_mlir_tpu_torch/csrc/{src}",
                        "replaces": f"tpp_mlir_tpu/xsmm/{replaces}",
                        **({"also_replaces": [f"tpp_mlir_tpu/xsmm/kernels.py"
                                              f"{x}" for x in also]}
                           if also else {}),
                        "launches": launches[kind],
                        # phase 3's worst case; packed parity mode's
                        # kinds take phase 5's at the line's key
                        "max_abs_err": stats[kind]["max_abs_err"],
                        **timing[kind]})
    say(f"total: {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
