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
     and a GQA case through the autograd op, B18 twice bit-equal);
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
  5. time the same paths: the MLP at -n 100 beside torch.matmul+bias+relu,
     each transformer forward lowered beside --linalg-to-loops (GPT-2
     tokens/s), each serving configuration's prefill and decode step
     (eager and graph-replayed) beside the kernels-off engine, with a
     torch.profiler trace of 8 decode steps, and each kernel beside its
     plain version, one PyTorch call computing the same function where
     there is one, and its bound (bytes over HBM's rate or operations over
     the peak rate of their type, whichever is larger).
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
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

    from tpp_mlir_tpu_torch.xsmm.kernels import chain_smem_bytes
    for mxu, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        want = lib.tpp_chain_smem_bytes(WIDTH, code)
        if want != chain_smem_bytes(WIDTH, mxu):
            raise AssertionError(f"chain_smem_bytes {chain_smem_bytes(WIDTH, mxu)}"
                                 f" != kernel's {want}")


def _tol(key) -> float:
    """max|kernel - plain| / max|plain| allowed for `key`. A single GEMM with
    an f32 output rounds its operands exactly as its plain version does
    (f32 "default" included: bf16 operands on both sides), so only the sum
    order differs. A chain re-rounds each layer's input to the MXU dtype,
    and so does a LayerNorm prologue its normalized rows, where a sum-order
    difference can flip a bf16 rounding: only their f32 "highest" forms are
    held to TOL_F32. Attention holds f32 "highest" to TOL_F32 and else
    TOL_BF16 (the kernel rounds the unnormalized P and divides after P.V,
    the plain version normalizes first, as B7 does); LayerNorm an f32
    output to TOL_F32."""
    from tpp_mlir_tpu_torch.xsmm import (BrgemmKey, DecodeAttnKey,
                                         Int8GemmKey, LayerNormKey)
    if isinstance(key, DecodeAttnKey):
        return TOL_F32      # f32 math from the same values: sum order only
    if isinstance(key, Int8GemmKey):
        return TOL_INT8 if key.out_dtype == "f32" else TOL_BF16
    out_f32 = (key.out_dtype or key.dtype) == "f32"
    if isinstance(key, LayerNormKey):
        return TOL_F32 if out_f32 else TOL_BF16
    if isinstance(key, BrgemmKey) and not key.prologue:
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
         "FlashTrainBwdKey": "flash_train_bwd"}


def _launches(cache) -> dict:
    counts = cache.launches_by_kind()
    return {kind: counts.get(name, 0) for name, kind in KINDS.items()}


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
    from tpp_mlir_tpu_torch.tools.trace import describe
    for kind, key, make in cases:
        args = make(key, g)
        kern, plain = build_kernel(key), reference_kernel(key)
        library = _library_call(kind, key, args)
        graphed = kind in ("decode_attn", "int8_gemm")
        # the serving kernels run inside the decode step's CUDA graph: their
        # line and the kernel table take graph-replayed times
        timer = graph_ms if graphed else cuda_ms
        ms, plain_ms = timer(lambda: kern(*args)), timer(lambda: plain(*args))
        lib_ms = timer(library) if library else None
        bound, by = _bound(kind, key, args)
        note = " (replayed from a CUDA graph)" if graphed else ""
        lib = f"{lib_ms:.4f} ms" if library else "none"
        say(f"time kernel {describe(key):44s} {ms:.4f} ms, plain version "
            f"{plain_ms:.4f} ms, library call {lib}, bound {bound:.4f} ms "
            f"({by}){note}")
        # the kernel line keeps the first shape of each kind: the MLP's f32
        # fc for brgemm, the bf16 flagship chain, GPT-2's attention and
        # ln_f, the serving decode attention (MHA), the int8 QKV GEMM, and
        # B14/B18 at the GPT-2 training key
        out.setdefault(kind, {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "bound_by": by,
                              "library_ms": lib_ms})
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
    elif kind == "attention":
        q = args[0]
        B, S, H, D = key.batch, key.seq, key.heads, key.head_dim
        pairs = S * (S + 1) // 2 if key.causal else S * key.seq_kv
        rate = "f32" if key.precision == "highest" else "bf16"
        flops = 4 * B * H * pairs * D
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
    else:   # flash_train_bwd: S again, dP, dV, dQ, dK
        q = args[0]
        B, S, H, D = q.shape
        rate = key.dtype
        flops = 10 * B * H * D * (S * (S + 1) // 2 if key.causal else S * S)
        nbytes = _nbytes(*args) + 3 * _nbytes(q)
    t_ops, t_bytes = flops / PEAK[rate], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes \
        else "bytes"


def _library_call(kind, key, args):
    """One PyTorch call computing the kernel's function on the same inputs,
    timed as a yardstick and used nowhere in the port; None where there is
    none: a chain of GEMMs (B3) and the int8 GEMM with its scaled epilogue
    (B15) have no single call. B1: torch.addmm (bias) or torch.mm; the
    attention kernels: scaled_dot_product_attention, forward, or for B18
    its backward alone (torch.autograd.grad of a kept forward); B12:
    F.layer_norm."""
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
    launches = phase_main_path()
    for kind, n in phase_transformer_path().items():
        launches[kind] += n
    serve_launches, setups = phase_serving_path()
    for counts in (serve_launches, phase_serving_flash(setups[0]),
                   phase_mlp_training(), phase_gpt_training()):
        for kind, n in counts.items():
            launches[kind] += n
    timing = phase_timing()
    phase_serving_timing(setups)
    kernels = []
    for kind, src, replaces in (
            ("brgemm", "brgemm.cu", "kernels.py:580"),
            ("chain", "chain.cu", "kernels.py:1475"),
            ("attention", "attention.cu", "kernels.py:2232"),
            ("layer_norm", "layer_norm.cu", "kernels.py:3257"),
            ("decode_attn", "decode_attn.cu", "decode_attn.py:101"),
            ("int8_gemm", "int8_gemm.cu", "kernels.py:1365"),
            ("flash_train_fwd", "flash_train.cu", "flash_train.py:146"),
            ("flash_train_bwd", "flash_train.cu", "flash_train.py:190")):
        kernels.append({"name": kind, "route": "cuda",
                        "source": f"tpp_mlir_tpu_torch/csrc/{src}",
                        "replaces": f"tpp_mlir_tpu/xsmm/{replaces}",
                        "launches": launches[kind],
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
