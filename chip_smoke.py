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
     q/k/v, and at B 1, S 16 and 32; decode attention at B 8, H 12, S 1024,
     D 64, L 12 and its slotted, GQA, int8-KV, pack2 and f32 variants, and
     at B 1 over a 2-layer cache, each line naming
     reference.decode_attn_plan's chunk and split count, each launched
     twice bit-equal; the int8 GEMM (B15) at the four prefill shapes and
     a ragged m, each line naming reference.int8_gemm_route's body and
     int8_gemm_plan's tile, stages, split, tiles and grid (the C launcher
     refuses another), launched twice and with the first design forced
     (build_int8 "wmma"), all bit-equal; the row LayerNorm (B12) at
     GPT-2's ln_f and the encoder's key, naming reference.layer_norm_route's
     body, and with the first design forced (build_layer_norm "strided")
     held to the plain version too; for training: B1 forward and
     transpose_b (dx) at the MLP rows' shapes, B14 and B18 at the GPT-2
     training key B 8, S 512, H 12, D 64 causal bf16, an f32 key at D 128
     and a GQA case through the autograd op, B18 twice bit-equal; for MoE:
     B16 at the prefill's fc1 (gelu) and fc2, the training step's z1 and
     its two transpose_b dgrads (9216 padded rows), a bm 16 key, a stacked
     `layers` key and a skewed routing, and the wgmma tile's edges (bm 64,
     n and k off its 128/64 tiles, a stacked table under transpose_b, an
     f32 output, experts that own no row block), padding rows exactly
     zero, each line naming the tile reference.grouped_gemm_route chose;
     B17 at dw2 and dw1 and a skewed routing, twice bit-equal, an expert no
     token chose exactly zero);
  4. run the main paths, each with the launch counts set to 0 just before
     and read just after:
     a. the MLP path through tpp_mlir_tpu_torch.tools.tpp_run.run_module on
        tpp-gen output (flagship MLP 256 x 1024x4 bias+relu in bf16 and f32,
        the fc 256x1024x1024 bias+relu, the matmul 256x1024x1024): the
        flagship must lower to one xsmm.fused_chain, both kernels' launch
        counts must move, and each output must match --linalg-to-loops;
        then the compiler's general path (ROADMAP A3,
        phase_compiler_path): tpp-gen --output=generic's flagship in bf16
        and f32 (one xsmm.fused_chain, bit-equal to the named form, both
        timed from a CUDA graph of 100 forwards), the fc with --softmax in
        f32 "default", f32 "highest" and bf16 (one B1 fused_brgemm, then
        decompose-softmax's reduce/sub/exp/reduce/div as PyTorch ops; rows
        summing to 1, the softmax against the f32 softmax of its own
        logits; the f32 "default" and bf16 readings against
        --linalg-to-loops printed, not held), the f32 fc through
        split-reduction-dim{tile=256} (one B1 dispatch of batch 4 against
        the un-split lowering and its plain version) and the imported
        Conv2d-BN-ReLU-MaxPool2d-AvgPool2d-Linear stack at N 8, 128
        channels, 32x32 (conv.cu) against the torch module; brgemm, chain
        and conv_nhwc must launch;
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
        then its serving modes (ROADMAP A8, phase_serving_modes): 24
        requests (prompts of 1-512 tokens from default_rng(0), max_new 64)
        through 8 slots by the host scheduler (sync 8) and the device
        scheduler (sync 64, waves of 16), beam search (b2, prompt 512, 4
        beams, 32 steps) and speculative decoding (b1, prompt 512, k 4, 64
        steps, a 2-layer trunk draft): each mode's eager run with exact B7
        and B13 launch counts, its CUDA-graph run's tokens equal to it,
        every token the kernels-off engine's teacher-forced argmax or
        within 3e-2 of its max|logit|, beam W=1 equal to make_generate and
        the best beam's score its teacher-forced log-probability; timed
        second passes (tokens/s of each scheduler beside static batching on
        the same trace, beam ms/step, speculative tokens/s and acceptance
        beside plain greedy);
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
     the peak rate of their type, whichever is larger), and B16's
     WMMA tile forced at the fc2 and fc1 keys beside its wgmma tile, in
     turns; B15 at the four prefill keys from a CUDA graph beside the
     composed torch._int_mm + scales + bias + unary chain (not one call)
     and its first design forced, in turns; B12 from a CUDA graph beside
     F.layer_norm, its first design forced in turns and an empty kernel's
     launch from a graph (the card's floor); for the MHA suite
     the flat attention at each TPU kernel's own key (B9 at the S 1024
     rows, B8 at S 2048, B10b/B10a at causal S 2048, B6 with forced
     blocks), B11 at -n 20, the batched matmul at mha_qk's and
     mha_softmax_v's keys and B5 at fc_128x768x2304 with -n 100; csrc/conv.cu
     at the conv kernel cases' keys beside F.conv2d + the epilogue (TF32
     off; for f32 "default" keys also F.conv2d on bf16 copies of I and W,
     the function the key computes), eagerly and from a CUDA graph, and
     its tile body forced to "wmma" beside its wgmma kernel in turns; B19
     at the fc rows' keys beside torch.addmm on the unpacked
     operands, B20 at them with -n 200 as repeats, B23 at the packed conv
     rows' keys beside F.conv2d on the unpacked operands + the epilogue;
     decode attention (B13) from a CUDA graph whose launches walk the 12
     stacked layers, as a decode step reads them (the line's times, beside
     SDPA on each layer's live rows), and replaying layer 5 alone (which
     L2 can hold);
     each of these held against its plain version there too, the kernel
     line's max_abs_err for the three taken at the key whose ms it shows.
Phase 3 also holds the MHA suite's kernels: flat attention at every
flash_attention key and mha_full's, each forced strategy (grouped, qblock,
twocall, twocall2 on the flat layout; flash_heads and xla on the token
layout), B11 at repeats 3 (bf16 S 1024 D 128, and a causal key), the
wgmma attention kernel's edges (S 77 and 1000, seq_kv != seq, causal with S
below its 128-row block, D 32/64/128, packed and split, repeats 2, the f32
register loader), each line naming the loader reference.attention_loader
chose, the
batched matmul at mha_qk's and mha_softmax_v's keys, an lhs_shared and a
non-beta0 key, and B5 at fc_128x768x2304 with repeats 2 and 3; and
csrc/conv.cu (B24/B25) at the keys default-tpp-passes makes of the conv
suite (conv3x3_fp32_b8_c128_k128_30's layer at f32 "default" and "highest",
its bf16 form, c256 at 16x16, the 1x1 W 14 key, the same-padded residual
bf16 key, forced fullrow and window, and the c128/30 key on the forced
"wmma" tile body), each line naming reference.conv_kernel_route's body and
conv_plan's tile and split, and the xla route at the ViT's patch
conv at "highest" against the same plain version (TF32 would miss it); and
packed parity mode's kernels: csrc/blocked_matmul.cu (B19) at the fc rows'
key in f32 "default", f32 "highest" and bf16 VNNI, a masked mb 8 key and
the ViT's gelu fc1, B20 at repeats 3 in f32 "default" (the fc_fp32 row's
own key, which its -n runs), f32 "highest" and bf16, and
csrc/conv.cu's channel-blocked entry (B23) at the c128/30 key in f32 and
bf16, the c256/16 key (Cb 2) and the imported ResNet block's two keys (a C
accumulator). Phase 5 times B19, B20 and B23 at those rows' keys.
Phase 3 also holds csrc/warm_panel.cuh (chain.cu's B3/B4/B5 and B20 on the
warm-panel engine): every chain, ping-pong and B20 key launched twice
bit-equal, a ragged-row and a masked-width chain, and each body
(reference.chain_route / warm_route: the engine, or the first design's
WMMA body) forced at the flagship, B5 and B20 keys, after printing the
card's cudaOccupancyMaxActiveClusters at each main key's plan beside
reference.H100_WARM_CLUSTERS. Phase 5 times B3 (also from a CUDA graph),
B4 at -n 100, B5 and B20 beside the composed PyTorch chain (addmm + relu
a layer and repeat on bf16 copies; B5 then h @ W^T) replayed from a CUDA
graph, and the MLP rows' torch.matmul chain from a CUDA graph too.
Phase 3 also holds B2's LN-stats pair (csrc/brgemm.cu through the
kernel-key API): a GPT-2 fc-class producer (m 2048, k 768, n 3072, + bias,
gelu, ln_stats_out) and its ln_stats consumer (k 3072, n 768), in bf16, f32
"default" and f32 "highest", and at n 3000 (no multiple of a tile): y and
the consumer against their plain versions, the mean and var against the
plain statistics of the producer's own y (1e-5), both launched twice
bit-equal; phase 4 runs the bf16 pair through the kernel cache (two
launches), and phase 5 times the pair from a CUDA graph beside its plain
versions and the composed addmm -> F.layer_norm -> addmm chain. The LoRA
slice (ROADMAP A7, A10) at GPT-2 small's full width, bf16: int4 serving
(packed int4 weights, b8, prompt 512, 16 steps: launches, graph == eager,
logits against the kernels-off engine, greedy tokens against its argmax
where the margin exceeds the noise, the weight bytes beside int8's); LoRA
and QLoRA on bf16, int8 and int4 bases (B 4 x S 512, rank 8 on wq/wv,
AdamW, 5 steps: step-0 adapter grads against the kernels-off route, the
losses, ms a step, B14/B18 launches), the merged model served (B7, B13);
the step with remat on and off (losses, peak memory); and a checkpoint of
adapters and optimizer state resumed bit-equal to the uninterrupted run.
The parallel layer (ROADMAP A11, `phase_parallel`): a world of one over
NCCL in this process at full width (GPT-2 small bf16's tp decode, b8,
prompt 512, 16 steps, eager and replayed from a CUDA graph with its NCCL
all-reduces inside, fed the eager tokens and bit-equal; its AdamW train
step with zero1 and vocab_parallel, B 8 x S 512; the MLP 1024x4 SGD step
at b256; the Megatron MHA at b8 s512; GPipe over 4 microbatches; causal
ring attention at S 2048; the ep MoE over 2048 tokens), then a world of
two ranks on the one card over gloo (NCCL refuses two ranks on one
device; a gloo collective on CUDA tensors runs through pinned host
memory): the decode at tp 2 in f32 (greedy tokens equal to the one-device
decode) and bf16 (logits teacher-forced within 3e-2), eagerly; the train
step at tp 2 (step-0 loss within 1e-2, grads within 3e-2 jointly), the
MLP step and MHA at tp 2, the pipeline at P 2, ring attention at sp 2 and
the MoE at ep 2, each against its one-device run; every rank holds each
kernel key it launched against its plain version. Launches are counted in
each world's path alone; the tp-local keys (B7, B14, B18 at 6 heads, B13
at 6 KV heads, B1 at 512 columns or rows) are timed after phase 5 and
join the kernel line as rows of their own.
The tuning layer and the user API (ROADMAP A5 + A12, `phase_tuning`,
after phase 4a): (a) every legal forced plan (xsmm/tune.py's trial) of fc
256x1024x1024 in f32 "default", bf16 and f32 "highest", GPT-2's LN QKV,
the ragged n 136/200/3000 keys (a fused GEMM with C and a full residual
under every tile and split, the ln_stats_out producers under every tile)
and B19's fc key against its plain version at the key's tolerance, the
plan each Kernel records equal to the C++ launcher's (tpp_gemm_plan) and
its heuristic to the Python mirror's, splits launched twice bit-equal,
every illegal plan raising; the flagship chain at every panel rows x
cluster warm_plan places and the card holds; (b) tpp_run's
--register-blocking 64,128,256 on the fc (64 x 128, split 4) against
--linalg-to-loops, its launches counted; (c) tpp-tune on the bf16
flagship and on the fc's GEMM key, in subprocesses writing a temporary
table, each sweep row beside the heuristic's; (d) examples/torch/01-06 on
the card, all started together, each exiting 0.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
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
# one bf16 grad leaf of the tp train step against the one-device step: the
# sound runs' worst leaf reads 3.62e-2 (blocks.10.bq, a nearly cancelling
# grad); a tp fault (a grad counted tp times, a reduction left out) moves a
# leaf by 0.5 or more
TOL_GRAD_LEAF = 1e-1
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
    fn = ""
    for line in info.log.splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        if "registers" in line or "spill" in line or "smem" in line:
            say(f"  ptxas: {line.strip()}")
        if "spill" in line and " 0 bytes spill stores" not in line:
            say(f"  ptxas: spills in {fn}")
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
        # the convert loader at a row stride TMA cannot take (n 100) and
        # on a K-major f32 B
        ("misaligned n 100 bf16", BrgemmKey(1, 1000, 100, 96, "bf16",
                                            binary_kind="add",
                                            unary_kind="relu")),
        ("transpose_b f32", BrgemmKey(1, M, N, K, "f32", beta0=True,
                                      transpose_b=True)),
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
    non-causal, f32 "default", packed), and its shape at "highest"; the
    serving modes' batch-1 prefills at the 16- and 32-token buckets."""
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
        # the serving modes' bucketed batch-1 prefills below the kernel's
        # 64-row tiles (continuous batching's 16- and 32-token buckets)
        ("attn serve b1 s16 h12 d64 causal split", FlashMhaKey(
            1, 16, 16, 64, "bf16", scale=0.125, causal=True, heads=12)),
        ("attn serve b1 s32 h12 d64 causal split", FlashMhaKey(
            1, 32, 32, 64, "bf16", scale=0.125, causal=True, heads=12)),
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
    + 127 steps; beam search's b2 x 4 beams takes the same key) and its
    variants; batch 1 (the speculative draft's, the 2-layer trunk)."""
    from tpp_mlir_tpu_torch.xsmm import DecodeAttnKey
    geo = dict(batch=8, seq=1024, head_dim=64, stacked=12)
    return [
        ("mha b8 h12 s1024 d64 bf16 (beam b2x4)",
         DecodeAttnKey(heads=12, **geo)),
        ("slotted, one sentinel", DecodeAttnKey(heads=12, slotted=True,
                                                **geo)),
        ("gqa kv4 g3", DecodeAttnKey(heads=4, groups=3, **geo)),
        ("int8 kv", DecodeAttnKey(heads=12, kv_quant=True, **geo)),
        ("pack2", DecodeAttnKey(heads=12, pack2=True, **geo)),
        ("mha f32", DecodeAttnKey(heads=12, dtype="f32", **geo)),
        ("b1 trunk draft, 2 layers", DecodeAttnKey(
            heads=12, batch=1, seq=1024, head_dim=64, stacked=2)),
    ]


def _decode_attn_inputs(key, g):
    """q, the stacked K/V cache (normal values, or int8 payloads with
    scales as quantize_tokens makes them), pos, the layer index (5, or the
    last of fewer layers), and the int8 cache's scales."""
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
    return q, k, v, pos, min(5, key.stacked - 1), k_s, v_s


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
    makes them (quantize_tokens, quantize), a bf16 bias (None without one)
    and the weight's K-major copy the wgmma body reads (QTensor.qt, which
    the engine makes once): (xq, wq, xscale, wscale, bias, wt)."""
    import torch

    from tpp_mlir_tpu_torch.serving import quantize, quantize_tokens
    xq, xs = quantize_tokens(torch.randn(key.m, key.k, generator=g,
                                         device="cuda"))
    w = quantize(torch.randn(key.k, key.n, generator=g, device="cuda")
                 * key.k ** -0.5)
    bias = torch.randn(key.n, generator=g, device="cuda").to(torch.bfloat16)
    return xq, w.q, xs, w.scale, bias if key.has_bias else None, \
        w.q.t().contiguous()


def _warm_note(key, route: str | None = None) -> str:
    """chain.cu's or B20's body (reference.chain_route / warm_route, or
    `route` forced) and, on the warm-panel engine, its plan."""
    from tpp_mlir_tpu_torch.xsmm import ChainKey
    from tpp_mlir_tpu_torch.xsmm.reference import (chain_route, warm_plan,
                                                   warm_route)
    route = route or (chain_route(key) if isinstance(key, ChainKey)
                      else warm_route(key))
    if route != "panel":
        return f"; route {route}"
    p = warm_plan(key)
    return f"; route panel, rows {p.rows}, cluster {p.cluster}, tiles " \
        f"{p.tiles}, {'resident' if p.resident else 'streamed'}, " \
        f"{p.clusters} clusters"


def _int8_note(key) -> str:
    """B15's route and reference.int8_gemm_plan (the C launcher refuses a
    plan that differs from its own)."""
    from tpp_mlir_tpu_torch.xsmm.reference import (int8_gemm_plan,
                                                   int8_gemm_route)
    p = int8_gemm_plan(key)
    return f"; route {int8_gemm_route(key)}, tile {p.bm}x{p.bn}, " \
        f"{p.stages} stages, split {p.split}, {p.tiles} tiles, grid " \
        f"{p.grid}{' persistent' if p.persistent else ''}, {p.smem} B " \
        f"shared memory"


def _route_note(key, xt_stride=None) -> str:
    """The loader (attention.cu; B1/B2 and B19 with the launcher's tile and
    k split) or tile (B16, B17: at xt's strides) or kernel (B14 and B18,
    the batched matmul) or body (conv.cu, with its tile and k split; chain.cu
    and B20, with the warm-panel engine's plan; B12; B15 with its plan) or
    split (decode attention) the wrapper chose."""
    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                         BrgemmKey, ChainKey, ConvBrgemmKey,
                                         ConvNhwcKey, DecodeAttnKey,
                                         FlashMhaKey, FlashTrainBwdKey,
                                         FlashTrainKey, GroupedGemmKey,
                                         GroupedWgradKey, Int8GemmKey,
                                         LayerNormKey)
    if isinstance(key, DecodeAttnKey):
        from tpp_mlir_tpu_torch.xsmm.reference import decode_attn_plan
        chunk, splits = decode_attn_plan(key)
        return f"; chunk {chunk} rows, splits {splits}"
    if isinstance(key, Int8GemmKey):
        return _int8_note(key)
    if isinstance(key, LayerNormKey):
        from tpp_mlir_tpu_torch.xsmm.reference import (LN_MAX_VPL,
                                                       layer_norm_route)
        route = layer_norm_route(key)
        es = 4 if key.dtype == "f32" else 2
        vpl = f", {-(-key.n * es // 16 // 32)} of {LN_MAX_VPL} 16-byte " \
            f"vectors a lane" if route == "register" else ""
        return f"; route {route}{vpl}"
    if isinstance(key, (ConvNhwcKey, ConvBrgemmKey)):
        from tpp_mlir_tpu_torch.xsmm.reference import (conv_kernel_route,
                                                       conv_plan)
        route = conv_kernel_route(key)
        if route not in ("tma", "convert"):
            return f"; route {route}"
        bm, bn, split = conv_plan(key)
        return f"; route {route}, tile {bm}x{bn}, split {split}"
    if isinstance(key, ChainKey) or (isinstance(key, BlockedMatmulKey)
                                     and key.repeats):
        return _warm_note(key)
    if isinstance(key, (BrgemmKey, BlockedMatmulKey)):
        from tpp_mlir_tpu_torch.xsmm.kernels import gemm_plan
        from tpp_mlir_tpu_torch.xsmm.reference import (blocked_matmul_route,
                                                       brgemm_route)
        route = brgemm_route(key) if isinstance(key, BrgemmKey) \
            else blocked_matmul_route(key)
        if route not in ("tma", "convert"):
            return f"; route {route}"
        bm, bn, split, _ = gemm_plan(key)
        return f"; route {route}, tile {bm}x{bn}, split {split}"
    from tpp_mlir_tpu_torch.xsmm.reference import (attention_loader,
                                                   attention_route,
                                                   batch_matmul_route,
                                                   flash_train_bwd_route,
                                                   flash_train_fwd_route,
                                                   grouped_gemm_route,
                                                   grouped_wgrad_route)
    if isinstance(key, FlashMhaKey) and \
            attention_route(key) in ("kernel", "bench"):
        return f"; loader {attention_loader(key)}"
    if isinstance(key, GroupedGemmKey):
        return f"; route {grouped_gemm_route(key)}"
    if isinstance(key, GroupedWgradKey):
        return f"; route {grouped_wgrad_route(key, xt_stride)}"
    if isinstance(key, FlashTrainKey) and \
            not isinstance(key, FlashTrainBwdKey):
        return f"; B14 route {flash_train_fwd_route(key)}, B18 route " \
            f"{flash_train_bwd_route(key)}"
    if isinstance(key, BatchMatmulKey):
        return f"; route {batch_matmul_route(key)}"
    return ""


def phase_kernels() -> dict:
    """Each kernel against its plain version on the same inputs."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    from tpp_mlir_tpu_torch.xsmm.kernels import build_int8, build_layer_norm
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
            if kind in ("decode_attn", "chain"):
                # the split merge sums in split order, whatever order the
                # blocks ran in; the warm-panel engine has no atomics
                same = torch.equal(build_kernel(key)(*args), got)
                ok = ok and same
                note = f" (second launch bit-equal: {same})"
            if kind == "int8_gemm":
                # exact s32 sums and one epilogue order: the wgmma body is
                # bit-equal across launches and to the first design forced
                same = torch.equal(build_kernel(key)(*args), got)
                old = torch.equal(build_int8(key, "wmma")(*args), got)
                ok = ok and same and old
                note = f" (second launch bit-equal: {same}; forced wmma " \
                    f"bit-equal: {old})"
            if kind == "layer_norm":
                rel_s, _ = rel_err(build_layer_norm(key, "strided")(*args),
                                   ref)
                ok = ok and rel_s <= tol
                note = f" (forced strided rel {rel_s:.3e})"
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
                f"tol {tol:.0e}{note}{_route_note(key)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} {label}: rel {rel} > {tol}")
            worst = max(worst, ab)
        stats[kind] = {"max_abs_err": worst}
    return stats


# B14/B18 cases: (label, key, KV heads of a GQA case or None). The GPT-2
# training key, an f32 key (no tensor cores: f32 FMA), a GQA case whose
# K/V are repeated to the query heads before the kernels, as
# flash_attention_train does, and the edges of attention.cu's training
# mode: a ragged S (rows past seq, a partial K/V tile), D 32 (64-byte
# swizzle) and D 128
def _flash_train_cases():
    from tpp_mlir_tpu_torch.xsmm import FlashTrainKey
    return [
        ("gpt2 train b8 s512 h12 d64 causal bf16",
         FlashTrainKey(TRAIN_B, 12, TRAIN_S, 64, "bf16", True, 0.125), None),
        ("f32 b2 s256 h4 d128", FlashTrainKey(2, 4, 256, 128, "f32", False,
                                              128 ** -0.5), None),
        ("gqa b2 s256 h12 kv4 d64 causal bf16",
         FlashTrainKey(2, 12, 256, 64, "bf16", True, 0.125), 4),
        ("ragged b2 s200 h4 d64 causal bf16",
         FlashTrainKey(2, 4, 200, 64, "bf16", True, 0.125), None),
        ("d32 b2 s256 h8 causal bf16",
         FlashTrainKey(2, 8, 256, 32, "bf16", True, 32 ** -0.5), None),
        ("d128 b2 s256 h4 bf16", FlashTrainKey(2, 4, 256, 128, "bf16", False,
                                               128 ** -0.5), None),
        # pass 1's second 128-row block: its diagonal in both warpgroups
        ("s192 b2 h4 d64 causal bf16",
         FlashTrainKey(2, 4, 192, 64, "bf16", True, 0.125), None),
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
    same inputs bit-equal (no atomics), and B18 fed B14's own lse2 and
    delta ("fed") within the same tolerance of the plain B18. The GQA case
    also runs the autograd op flash_attention_train on 4 KV heads against
    the plain versions with the group sums of dk/dv taken by hand."""
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
        fed = bwd(q, kr, vr, do, lse2, _flash_delta(do, o))
        want = reference_kernel(bkey)(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rels = {"o": rel_err(o, po), "lse2": rel_err(lse2, plse2)}
        rels.update({n: rel_err(a, b) for n, a, b in
                     zip(("dq", "dk", "dv"), got, want)})
        rels.update({f"fed {n}": rel_err(a, b) for n, a, b in
                     zip(("dq", "dk", "dv"), fed, want)})
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
            f"{TOL_LSE:.0e}){_route_note(key)} {'ok' if ok else 'FAIL'}")
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
             "blocked_matmul_warm", "brgemm_ln_stats")


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
    if kind == "brgemm" and (key.prologue == "ln_stats" or key.ln_stats_out):
        return "brgemm_ln_stats"
    return kind


# each kind's launches by the csrc/ source its kernels were built with
# (Kernel.source, recorded where the wrapper chose its route): the kernel
# line names the source of most of a kind's counted launches
SOURCES: dict = {}


def _launches(cache) -> dict:
    out = dict.fromkeys((*KINDS.values(), *SHARED_KINDS), 0)
    for fn in cache.kernels():
        kind = _kind(fn.key)
        if kind:
            out[kind] += fn.launches
            if fn.launches:
                seen = SOURCES.setdefault(kind, {})
                seen[fn.source] = seen.get(fn.source, 0) + fn.launches
    return out


def _source(kind: str) -> str:
    """The csrc/ source of most of a kind's counted launches; for a kind
    counted outside _launches, the one source its built kernels share."""
    if SOURCES.get(kind):
        return max(SOURCES[kind].items(), key=lambda kv: kv[1])[0]
    from tpp_mlir_tpu_torch.xsmm import global_cache
    built = {fn.source for fn in global_cache().kernels()
             if _kind(fn.key) == kind}
    if len(built) != 1:
        raise AssertionError(f"{kind}: no counted launch, and its kernels "
                             f"were built from {sorted(map(str, built))}")
    return built.pop()


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


# the tuning layer and the user API (ROADMAP A5 + A12): forced launch plans
# (xsmm/tune.py), tpp-run's --register-blocking, tpp-tune, the examples
TUNE_FC = dict(batch=1, m=256, n=1024, k=1024, beta0=True, binary_kind="add",
               unary_kind="relu")
TUNE_FC_GEN = "--batch=256 --layers=1024,1024 --bias --relu"
TUNE_FLAGSHIP_GEN = \
    "--batch=256 --layers=1024,1024,1024,1024 --bias --relu --float-type=bf16"
REGISTER_BLOCKING = (64, 128, 256)      # 64 x 128 tiles, split 1024/256 = 4
# the ragged widths of the LN-stats cases (n 136, 200, 3000), as a fused
# GEMM with C and a full-width residual under every tile and split, and the
# tests' ln_stats_out producers under every tile (no split)
TUNE_RAGGED = ((100, 136, 512), (200, 200, 256), (256, 3000, 768))
TUNE_PRODUCERS = (("bf16", "default", 200, 200, 64),
                  ("f32", "highest", 100, 136, 40),
                  ("bf16", "default", 256, 3000, 768))
TUNE_TIMEOUT = 600      # seconds a tpp-tune or example subprocess may take


def _tuning_gemm_cases():
    """(label, key, inputs) of phase_tuning (a)'s GEMM keys."""
    from tpp_mlir_tpu_torch.xsmm import BrgemmKey
    out = [(f"fc 256x1024x1024 {dt} {p}",
            BrgemmKey(dtype=dt, precision=p, **TUNE_FC), _brgemm_inputs)
           for dt, p in (("f32", "default"), ("bf16", "default"),
                         ("f32", "highest"))]
    out.append(("ln gpt2 qkv 2048x2304x768 bf16", _ln_gemm_cases()[0][1],
                _ln_gemm_inputs))
    for m, n, k in TUNE_RAGGED:
        for dt in ("bf16", "f32"):
            out.append((f"ragged {m}x{n}x{k} {dt} +C +D gelu", BrgemmKey(
                1, m, n, k, dt, beta0=False, binary_kind="add",
                binary_bcast="none", unary_kind="gelu"), _brgemm_inputs))
    for dt, p, m, n, k in TUNE_PRODUCERS:
        out.append((f"ln_stats_out {m}x{n}x{k} {dt} {p}", BrgemmKey(
            1, m, n, k, dt, precision=p, beta0=True, binary_kind="add",
            unary_kind="gelu", ln_stats_out=True), _brgemm_inputs))
    out.append(("B19 fc_bf16_packed_warm_1024",
                _packed_key("fc_bf16_packed_warm_1024", 0), _blocked_inputs))
    return out


def _forced_kernel(key, cfg: dict):
    from tpp_mlir_tpu_torch.xsmm import build_kernel, tune
    with tune.trial(key, cfg):
        return build_kernel(key)


def _tuning_plans(g) -> None:
    """(a) Every legal forced plan of each key against its plain version at
    the key's tolerance, the plan the Kernel records equal to the C++
    launcher's (tpp_gemm_plan; the Python mirror's too, at the card's SM
    count), a split launched twice bit-equal; every illegal plan raises."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import ChainKey, reference, reference_kernel
    from tpp_mlir_tpu_torch.xsmm.kernels import gemm_plan, warm_max_clusters
    from tpp_mlir_tpu_torch.xsmm.reference import ln_stats_out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, key, inputs in _tuning_gemm_cases():
        args = inputs(key, g)
        want = reference_kernel(key)(*args)
        if key_stats := getattr(key, "ln_stats_out", False):
            want = want[0]
        tol = _tol(key)
        heur = gemm_plan(key, force=(0, 0, 0))
        if heur[:3] != tuple(reference.gemm_heuristic(key, sms)):
            raise AssertionError(f"{label}: the card's heuristic {heur} != "
                                 f"the mirror's")
        tiles, most = reference.legal_gemm_plans(key)
        worst, n, repeat = 0.0, 0, True
        for bm, bn in tiles:
            for split in range(1, most + 1):
                kern = _forced_kernel(key, {"bm": bm, "bn": bn,
                                            "split": split})
                card = gemm_plan(key, force=(bm, bn, split))
                if not tuple(kern.plan) == card[:3] == (bm, bn, split) or \
                        kern._launch.work_bytes != card[3]:
                    raise AssertionError(f"{label}: Kernel plan "
                                         f"{kern.plan} != the launcher's "
                                         f"{card}")
                got = kern(*args)
                if key_stats:
                    got, mu, var = got
                    own_mu, own_var = ln_stats_out(got)
                    if max(rel_err(mu, own_mu)[0],
                           rel_err(var, own_var)[0]) > TOL_STATS:
                        raise AssertionError(f"{label} {bm}x{bn}: stats")
                elif split == most or split == 2:
                    repeat = repeat and torch.equal(got, kern(*args))
                torch.cuda.synchronize()
                rel, _ = rel_err(got, want)
                worst, n = max(worst, rel), n + 1
                if not (rel <= tol and torch_isfinite(got)):
                    raise AssertionError(f"{label}: plan {bm}x{bn} split "
                                         f"{split} rel {rel} > {tol}")
        illegal = [(128, 64, 1), (32, 32, 1), (64, 64, most + 1)]
        if tiles == reference.FMA_TILES:
            illegal += [(64, 128, 1), (128, 128, 1)]
        for plan in illegal:
            try:
                _forced_kernel(key, dict(zip(("bm", "bn", "split"), plan)))
            except ValueError:
                continue
            raise AssertionError(f"{label}: illegal plan {plan} was taken")
        say(f"tuning plans {label:38s} {n:3d} legal plans (tiles "
            f"{' '.join(f'{a}x{b}' for a, b in tiles)}, split 1..{most}) "
            f"worst rel {worst:.3e} tol {tol:.0e}; heuristic "
            f"{heur[0]}x{heur[1]} split {heur[2]} (card == mirror); "
            f"splits repeat bit-equal {repeat}; {len(illegal)} illegal "
            f"plans raised")
        if not repeat:
            raise AssertionError(f"{label}: a split did not repeat")
    key = ChainKey(m=BATCH, dims=(WIDTH,) * LAYERS, dtype="bf16")
    args = _chain_inputs(key, g)
    want = reference_kernel(key)(*args)
    heur = reference.warm_plan(key)
    worst, ran, skipped = 0.0, 0, []
    for rows in reference.WARM_ROWS:
        for cluster in range(1, reference.WARM_MAX_CLUSTER + 1):
            plan = reference.warm_plan(key, rows=rows, cluster=cluster)
            if plan is None:
                continue
            if not warm_max_clusters(rows, cluster, plan.smem):
                skipped.append((rows, cluster))
                continue
            kern = _forced_kernel(key, {"bm": rows, "cluster": cluster})
            got = kern(*args)
            torch.cuda.synchronize()
            rel, _ = rel_err(got, want)
            worst, ran = max(worst, rel), ran + 1
            if (kern.plan.rows, kern.plan.cluster) != (rows, cluster) or \
                    rel > TOL_BF16:
                raise AssertionError(f"flagship chain rows {rows} cluster "
                                     f"{cluster}: rel {rel}")
    for cfg in ({"bm": 48}, {"cluster": 17}):
        try:
            _forced_kernel(key, cfg)
        except ValueError:
            continue
        raise AssertionError(f"flagship chain: {cfg} was taken")
    say(f"tuning plans flagship chain bf16: {ran} panel plans (rows "
        f"{'/'.join(map(str, reference.WARM_ROWS))} x the clusters "
        f"warm_plan places) worst rel {worst:.3e} tol {TOL_BF16:.0e}; "
        f"heuristic rows {heur.rows} cluster {heur.cluster}; not placeable "
        f"on the card {skipped}; rows 48 and cluster 17 raised")


def _tuning_register_blocking() -> dict:
    """(b) tpp_run --register-blocking on the one-layer fc (a BrgemmKey):
    the plan it names, within TOL_BF16 of --linalg-to-loops."""
    from tpp_mlir_tpu_torch.runtime.executor import module_keys
    from tpp_mlir_tpu_torch.tools.tpp_run import run_module
    from tpp_mlir_tpu_torch.xsmm import global_cache
    from tpp_mlir_tpu_torch.xsmm.kernels import describe_plan
    cache = global_cache()
    module = _module(TUNE_FC_GEN)
    module.attrs["register_blocking"] = REGISTER_BLOCKING
    cache.reset_launches()
    res = run_module(module, device="cuda", print_mlir="kernel",
                     out_stream=sys.stderr)
    launches = _launches(cache)
    ref = run_module(_module(TUNE_FC_GEN), device="cuda",
                     linalg_to_loops=True, out_stream=sys.stderr)
    rel, _ = rel_err(res["outputs"][0], ref["outputs"][0])
    (_, key), = module_keys(res["module"])
    kern = cache.dispatch(key)
    want = (64, 128, 4)
    ok = rel <= TOL_BF16 and tuple(kern.plan) == want and kern.launches
    say(f"tuning --register-blocking {','.join(map(str, REGISTER_BLOCKING))}"
        f" on fc 256x1024x1024: key bm/bn/bk {key.bm}/{key.bn}/{key.bk}, "
        f"ran {describe_plan(kern.plan)} ({kern.launches} launch), vs "
        f"--linalg-to-loops rel {rel:.3e} tol {TOL_BF16:.0e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("--register-blocking did not run its plan")
    return launches


def _tuning_subprocess(argv: list, env: dict, cwd) -> str:
    proc = subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True,
                          timeout=TUNE_TIMEOUT)
    if proc.returncode:
        raise AssertionError(f"{' '.join(argv)} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    return proc


def _tuning_tuner(root) -> None:
    """(c) tpp-tune on the bf16 flagship (its B4 chain) and on the fc's GEMM
    key, in a subprocess writing a temporary table; each sweep row beside
    the heuristic's."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=str(root),
                   TPP_TUNING_PATH=os.path.join(d, "tuning.json"))
        for args in (["--gen", TUNE_FLAGSHIP_GEN],
                     ["--gen", TUNE_FC_GEN, "--key", "BrgemmKey"]):
            t0 = time.perf_counter()
            proc = _tuning_subprocess(
                ["-m", "tpp_mlir_tpu_torch.tools.tpp_tune", *args,
                 "--iters", "10"], env, root)
            rows = [x for x in proc.stderr.splitlines()
                    if "ms (heuristic" in x]
            for line in proc.stderr.splitlines():
                if line.startswith((" ", "==")) and "candidate" not in line:
                    say(f"tuning tpp-tune {line}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            say(f"tuning tpp-tune {' '.join(args)}: {len(rows)} sweep rows, "
                f"{out['tuned']} recorded to a temporary table, "
                f"{time.perf_counter() - t0:.1f} s")
            if len(rows) < 2:
                raise AssertionError("tpp-tune swept nothing")


def _tuning_examples(root) -> None:
    """(d) examples/torch/01-06 on the card, each a process of its own, all
    started together; each must exit 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(root))
    paths = sorted((root / "examples" / "torch").glob("0*.py"))
    t0 = time.perf_counter()
    procs = [(p, subprocess.Popen([sys.executable, str(p), "--device",
                                   "cuda"], cwd=root, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
             for p in paths]
    failed = []
    try:
        for p, proc in procs:
            out, err = proc.communicate(timeout=TUNE_TIMEOUT)
            last = (out.strip().splitlines() or [""])[-1]
            say(f"tuning example {p.name}: exit {proc.returncode}; {last}")
            if proc.returncode:
                failed.append(f"{p.name}:\n{err[-3000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    say(f"tuning examples: {len(paths)} ran in "
        f"{time.perf_counter() - t0:.1f} s")
    if failed or len(paths) != 6:
        raise AssertionError("examples failed:\n" + "\n".join(failed))


def phase_tuning() -> dict:
    """The tuning layer and the user API (ROADMAP A5 + A12): (a) forced
    plans against the plain versions, (b) --register-blocking, (c) tpp-tune,
    (d) the examples. Returns (b)'s launches, counted on that run alone."""
    from pathlib import Path

    import torch
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    _tuning_plans(torch.Generator(device="cuda").manual_seed(21))
    launches = _tuning_register_blocking()
    _tuning_tuner(root)
    _tuning_examples(root)
    say(f"tuning phase: {time.perf_counter() - t0:.1f} s")
    return launches


# the compiler's general path (ROADMAP A3): tpp-gen's generic and softmax
# modules, split-reduction-dim, and an imported conv-BN-pool stack
GENERIC_FLAGSHIP = (("generic flagship bf16", "--float-type=bf16"),
                    ("generic flagship f32", ""))
SOFTMAX_FC = "--batch=256 --layers=1024,1024 --bias --relu --softmax"
SOFTMAX_FORMS = (("f32", "default"), ("f32", "highest"), ("bf16", "default"))
SPLIT_FC = "--batch=256 --layers=1024,1024 --bias --relu"
SPLIT_TILE = 256
CONV_STACK = (8, 128, 32, 32)   # N, C, H, W of the conv-BN-pool stack
COMPILER_GRAPH_N = 100          # forwards a CUDA graph replays (-n 100)


def _invokes(module) -> list:
    return [op.opname for op in module["entry"].ops
            if op.opname.startswith("xsmm.")
            and not op.opname.endswith("_dispatch")]


def _conv_bn_pool_stack():
    """JAX tests/frontend/test_torch_import.py:88's stack at 128 channels:
    Conv2d(3, p1)-BN-ReLU-MaxPool2d(2)-AvgPool2d(2)-Linear(->10), weights
    from torch.manual_seed(4), BN stats drawn as the JAX test draws them."""
    import torch
    N, C, H, W = CONV_STACK
    torch.manual_seed(4)
    model = torch.nn.Sequential(
        torch.nn.Conv2d(C, C, 3, padding=1), torch.nn.BatchNorm2d(C),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2), torch.nn.AvgPool2d(2),
        torch.nn.Flatten(), torch.nn.Linear(C * (H // 4) * (W // 4), 10))
    model.eval()
    with torch.no_grad():
        model[1].running_mean.uniform_(-0.5, 0.5)
        model[1].running_var.uniform_(0.5, 1.5)
    return model, torch.randn(N, C, H, W)


def phase_compiler_path() -> dict:
    """ROADMAP A3 on the card, through run_module: (a) the generic-form
    flagship (tpp-gen --output=generic, constant weights) in bf16 and f32
    "default", one xsmm.fused_chain (B3) as the named form, bit-equal to
    it; (b) the fc with --softmax in f32 and bf16, one B1 fused_brgemm then
    the decomposed softmax as PyTorch ops, rows summing to 1, against the
    f32 softmax of its own logits (see the comment there); (c) the f32
    fc through split-reduction-dim{tile=256}, one B1 dispatch of batch 4,
    against the un-split lowering and the same module on the CPU (B1's
    plain version); (d) the imported conv-BN-pool stack (N 8, 128
    channels, 32x32) on conv.cu (B24) against the torch module. Each run
    is held against --linalg-to-loops at TOL_BF16 ((d): TOL_MODEL); the
    launches are this path's alone; then the CUDA-graph times of (a)."""
    import copy

    import torch

    from tpp_mlir_tpu_torch.frontend import import_torch
    from tpp_mlir_tpu_torch.passes import make_pass, run_pipeline
    from tpp_mlir_tpu_torch.runtime import compile as tpp_compile
    from tpp_mlir_tpu_torch.tools.tpp_run import init_args, run_module
    from tpp_mlir_tpu_torch.xsmm import global_cache
    from tpp_mlir_tpu_torch.xsmm.reference import no_tf32_conv
    cache = global_cache()
    t0 = time.perf_counter()

    def run(module, **kw):
        return run_module(module, device="cuda", out_stream=sys.stderr,
                          **kw)

    def held(label, got, want, tol, extra=""):
        rel, ab = rel_err(got, want)
        ok = tuple(got.shape) == tuple(want.shape) and rel <= tol \
            and torch_isfinite(got)
        say(f"compiler {label:26s} vs {extra or '--linalg-to-loops'} rel "
            f"{rel:.3e} abs {ab:.3e} tol {tol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel} > {tol}")

    cache.reset_launches()
    lowered = {}
    # (a) the flagship in generic form against its named form
    for label, dt in GENERIC_FLAGSHIP:
        named = f"{FLAGSHIP_GEN} {dt}".strip()
        res = run(_module(f"{named} --output=generic"))
        if _invokes(res["module"]) != ["xsmm.fused_chain"]:
            raise AssertionError(f"{label}: lowered to "
                                 f"{_invokes(res['module'])}")
        lowered[label] = res["module"]
        got = res["outputs"][0]
        want = run(_module(f"{named} --output=generic"),
                   linalg_to_loops=True)["outputs"][0]
        held(label, got, want, TOL_BF16, "")
        ref = run(_module(named))["outputs"][0]
        d = (got.float() - ref.float()).abs().max().item()
        say(f"compiler {label:26s} one xsmm.fused_chain; max |generic - "
            f"named| {d:.3e} {'ok' if d == 0 else 'FAIL'}")
        if d != 0:
            raise AssertionError(f"{label}: {d} from the named flagship")
    # (b) --softmax: B1, then reduce/sub/exp/reduce/div. Held: the rows'
    # sums, the softmax against the f32 softmax of B1's own logits (the
    # same module without --softmax), the logits against
    # --linalg-to-loops, and the f32 "highest" module against
    # --linalg-to-loops. Printed, not held: the f32 "default" and bf16
    # modules against --linalg-to-loops, where exp turns the logits'
    # rounding (up to |157| here) into differences of several 1e-2; the
    # JAX package on the CPU reads the same 0.2305 on the bf16 module
    for dt, prec in SOFTMAX_FORMS:
        flags = f"{SOFTMAX_FC} --float-type={dt}"
        label = f"softmax fc {dt}" + (f" {prec}" if prec != "default"
                                      else "")

        def module(softmax=True):
            m = _module(flags if softmax else flags.replace(" --softmax",
                                                            ""))
            if prec != "default":
                m.attrs["precision"] = prec
            return m
        res = run(module())
        ops = [op.opname for op in res["module"]["entry"].ops
               if not op.opname.endswith("_dispatch")
               and op.opname not in ("tl.constant", "tl.reshape")]
        if ops != ["xsmm.fused_brgemm", "tl.reduce", "xsmm.binary",
                   "xsmm.unary", "tl.reduce", "xsmm.binary"]:
            raise AssertionError(f"{label}: lowered to {ops}")
        got = res["outputs"][0]
        rows = (got.float().sum(-1) - 1).abs().max().item()
        say(f"compiler {label:26s} one xsmm.fused_brgemm + the decomposed "
            f"softmax; max |row sum - 1| {rows:.3e} tol 1e-02 "
            f"{'ok' if rows <= 1e-2 else 'FAIL'}")
        if rows > 1e-2:
            raise AssertionError(f"{label}: rows sum {rows} from 1")
        logits = run(module(False))["outputs"][0]
        held(label, got, torch.softmax(logits.float(), -1), TOL_BF16,
             "softmax(B1's own logits, f32)")
        held(f"{label} logits", logits, run(module(False),
             linalg_to_loops=True)["outputs"][0], TOL_BF16)
        want = run(module(), linalg_to_loops=True)["outputs"][0]
        if prec == "highest":
            held(label, got, want, TOL_BF16)
        else:
            rel, ab = rel_err(got, want)
            say(f"compiler {label:26s} vs --linalg-to-loops rel {rel:.3e} "
                f"abs {ab:.3e} (reported, not held: the logits' rounding "
                f"through exp)")
    # (c) split-reduction-dim ahead of default-tpp-passes
    split = _module(SPLIT_FC)
    make_pass("split-reduction-dim", tile=SPLIT_TILE).run(split)
    cpu_split = _module(SPLIT_FC)
    make_pass("split-reduction-dim", tile=SPLIT_TILE).run(cpu_split)
    res = run(split)
    disp = [op.attrs for op in res["module"]["entry"].ops
            if op.opname.endswith("brgemm_dispatch")]
    inv = [o for o in _invokes(res["module"]) if "brgemm" in o]
    if len(disp) != 1 or disp[0]["batch"] != 1024 // SPLIT_TILE:
        raise AssertionError(f"split fc: dispatches {disp}")
    say(f"compiler split fc: one {inv[0]} of batch {disp[0]['batch']} "
        f"(k {disp[0]['k']}), invokes {_invokes(res['module'])}")
    got = res["outputs"][0]
    held("split fc f32", got, run(_module(SPLIT_FC))["outputs"][0],
         TOL_F32, "the un-split lowering")
    plain = run_module(cpu_split, device="cpu", out_stream=sys.stderr)
    held("split fc f32", got, plain["outputs"][0].to(got.device), TOL_F32,
         "B1's plain version (cpu)")
    held("split fc f32", got, run(_module(SPLIT_FC), linalg_to_loops=True)
         ["outputs"][0], TOL_BF16)
    # (d) the imported conv-BN-pool stack
    model, x = _conv_bn_pool_stack()
    x = x.cuda()
    with torch.no_grad(), no_tf32_conv():
        want = copy.deepcopy(model).cuda()(x)
    stack = import_torch(model, CONV_STACK)
    run_pipeline(stack, "default-tpp-passes")
    convs = [op.attrs.get("layout") for op in stack["entry"].ops
             if op.opname.endswith("brgemm_dispatch")]
    got = tpp_compile(stack, "entry", "cuda")(x)
    held("conv-BN-pool stack f32", got, want, TOL_MODEL, "the torch module")
    held("conv-BN-pool stack f32", got, tpp_compile(
        import_torch(model, CONV_STACK), "entry", "cuda")(x), TOL_MODEL)
    launches = _launches(cache)
    say(f"compiler stack: invokes {_invokes(stack)}, conv layouts "
        f"{convs}; path launches: brgemm {launches['brgemm']} chain "
        f"{launches['chain']} conv_nhwc {launches['conv_nhwc']} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (launches["brgemm"] and launches["chain"]
            and launches["conv_nhwc"]):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    # both forms of the flagship, -n 100 forwards replayed from a graph
    for label, dt in GENERIC_FLAGSHIP:
        named = f"{FLAGSHIP_GEN} {dt}".strip()
        times = []
        for module in (lowered[label], run(_module(named))["module"]):
            f = tpp_compile(module, "entry", "cuda")
            args = init_args(module, "entry", "normal", 0, "cuda")
            times.append(graph_ms(lambda: f(*args), COMPILER_GRAPH_N))
        say(f"compiler {label:26s} graph of {COMPILER_GRAPH_N} forwards: "
            f"{times[0]:.4f} ms a forward (named form {times[1]:.4f})")
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


# the serving modes (ROADMAP A8) at GPT-2 small's full width, the serving
# path's gpt2_small_serve_b8 model (bf16, vocab 50304, 12 layers, max_seq
# 1024, random weights from seed 0): continuous batching of 24 requests
# (prompts of 1-512 tokens from default_rng(0), as tpp_serve --continuous
# draws them; max_new 64) through 8 slots, the host scheduler syncing every
# 8 steps and the device scheduler every 64 with waves of 16; beam search at
# b2, prompt 512, 4 beams, 32 steps; speculative decoding at b1, prompt 512,
# k 4, 64 steps, a 2-layer trunk draft
MODES_REQUESTS, MODES_PROMPT, MODES_MAX_NEW, MODES_SLOTS = 24, 512, 64, 8
HOST_SYNC, DEVICE_SYNC, DEVICE_WAVE = 8, 64, 16
BEAM_BATCH, BEAM_WIDTH, BEAM_STEPS = 2, 4, 32
SPEC_K, SPEC_STEPS, SPEC_TRUNK = 4, 64, 2


def _counted(obj, name: str, calls: list) -> None:
    """Wrap obj.<name> so that each call appends one to `calls`."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    setattr(obj, name, wrapped)


class _Oracle:
    """Teacher-forced prefills of the kernels-off engine over a prompt and
    the tokens emitted after it: each emitted token must be the oracle's
    argmax or within TOL_MODEL * max|logit| of it. Keeps the exact-argmax
    count; one prefill per distinct stream."""

    def __init__(self, cfg, params):
        from tpp_mlir_tpu_torch.serving import make_prefill
        self.prefill = make_prefill(_kernels_off(cfg), use_kernels=False)
        self.params, self.seen = params, {}
        self.exact = self.total = 0

    def logits(self, prompt, toks):
        """The oracle's f32 logits (len(toks), V) for each emitted token."""
        import torch
        key = (tuple(prompt), tuple(toks[:-1]))
        if key not in self.seen:
            ids = torch.tensor([list(prompt) + list(toks[:-1])],
                               dtype=torch.int32, device="cuda")
            self.seen[key] = self.prefill(self.params, ids)[0][
                0, len(prompt) - 1:].float()
        return self.seen[key]

    def check(self, prompt, toks) -> bool:
        import torch
        rows = self.logits(prompt, toks)
        t = torch.tensor(toks, device=rows.device).long()[:, None]
        top = rows.max(-1).values
        ok = bool((rows.gather(1, t)[:, 0] >= top - TOL_MODEL *
                   rows.abs().max(-1).values).all())
        self.exact += int((rows.argmax(-1) == t[:, 0]).sum())
        self.total += len(toks)
        return ok

    def logp(self, prompt, toks) -> float:
        """Sum of the oracle's log-probabilities of toks after prompt."""
        import torch
        rows = torch.log_softmax(self.logits(prompt, toks), -1)
        t = torch.tensor(toks, device=rows.device).long()[:, None]
        return float(rows.gather(1, t).sum())


def _static_batching(cfg, params, prompts, max_new: int):
    """The static-batching baseline on the same trace (as
    scripts/bench_batching.py runs it for the JAX package): batches of
    MODES_SLOTS requests, each prefilled at its bucket into a slotted cache,
    then the same replayed decode loop (sync HOST_SYNC) until the batch's
    longest generation is done, finished rows idling. Returns run() ->
    tokens emitted; a first call captures the loop's graph."""
    import torch

    from tpp_mlir_tpu_torch.serving import (init_slot_cache,
                                            make_decode_loop, make_insert,
                                            make_prefill)
    from tpp_mlir_tpu_torch.serving.batching import DEFAULT_BUCKETS, _park
    prefill, insert = make_prefill(cfg), make_insert(cfg)
    loop = make_decode_loop(cfg, HOST_SYNC)
    cache = init_slot_cache(cfg, MODES_SLOTS, "cuda")
    tok = torch.zeros(MODES_SLOTS, dtype=torch.int32, device="cuda")

    def run() -> int:
        total = 0
        for i in range(0, len(prompts), MODES_SLOTS):
            batch = prompts[i:i + MODES_SLOTS]
            _park(cache, cfg)
            for b, p in enumerate(batch):
                logits, pc = prefill(params, _bucketed(p, DEFAULT_BUCKETS))
                insert(cache, pc, b, len(p))
                tok[b] = logits[0, len(p) - 1].argmax()
            for _ in range(-(-(max_new - 1) // HOST_SYNC)):
                loop(params, cache, tok)
            total += max_new * len(batch)
        torch.cuda.synchronize()
        return total
    return run


def _bucketed(prompt, buckets):
    """A prompt right-padded to its bucket, (1, bucket) on the card, as
    the host scheduler prefills it."""
    import numpy as np
    import torch
    bucket = next(b for b in buckets if b >= len(prompt))
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :len(prompt)] = prompt
    return torch.from_numpy(ids).to("cuda")


def _wall(fn):
    """(fn(), seconds) by the host clock, the device synchronized (and the
    garbage of earlier runs, their CUDA graphs among it, collected
    first)."""
    import gc

    import torch
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serving_modes(setup) -> dict:
    """Continuous batching (both schedulers), beam search and speculative
    decoding (ROADMAP A8) on gpt2_small_serve_b8's model. Each mode: an
    eager run (graph=False) with the launch counts set to 0 just before it
    and read just after (B7 a prefill, B13 a decode step: exact counts),
    then the same run replayed from CUDA graphs, whose tokens must equal the
    eager run's; every emitted token against the kernels-off engine's
    teacher-forced prefill (_Oracle); beam W=1 against make_generate, the
    best beam's score against its teacher-forced log-probability
    (TOL_MODEL, relative); then timed second passes: each scheduler's
    tokens/s beside static batching on the same trace, beam ms/step,
    speculative tokens/s and acceptance beside plain greedy."""
    import torch

    from tpp_mlir_tpu_torch.serving import (BatchingEngine,
                                            DeviceBatchingEngine,
                                            make_beam_generate,
                                            make_generate, make_prefill,
                                            make_speculative_generate)
    from tpp_mlir_tpu_torch.tools.tpp_serve import continuous_prompts
    from tpp_mlir_tpu_torch.xsmm import global_cache
    kcache = global_cache()
    _, cfg, params, ids, _ = setup
    L = cfg.layers
    oracle = _Oracle(cfg, params)
    prompts = continuous_prompts(cfg.vocab, MODES_PROMPT, MODES_REQUESTS, 0)
    total: dict[str, int] = {}

    def eager_launches(run):
        """run() under fresh launch counts; (its result, the counts)."""
        kcache.reset_launches()
        out = run()
        torch.cuda.synchronize()
        launches = _launches(kcache)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        return out, launches

    def serve(eng):
        eng.reset()
        rids = [eng.submit(p, max_new=MODES_MAX_NEW) for p in prompts]
        done = eng.run()
        return [done[r] for r in rids]

    # -- continuous batching, host and device schedulers -------------------
    timed, parts = {}, {}
    for sched in ("host", "device"):
        t0 = time.perf_counter()
        if sched == "host":
            def make(graph):
                return BatchingEngine(params, cfg, slots=MODES_SLOTS,
                                      sync_steps=HOST_SYNC, graph=graph)
            sync, looped = HOST_SYNC, "_loop"
        else:
            def make(graph):
                return DeviceBatchingEngine(
                    params, cfg, slots=MODES_SLOTS, sync_steps=DEVICE_SYNC,
                    wave=DEVICE_WAVE, graph=graph)
            sync, looped = DEVICE_SYNC, "_macro"
        eng = make(False)
        loops, stages = [], []
        _counted(eng, looped, loops)
        _counted(eng, "_prefill" if sched == "host" else "_stage_fn",
                 stages)
        eager, launches = eager_launches(lambda: serve(eng))
        want = {"attention": L * len(stages),
                "decode_attn": L * sync * len(loops)}
        eng = make(True)
        graphed = serve(eng)                    # the first pass captures
        same = graphed == eager
        exact0 = oracle.exact, oracle.total
        good = all([oracle.check(p, t) for p, t in zip(prompts, graphed)])
        share = (oracle.exact - exact0[0]) / (oracle.total - exact0[1])
        ntok = sum(len(t) for t in graphed)
        ok = all(launches[k] == n for k, n in want.items()) and same and \
            good and ntok == MODES_REQUESTS * MODES_MAX_NEW and \
            (sched == "device" or len(stages) == MODES_REQUESTS)
        toks, secs = _wall(lambda: serve(eng))  # the second pass
        timed[sched] = (sum(len(t) for t in toks), secs)
        # its parts alone, by the host clock: the prefills (with the
        # staging copies) and the decode loops replayed as often as the
        # run called them (every slot parked: B13 reads all rows)
        if sched == "host":
            pre = [_bucketed(p, eng.buckets) for p in prompts]
            _, pre_s = _wall(lambda: [eng._prefill(eng.params, i)
                                      for i in pre])
            _, loop_s = _wall(lambda: [eng._loop(eng.params, eng.cache,
                                                 eng.tok)
                                       for _ in loops])
        else:
            reqs = [(i, i, p, MODES_MAX_NEW) for i, p in enumerate(prompts)]
            _, pre_s = _wall(lambda: [
                eng._stage(reqs[i:i + DEVICE_WAVE], len(reqs))
                for i in range(0, len(reqs), DEVICE_WAVE)])
            out, olen = eng._outs[(len(reqs), MODES_MAX_NEW)]
            _, loop_s = _wall(lambda: [eng._macro(
                eng.params, eng.cache, eng.tok, None, eng.rid, eng.left, out,
                olen, eng.nxt_l, eng.staging, eng.wlen, eng.wnew, eng.wfirst,
                eng.wrid, eng.wcount) for _ in loops])
        parts[sched] = (pre_s, loop_s, len(loops))
        say(f"main gpt2_small_serve continuous {sched} scheduler: "
            f"{MODES_REQUESTS} requests (prompts {min(map(len, prompts))}-"
            f"{max(map(len, prompts))}, max_new {MODES_MAX_NEW}) through "
            f"{MODES_SLOTS} slots, sync {sync}"
            f"{f', wave {DEVICE_WAVE}' if sched == 'device' else ''}: "
            f"{ntok} tokens, {len(stages)} prefills, {len(loops)} "
            f"{looped[1:]} calls; eager launches {launches} (want {want}); "
            f"graph tokens == eager {same}; every token within "
            f"{TOL_MODEL:.0e} of the teacher-forced argmax {good} (exact "
            f"argmax {share:.4f}, for information) "
            f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"continuous {sched}: launches {launches} "
                                 f"(want {want}), graph == eager {same}, "
                                 f"teacher-forced {good}, tokens {ntok}")
        del eng
    static = _static_batching(cfg, params, prompts, MODES_MAX_NEW)
    static()                                    # the first pass captures
    s_tok, s_secs = _wall(static)
    say(f"time serve gpt2_small continuous {MODES_SLOTS} slots, "
        f"{MODES_REQUESTS} requests x {MODES_MAX_NEW} tokens (second pass,"
        f" host clock): host scheduler {timed['host'][1]:.4f} s "
        f"({timed['host'][0] / timed['host'][1]:.1f} tokens/s), device "
        f"scheduler {timed['device'][1]:.4f} s "
        f"({timed['device'][0] / timed['device'][1]:.1f} tokens/s), static "
        f"batching {s_secs:.4f} s ({s_tok / s_secs:.1f} tokens/s)")
    for sched, (pre_s, loop_s, n) in parts.items():
        steps = n * (HOST_SYNC if sched == "host" else DEVICE_SYNC)
        say(f"time serve gpt2_small continuous {sched} scheduler, its parts"
            f" alone: prefills {pre_s:.4f} s, {n} decode "
            f"{'rounds' if sched == 'host' else 'macros'} replayed "
            f"{loop_s:.4f} s ({loop_s * 1e3 / steps:.4f} ms a step)")

    # -- beam search ----------------------------------------------------------
    t0 = time.perf_counter()
    bids = ids[:BEAM_BATCH]

    def beam(graph, width=BEAM_WIDTH, mark=None):
        return make_beam_generate(cfg, BEAM_STEPS, width, graph=graph)(
            params, bids, mark)
    (toks, _), launches = eager_launches(lambda: beam(False))
    want = {"attention": L, "decode_attn": L * (BEAM_STEPS - 1)}
    gtoks, scores = beam(True)
    same = torch.equal(gtoks, toks)
    w1_same = torch.equal(beam(True, 1)[0],
                          make_generate(cfg, BEAM_STEPS)(params, bids))
    tf = [oracle.logp(p, t) for p, t in zip(bids.tolist(), gtoks.tolist())]
    rel = max(abs(float(s) - w) / abs(w) for s, w in zip(scores, tf))
    ok = all(launches[k] == n for k, n in want.items()) and same and \
        w1_same and rel <= TOL_MODEL
    say(f"main gpt2_small_serve beam search b{BEAM_BATCH} prompt "
        f"{bids.shape[1]} width {BEAM_WIDTH} steps {BEAM_STEPS}: eager "
        f"launches {launches} (want {want}); graph tokens == eager {same};"
        f" W=1 == make_generate {w1_same}; best score vs teacher-forced "
        f"log-prob rel {rel:.3e} (scores "
        f"{[round(float(s), 4) for s in scores]}, tol {TOL_MODEL:.0e}) "
        f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"beam: launches {launches} (want {want}), "
                             f"graph == eager {same}, W=1 {w1_same}, rel "
                             f"{rel}")
    stamps = {}

    def mark(phase):
        torch.cuda.synchronize()
        stamps[phase] = time.perf_counter()
    _wall(lambda: beam(True, mark=mark))
    # the reorder alone (gather the parents' rows, copy back, k and v),
    # from a CUDA graph, on a cache of the beams' shape
    _, kv = make_prefill(cfg)(params, ids[:BEAM_BATCH * BEAM_WIDTH])
    flat = torch.arange(BEAM_BATCH * BEAM_WIDTH, device="cuda").flip(0)
    reorder_ms = graph_ms(lambda: [kv[n].copy_(kv[n].index_select(1, flat))
                                   for n in ("k", "v")], iters=5)
    del kv
    step_ms = (stamps["decode"] - stamps["capture"]) * 1e3 / (BEAM_STEPS - 2)
    say(f"time serve gpt2_small beam b{BEAM_BATCH} x {BEAM_WIDTH} beams: "
        f"{step_ms:.4f} ms/step (the steps replayed after the first, host "
        f"clock), of "
        f"which the cache reorder {reorder_ms:.4f} ms (from a CUDA graph); "
        f"prefill and beam set-up "
        f"{(stamps['prefill'] - stamps['start']) * 1e3:.4f} ms")

    # -- speculative decoding -----------------------------------------------
    t0 = time.perf_counter()
    sids = ids[:1]

    def spec(graph):
        out, stats = make_speculative_generate(
            cfg, None, SPEC_STEPS, k=SPEC_K, trunk_layers=SPEC_TRUNK,
            graph=graph)(params, sids)
        return out, {k: int(v) for k, v in stats.items()}
    (toks, stats), launches = eager_launches(lambda: spec(False))
    want = {"attention": L, "decode_attn": SPEC_TRUNK * (SPEC_K + 1)
            * stats["macro_steps"]}
    gtoks, gstats = spec(True)
    same = torch.equal(gtoks, toks) and gstats == stats
    good = oracle.check(sids[0].tolist(), gtoks[0].tolist())
    rate = gstats["accepted"] / gstats["drafted"]
    ok = all(launches[k] == n for k, n in want.items()) and same and good
    say(f"main gpt2_small_serve speculative b1 prompt {sids.shape[1]} k "
        f"{SPEC_K} steps {SPEC_STEPS}, {SPEC_TRUNK}-layer trunk draft: "
        f"eager launches {launches} (want {want}); graph tokens and stats "
        f"== eager {same}; every token within {TOL_MODEL:.0e} of the "
        f"teacher-forced argmax {good}; {gstats['macro_steps']} rounds, "
        f"acceptance {gstats['accepted']}/{gstats['drafted']} ({rate:.4f}, "
        f"for information) ({time.perf_counter() - t0:.1f} s) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"speculative: launches {launches} (want "
                             f"{want}), graph == eager {same}, "
                             f"teacher-forced {good}")
    plain = make_generate(cfg, SPEC_STEPS)
    _, s_secs = _wall(lambda: spec(True))
    _, g_secs = _wall(lambda: plain(params, sids))
    _, p_secs = _wall(lambda: make_prefill(cfg)(params, sids))
    say(f"time serve gpt2_small speculative b1 (second pass, whole call "
        f"with its prefill and one capture, host clock): {s_secs:.4f} s "
        f"({SPEC_STEPS / s_secs:.1f} tokens/s, acceptance {rate:.4f}, "
        f"{(s_secs - p_secs) * 1e3 / gstats['macro_steps']:.4f} ms a round "
        f"after the prefill); plain greedy make_generate {g_secs:.4f} s "
        f"({SPEC_STEPS / g_secs:.1f} tokens/s, "
        f"{(g_secs - p_secs) * 1e3 / (SPEC_STEPS - 1):.4f} ms a step after "
        f"the prefill); the b1 prefill alone {p_secs * 1e3:.4f} ms")
    say(f"serving modes: exact argmax share of every checked token "
        f"{oracle.exact / oracle.total:.4f} of {oracle.total}")
    return total

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
    # the wgmma tile's edges: bm 64, n and k off the 128/64 tiles, a
    # stacked table under transpose_b, an f32 output with skewed routing
    ("edge bm 64 gelu 1536x512x256", 600, 64, 512, 256,
     dict(_B16, unary_kind="gelu"), False),
    ("edge ragged n200 k136", 300, 128, 200, 136, _B16, False),
    ("edge ragged tb f32 out skewed n136 k200", 300, 64, 136, 200,
     dict(_B16, transpose_b=True, out_dtype="f32"), True),
    ("edge layers 2 tb 1280x256x384", 512, 128, 256, 384,
     dict(_B16, layers=2, transpose_b=True), False),
)
# B17: (label, T, bm, k, n, skewed, xt contiguous): dw2 (a^T dys) and dw1
# (xs^T dz1) as the training backward passes xt (the transpose of the slot
# rows), then the wgmma tile's edges: bm 64, k and n off its 128, a
# contiguous (K-major) xt; bm 16 takes the WMMA tile
GROUPED_WGRAD_CASES = (
    ("dw2 k3072 n768 over 9216", 4096, 128, 3072, 768, False, False),
    ("dw1 k768 n3072 over 9216", 4096, 128, 768, 3072, False, False),
    ("skewed dw1 k768 n3072", 4096, 128, 768, 3072, True, False),
    ("edge bm 64 k256 n512", 600, 64, 256, 512, False, False),
    ("edge ragged k200 n136", 300, 128, 200, 136, False, False),
    ("edge bm 64 ragged skewed k136 n200", 300, 64, 136, 200, True, False),
    ("edge contiguous xt dw1 k768 n3072", 4096, 128, 768, 3072, False,
     True),
    ("edge bm 16 k128 n96", 200, 16, 128, 96, False, False),
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


def _grouped_wgrad_inputs(g, T, bm, k, n, skew, contiguous=False):
    """(key, args, experts no token chose): xt the transpose of the
    (A_pad, k) slot rows, read in place as the training backward passes
    it (or, `contiguous`, a contiguous copy), and dY with zero padding
    rows."""
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
    xt = xs.t().contiguous() if contiguous else xs.t()
    return key, (d["ge"], xt, dy), sorted(set(range(8)) - chosen)


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
            f"tol {tol:.0e}; {int(pad.sum())} padding rows zero {zero}"
            f"{_route_note(key)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grouped_gemm {label}: rel {rel}, "
                                 f"padding zero {zero}")
        worst["grouped_gemm"] = max(worst["grouped_gemm"], ab)
    # an expert that owns no row block at all (experts 1 and 3 of 5), at
    # both of the wgmma tile's heights
    from tpp_mlir_tpu_torch.xsmm import GroupedGemmKey
    for bm in (64, 128):
        ge = torch.tensor([0, 2, 2, 4, 4, 4], dtype=torch.int32,
                          device="cuda")
        key = GroupedGemmKey(n_groups=5, m=6 * bm, n=256, k=192, bm=bm,
                             dtype="bf16")
        a = torch.randn(key.m, key.k, generator=g, device="cuda").bfloat16()
        b = (torch.randn(5, key.k, key.n, generator=g, device="cuda")
             * key.k ** -0.5).bfloat16()
        got = build_kernel(key)(ge, a, b)
        ref = reference_kernel(key)(ge, a, b)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        ok = rel <= TOL_BF16 and torch_isfinite(got)
        say(f"kernel grouped_gemm {f'experts 1, 3 own no block bm {bm}':38s}"
            f" rel {rel:.3e} abs {ab:.3e} tol {TOL_BF16:.0e}"
            f"{_route_note(key)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grouped_gemm no-block bm {bm}: rel {rel}")
        worst["grouped_gemm"] = max(worst["grouped_gemm"], ab)
    for label, T, bm, k, n, skew, contiguous in GROUPED_WGRAD_CASES:
        key, args, untouched = _grouped_wgrad_inputs(g, T, bm, k, n, skew,
                                                     contiguous)
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
            f"chose {untouched} zero {zero}"
            f"{_route_note(key, args[1].stride())} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grouped_wgrad {label}: rel {rel}, "
                                 f"bit-equal {same}, untouched {untouched} "
                                 f"zero {zero}")
        worst["grouped_wgrad"] = max(worst["grouped_wgrad"], ab)
    # experts 1 and 3 of 5 own no row block: the wgmma tile runs no slice
    # for them and must write exactly zero
    from tpp_mlir_tpu_torch.xsmm import GroupedWgradKey
    for bm in (64, 128):
        ge = torch.tensor([0, 2, 2, 4, 4, 4], dtype=torch.int32,
                          device="cuda")
        key = GroupedWgradKey(n_groups=5, m=6 * bm, k=192, n=256, bm=bm,
                              dtype="bf16")
        x = torch.randn(key.m, key.k, generator=g, device="cuda").bfloat16()
        dy = torch.randn(key.m, key.n, generator=g, device="cuda").bfloat16()
        got = build_kernel(key)(ge, x.t(), dy)
        ref = reference_kernel(key)(ge, x.t(), dy)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        zero = not got[[1, 3]].any().item()
        ok = rel <= TOL_F32 and zero and torch_isfinite(got)
        say(f"kernel grouped_wgrad {f'experts 1, 3 own no block bm {bm}':37s}"
            f" rel {rel:.3e} abs {ab:.3e} tol {TOL_F32:.0e}; their dW zero "
            f"{zero}{_route_note(key)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grouped_wgrad no-block bm {bm}: rel {rel},"
                                 f" zero {zero}")
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
            16, 256, 256, 512, "f32", precision="highest")),
        # the tiled route's bf16 softmax (f32 "default", k over 64)
        ("bmm softmax +C 5x70x90x100 f32", BatchMatmulKey(
            5, 70, 90, 100, "f32", softmax_lhs=True)),
        # the multi route's edges: a batch the warps do not divide, one
        # beyond the resident warps (each warp takes problems in turn),
        # lhs_shared, +C with a bf16 softmax at k 64, m below 16
        ("bmm qk b1000 f32", BatchMatmulKey(1000, 32, 32, 64, "f32",
                                            beta0=True)),
        ("bmm qk b5000 f32", BatchMatmulKey(
            5000, 32, 32, 64, "f32", beta0=True)),
        ("bmm lhs_shared 300x48x64x40 bf16", BatchMatmulKey(
            300, 48, 64, 40, "bf16", beta0=True, lhs_shared=True)),
        ("bmm softmax +C 130x20x32x64 bf16", BatchMatmulKey(
            130, 20, 32, 64, "bf16", softmax_lhs=True))]
    cases += [(f"pingpong fc_128x768x2304 repeats={r}", ChainKey(
        m=128, dims=(768, 2304), repeats=r, pingpong=True))
              for r in (2, 3)]
    cases += [(f"edge {label}", key) for label, key in _attention_edges()]
    return cases


# csrc/attention.cu's wgmma kernel at its edges: ragged S (77, 1000),
# seq_kv != seq, causal with S below the block's 128 rows, D 32/64/128,
# packed and split, repeats 2, on the TMA loader (bf16) and the register
# loader (f32 "default"); (label, FlashMhaKey fields)
_EDGE = (
    ("s77 flat d64", (3, 77, 77, 64, "bf16"), dict(scale=0.125)),
    ("s1000 causal packed d64", (2, 1000, 1000, 64, "bf16"),
     dict(scale=0.125, causal=True, heads=2, qkv_packed=True)),
    ("s77 causal tokens d128", (2, 77, 77, 128, "bf16"),
     dict(scale=0.09, causal=True, heads=2)),
    ("skv160 s96 split d64", (1, 96, 160, 64, "bf16"),
     dict(scale=0.125, heads=3)),
    ("skv160 s96 causal flat d32", (2, 96, 160, 32, "bf16"),
     dict(scale=0.2, causal=True)),
    ("causal s50 packed d32", (2, 50, 50, 32, "bf16"),
     dict(scale=0.2, causal=True, heads=4, qkv_packed=True)),
    ("repeats 2 flat d128", (3, 200, 200, 128, "bf16"),
     dict(scale=0.09, repeats=2)),
    ("repeats 2 causal tokens d32", (2, 130, 130, 32, "bf16"),
     dict(scale=0.2, causal=True, heads=3, repeats=2)),
    ("f32 convert skv180 d128", (2, 100, 180, 128, "f32"),
     dict(scale=0.09, heads=2)),
    ("f32 convert causal packed d32", (2, 77, 77, 32, "f32"),
     dict(scale=0.2, causal=True, heads=4, qkv_packed=True)),
)


def _attention_edges():
    from tpp_mlir_tpu_torch.xsmm import FlashMhaKey
    return [(label, FlashMhaKey(*pos, **kw)) for label, pos, kw in _EDGE]


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
        note = ""
        if kind == "chain_pingpong":
            same = torch.equal(kern(*args), got)
            ok = ok and same
            note = f" (second launch bit-equal: {same})"
        say(f"kernel {kind or 'no kernel':16s} {label:44s} rel {rel:.3e} "
            f"abs {ab:.3e} tol {tol:.0e}{note}{_route_note(key)} "
            f"{'ok' if ok else 'FAIL'}")
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
    strategies, and the c128/30 key on its forced "wmma" tile body; then
    the xla route (F.conv2d, no kernel) against the same plain version at
    "highest", which cuDNN's default TF32 would miss."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel
    from tpp_mlir_tpu_torch.xsmm.reference import (conv_nhwc_reference,
                                                   conv_route)
    from tpp_mlir_tpu_torch.xsmm.kernels import build_conv
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    cases = [(label, _conv_key(row, index, **kw), None)
             for label, row, index, kw in CONV_KERNEL_CASES]
    cases.append((CONV_KERNEL_CASES[0][0] + " forced wmma", cases[0][1],
                  "wmma"))
    for label, key, forced in cases:
        args = _conv_inputs(key, g)
        kern = build_conv(key, forced) if forced else build_kernel(key)
        got = kern(*args)
        ref = conv_nhwc_reference(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        tol = _tol(key)
        route = conv_route(key)
        ok = rel <= tol and torch_isfinite(got) and \
            kern.launches == (route == "kernel") and \
            torch.backends.cudnn.allow_tf32   # the route restores the flag
        body = f"; forced {forced}" if forced else _route_note(key)
        say(f"kernel {_kind(key) or 'no kernel':12s} {label:50s} "
            f"N{key.N} {key.H}x{key.W}x{key.C}->{key.P}x{key.Q}x{key.K} "
            f"R{key.R} pad {key.pad} {key.dtype}/{key.precision} route "
            f"{route}{body} rel {rel:.3e} abs {ab:.3e} tol {tol:.0e} "
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
    ("fc bf16 VNNI masked mb 8", "fc_bf16_packed_warm_1024", 0,
     {"Mb": 2, "mb": 8}),
    ("fc bf16 flat B (tma)", "fc_bf16_packed_warm_1024", 0, {"vnni": 0}),
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
        note = ""
        if kind == "blocked_matmul_warm":
            same = torch.equal(build_kernel(key)(*args), got)
            ok = ok and same
            note = f" (second launch bit-equal: {same})"
        say(f"kernel {kind:19s} {label:48s} {describe(key)} rel "
            f"{rel:.3e} abs {ab:.3e} tol {tol:.0e}{note}{_route_note(key)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel} > {tol}, launches "
                                 f"{kern.launches}")
        worst = stats.get(kind, {}).get("max_abs_err", 0.0)
        stats[kind] = {"max_abs_err": max(worst, ab)}
    return stats


def _warm_main_keys():
    """The warm-panel engine's main keys: the flagship chain (B3/B4), B5 at
    fc_128x768x2304 with -n 100, B20 at the fc rows' f32 key with -n 200."""
    from tpp_mlir_tpu_torch.xsmm import ChainKey
    return (("flagship bf16", ChainKey(m=BATCH, dims=(WIDTH,) * LAYERS,
                                       dtype="bf16", repeats=100)),
            ("B5 fc_128x768x2304", ChainKey(m=128, dims=(768, 2304),
                                            repeats=100, pingpong=True)),
            ("B20 fc f32", _packed_key("fc_fp32_packed_warm_1024", 0,
                                       repeats=200)))


# csrc/warm_panel.cuh beyond the keys phases 3, 4f and 4h hold: ragged rows
# and masked widths, and each body forced at the flagship, B5 and B20 keys;
# (label, key, body or None for the key's own)
def _warm_cases():
    from tpp_mlir_tpu_torch.xsmm import ChainKey
    cases = [("chain bf16 ragged 17 x 48-160-48",
              ChainKey(m=17, dims=(48, 160, 48), dtype="bf16"), None),
             ("chain f32 ragged 40 x 160-48-160 r3",
              ChainKey(m=40, dims=(160, 48, 160), repeats=3), None)]
    for label, key in (
            ("flagship bf16 r8", ChainKey(m=BATCH, dims=(WIDTH,) * LAYERS,
                                          dtype="bf16", repeats=8)),
            ("B5 fc_128x768x2304 r3", ChainKey(m=128, dims=(768, 2304),
                                               repeats=3, pingpong=True)),
            ("B20 fc f32 r3", _packed_key("fc_fp32_packed_warm_1024", 0,
                                          repeats=3)),
            ("B20 fc bf16 VNNI r3", _packed_key("fc_bf16_packed_warm_1024",
                                                0, repeats=3))):
        cases += [(f"{label} {route}", key, route)
                  for route in ("panel", "wmma")]
    return cases


def phase_warm_kernels() -> dict:
    """csrc/warm_panel.cuh: the card's cudaOccupancyMaxActiveClusters at
    each main key's plan (and at its bytes for clusters of 1 to 16, against
    reference.H100_WARM_CLUSTERS), then _warm_cases against their plain
    versions, each launched twice bit-equal."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (ChainKey, build_kernel,
                                         reference_kernel)
    from tpp_mlir_tpu_torch.xsmm.kernels import build_warm, warm_max_clusters
    from tpp_mlir_tpu_torch.xsmm.reference import (H100_WARM_CLUSTERS,
                                                   warm_plan)
    for label, key in _warm_main_keys():
        p = warm_plan(key)
        held = warm_max_clusters(p.rows, p.cluster, p.smem)
        row = ", ".join(f"C{c} {warm_max_clusters(p.rows, c, p.smem)} "
                        f"(table {H100_WARM_CLUSTERS[c]})"
                        for c in (1, 2, 4, 8, 12, 16))
        waves = "one wave" if p.clusters <= held else "more than one wave"
        say(f"warm occupancy {label}: rows {p.rows}, cluster {p.cluster}, "
            f"{p.smem} B: the card holds {held} clusters at once, the plan "
            f"launches {p.clusters} ({waves}); at {p.smem} B: {row}")
    g = torch.Generator(device="cuda").manual_seed(11)
    stats: dict[str, dict] = {}
    for label, key, route in _warm_cases():
        args = _chain_inputs(key, g) if isinstance(key, ChainKey) \
            else _blocked_inputs(key, g)
        kern = build_warm(key, route) if route else build_kernel(key)
        got, again = kern(*args), kern(*args)
        ref = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, ref)
        tol = _tol(key)
        same = torch.equal(got, again)
        ok = rel <= tol and torch_isfinite(got) and same
        kind = _kind(key)
        say(f"kernel {kind:19s} {label:40s} rel {rel:.3e} abs {ab:.3e} tol "
            f"{tol:.0e} (second launch bit-equal: {same})"
            f"{_warm_note(key, route)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel} > {tol}, or two "
                                 f"launches not bit-equal")
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


def _baseline_ms(module, iters: int) -> tuple[float, float]:
    """torch.matmul + bias + ReLU on the module's own weights, chained
    `iters` times like the perf.bench loop, by CUDA events: (eager ms, ms
    replayed from one CUDA graph), each a chain."""
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
    return cuda_ms(run, iters=1, warmup=1) / iters, \
        graph_ms(run, iters=1) / iters


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
        base, base_g = _baseline_ms(module, n)
        flops = module.attrs["flops"]
        say(f"time {label:22s} -n {n}: port {res['gflops']:.1f} GFLOP/s "
            f"({res['mean_seconds'] * 1e3:.4f} ms), torch.matmul "
            f"{flops / base / 1e6:.1f} GFLOP/s ({base:.4f} ms; replayed "
            f"from a CUDA graph {flops / base_g / 1e6:.1f} GFLOP/s, "
            f"{base_g:.4f} ms)")
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
         _chain_inputs),
        ("chain", ChainKey(m=BATCH, dims=(WIDTH,) * LAYERS, dtype="bf16",
                           repeats=n), _chain_inputs)]
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
        g, *GROUPED_WGRAD_CASES[i][1:])[:2]) for i in (1, 0, 2)]
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
        graphed = kind in ("decode_attn", "int8_gemm", "batch_matmul",
                           "layer_norm")
        # the serving kernels run inside the decode step's CUDA graph: their
        # line and the kernel table take graph-replayed times
        timer = graph_ms if graphed else cuda_ms
        bound, by = _bound(kind, key, args)
        note = " (replayed from a CUDA graph)" if graphed else ""
        if kind == "decode_attn":
            # of record: a graph whose launches walk the stacked layers, as
            # a decode step reads them (twelve slabs, more than L2 holds);
            # layer 5 replayed alone beside it (its slab can sit in L2)
            layer = _decode_library(key, args)
            walk = [_walk(lambda li: kern(*args[:4], li, *args[5:]), key),
                    _walk(lambda li: plain(*args[:4], li, *args[5:]), key),
                    _walk(layer, key) if layer else None]
            ms, plain_ms, lib_ms = (graph_ms(f, iters=2 * key.stacked)
                                    if f else None for f in walk)
            lib_5 = f", SDPA {graph_ms(library):.4f} ms" if library else ""
            note = f" (replayed from a CUDA graph walking the " \
                f"{key.stacked} layers; layer {args[4]} replayed alone " \
                f"{graph_ms(lambda: kern(*args)):.4f} ms{lib_5})" \
                f"{_route_note(key)}"
        else:
            ms = timer(lambda: kern(*args))
            plain_ms = timer(lambda: plain(*args))
            lib_ms = timer(library) if library else None
        if kind == "batch_matmul":     # the eager times beside them
            lib_e = f", library call {cuda_ms(library):.4f} ms" \
                if library else ""
            note += f" (eager: {cuda_ms(lambda: kern(*args)):.4f} ms{lib_e})"
        if getattr(key, "repeats", 0) > 1:
            note += f" ({ms / key.repeats:.4f} ms per repeat of {key.repeats})"
        if hasattr(key, "bq") and (key.strategy != "auto" or key.bq):
            note += f" (strategy {key.strategy}, bq {key.bq}, bk {key.bk})"
        if kind in ("brgemm", "blocked_matmul", "conv_nhwc",
                    "conv_blocked"):
            note += _route_note(key)
        if kind in ("conv_nhwc", "conv_blocked"):
            # the function an f32 "default" key computes (bf16 products)
            bf16 = _conv_library_bf16(kind, key, args)
            if bf16:
                note += f" (F.conv2d on bf16 I and W + epilogue " \
                    f"{cuda_ms(bf16):.4f} ms, from a CUDA graph " \
                    f"{graph_ms(bf16):.4f} ms)"
        if kind in ("chain", "chain_pingpong", "blocked_matmul_warm"):
            # no single call computes a chain: the composed PyTorch chain
            # on bf16 copies, replayed from a CUDA graph, is the yardstick
            iters = 2 if key.repeats > 8 else 20
            g_ms = graph_ms(lambda: kern(*args), iters=iters)
            c_ms = graph_ms(_composed_chain(key, args), iters=iters)
            note += f" (replayed from a CUDA graph: {g_ms:.4f} ms; composed " \
                f"chain, not one call, from a CUDA graph {c_ms:.4f} ms)" \
                f"{_warm_note(key)}"
        if kind == "int8_gemm":
            # no single call scales per row and column: torch._int_mm and
            # the epilogue in PyTorch, composed, is B15's yardstick
            c_ms = timer(_int8_composed(key, args))
            note += f" (composed torch._int_mm + scales + bias + unary, not " \
                f"one call, from a CUDA graph {c_ms:.4f} ms){_route_note(key)}"
        if kind == "layer_norm":
            note += _route_note(key)
        if kind in ("flash_train_fwd", "flash_train_bwd", "attention",
                    "brgemm", "blocked_matmul", "conv_nhwc",
                    "conv_blocked"):
            # a kernel of tens of us timed over eager launches can read the
            # host's time a call (tensor-map encodes included): the
            # device's own, from graph replay, beside it. B18's library
            # backward cannot be captured through torch.autograd.grad (the
            # engine runs on the legacy stream): the SDPA flash backward op
            # is replayed on the kept forward's outputs instead
            glib = _sdpa_backward_op(key, args) \
                if kind == "flash_train_bwd" else library
            lib_g = f", library call {graph_ms(glib):.4f} ms" \
                if glib else ""
            note += f" (replayed from a CUDA graph: " \
                f"{graph_ms(lambda: kern(*args)):.4f} ms{lib_g})"
        if kind in ("grouped_gemm", "grouped_wgrad"):
            blocks = torch.bincount(args[-3].long(), minlength=key.n_groups)
            note += f" (largest expert {int(blocks.max())} of " \
                f"{key.m // key.bm} row blocks)"
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
    # B15's and B12's first designs, forced, beside the new bodies in turns
    # (new, first, first, new), from a CUDA graph; B12 beside the card's
    # floor for one launch from the same kind of graph (an empty kernel)
    from tpp_mlir_tpu_torch.xsmm.kernels import (build_int8,
                                                 build_layer_norm,
                                                 empty_kernel)
    for kind, key, args in timed:
        if kind not in ("int8_gemm", "layer_norm"):
            continue
        if kind == "int8_gemm":
            first, forced = build_int8(key, "wmma"), "wmma"
        else:
            first, forced = build_layer_norm(key, "strided"), "strided"
        new = build_kernel(key)
        iters = 5 if kind == "int8_gemm" and key.n > 10000 else 20
        t = [graph_ms(lambda: k(*args), iters=iters)
             for k in (new, first, first, new)]
        floor = f"; an empty kernel {graph_ms(empty_kernel, iters=100):.4f}" \
            f" ms a launch" if kind == "layer_norm" else ""
        say(f"time kernel {describe(key):44s} {_route_note(key)[2:]} "
            f"{(t[0] + t[3]) / 2:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), forced "
            f"{forced} {(t[1] + t[2]) / 2:.4f} ms ({t[1]:.4f}, {t[2]:.4f}) "
            f"(from a CUDA graph){floor}")
    # B16's and B17's WMMA tile, forced at the keys the route sends to
    # wgmma, beside the wgmma tile in turns (wgmma, wmma, wmma, wgmma)
    from tpp_mlir_tpu_torch.xsmm.kernels import build_grouped_gemm
    for kind, key, args in timed:
        if kind not in ("grouped_gemm", "grouped_wgrad"):
            continue
        new, old = build_grouped_gemm(key, "wgmma"), \
            build_grouped_gemm(key, "wmma")
        t = [cuda_ms(lambda: k(*args)) for k in (new, old, old, new)]
        say(f"time kernel {describe(key):44s} wgmma tile "
            f"{(t[0] + t[3]) / 2:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), forced "
            f"wmma tile {(t[1] + t[2]) / 2:.4f} ms ({t[1]:.4f}, {t[2]:.4f})")
    # conv.cu's tile body forced to "wmma" beside its wgmma kernel, in
    # turns, from a CUDA graph, at each timed conv key with bf16 products
    from tpp_mlir_tpu_torch.xsmm.kernels import build_conv
    from tpp_mlir_tpu_torch.xsmm.reference import conv_kernel_route
    for kind, key, args in timed:
        if kind not in ("conv_nhwc", "conv_blocked") or \
                conv_kernel_route(key) not in ("tma", "convert"):
            continue
        new, old = build_kernel(key), build_conv(key, "wmma")
        t = [graph_ms(lambda: k(*args)) for k in (new, old, old, new)]
        say(f"time kernel {describe(key):44s} wgmma "
            f"{(t[0] + t[3]) / 2:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), forced "
            f"wmma body {(t[1] + t[2]) / 2:.4f} ms ({t[1]:.4f}, "
            f"{t[2]:.4f}) (from a CUDA graph){_route_note(key)}")
    return out


def _walk(fn, key):
    """A call of fn(li) whose layer index walks 0 .. key.stacked - 1, one
    layer a call, as a decode step reads the stacked cache."""
    layers = itertools.count()
    return lambda: fn(next(layers) % key.stacked)


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
        # each slot's live rows, min(pos_b + 1, S) (pos_b == S: a free
        # slot, every row), K and V (and the int8 cache's two scales)
        q, k, v, pos = args[:4]
        live = int(torch.clamp(pos.long() + 1, max=key.seq).expand(
            key.batch).sum())
        H, D, G = key.heads, key.head_dim, key.groups
        rows = H * live * D
        rate, flops = "f32", 4 * rows * G
        nbytes = 2 * rows * k.element_size() + _nbytes(q, pos) + \
            q.numel() * 4 + (2 * H * live * 4 if key.kv_quant else 0)
    elif kind == "int8_gemm":     # Xq, the K-major Wt, scales, bias, out
        xq, _, xs, ws, bias, wt = args
        rate, flops = "int8", 2 * key.m * key.n * key.k
        nbytes = _nbytes(xq, wt, xs, ws, bias) + \
            key.m * key.n * (4 if key.out_dtype == "f32" else 2)
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


def _composed_chain(key, args):
    """The composed PyTorch chain of a chain.cu or B20 key on bf16 copies of
    its inputs (its products are bf16), as one callable: torch.addmm +
    torch.relu per layer and repeat (B5: addmm + relu, then h @ W^T; B20 on
    the unpacked operands). A yardstick, not one call; used nowhere in the
    port."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import ChainKey
    bf = torch.bfloat16
    if isinstance(key, ChainKey):
        x, *wb = (t.to(bf) for t in args)
        layers = list(zip(wb[0::2], wb[1::2]))
        if key.pingpong:
            (w, b), = layers

            def run():
                h = x
                for r in range(key.repeats):
                    h = torch.relu(torch.addmm(b, h, w)) if r % 2 == 0 \
                        else h @ w.t()
            return run

        def run():
            h = x
            for _ in range(max(1, key.repeats)):
                for w, b in layers:
                    h = torch.relu(torch.addmm(b, h, w))
        return run
    a, b, _, d = args
    if key.vnni:
        b = b.movedim(-1, -2).reshape(key.Nb, key.Kb, key.kb, key.nb)
    a2 = a.permute(0, 2, 1, 3).reshape(key.Mb * key.mb, -1).to(bf)
    b2 = b.permute(1, 2, 0, 3).reshape(key.Kb * key.kb, -1).to(bf)
    bias = d.reshape(-1).to(bf)

    def run():
        h = a2
        for _ in range(key.repeats):
            h = torch.relu(torch.addmm(bias, h, b2))
    return run


def _library_call(kind, key, args):
    """One PyTorch call computing the kernel's function on the same inputs,
    timed as a yardstick and used nowhere in the port; None where there is
    none: a chain of GEMMs (B3), B5's ping-pong, B11's repeats, a batched
    matmul with its softmax, and the int8 GEMM with its scaled epilogue
    (B15) have no single call. B1: torch.addmm (bias) or torch.mm, on B's
    transposed view where the key transposes B; the
    attention kernels: scaled_dot_product_attention, forward, or for B18
    its backward alone (torch.autograd.grad of a kept forward); B21/B22:
    torch.bmm; B12: F.layer_norm; B19: torch.addmm on the unpacked
    operands; B23: F.conv2d on the unpacked NCHW operands and the
    epilogue, TF32 off; B20's repeats have no single call."""
    import torch
    import torch.nn.functional as F
    if kind == "brgemm" and not key.prologue and key.batch == 1 and \
            not key.vnni:
        a, b, c, d = args[:4]
        b0 = b[0].t() if key.transpose_b else b[0]     # (n, k) -> (k, n)
        if key.binary_kind == "add" and key.binary_bcast == "bcast_col":
            return lambda: torch.addmm(d, a[0], b0)
        return lambda: torch.mm(a[0], b0)
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
    if kind == "decode_attn":
        layer = _decode_library(key, args)
        return (lambda: layer(args[4])) if layer else None
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


def _int8_composed(key, args):
    """B15's yardstick, composed and not one call, used nowhere in the port:
    torch._int_mm (s8 x s8 -> s32) on the same operands, its weight laid
    out column-major (a view of the K-major copy, made here, untimed), then
    the two scales, the bias (widened here) and the unary in PyTorch
    (F.gelu, the exact-erf gelu that gelu_exp2 meets within an ulp)."""
    import torch
    import torch.nn.functional as F

    from tpp_mlir_tpu_torch.xsmm.reference import UNARY_FNS
    xq, wq, xs, ws, bias, wt = args
    w = wt.t()
    try:
        torch._int_mm(xq, w)
    except RuntimeError:
        w = wq
    xs2, ws2 = xs.reshape(-1, 1), ws.reshape(1, -1)
    b = bias.float().reshape(1, -1) if bias is not None else None
    unary = F.gelu if key.unary_kind == "gelu" else \
        UNARY_FNS.get(key.unary_kind)

    def run():
        y = torch._int_mm(xq, w).float() * xs2 * ws2
        if b is not None:
            y = y + b
        return unary(y) if unary else y
    return run


def _decode_library(key, args):
    """SDPA on each layer's live rows, as call(li): the rows up to the
    largest min(pos_b + 1, S), copied contiguous here (untimed) for every
    layer of the stacked cache, and for a slotted key a mask of each slot's
    rows past its own pos, so the call computes B13's function. None where
    no SDPA call does: GQA's groups, the int8 cache's scales, pack2's
    layout."""
    import torch
    import torch.nn.functional as F
    if key.groups != 1 or key.kv_quant or key.pack2:
        return None
    q, k, v, pos = args[:4]
    live = int(torch.clamp(pos.long() + 1, max=key.seq).max())
    kl = [t[:, :, :live].contiguous() for t in k]
    vl = [t[:, :, :live].contiguous() for t in v]
    mask = torch.arange(live, device=q.device) <= pos.reshape(-1, 1, 1, 1) \
        if key.slotted else None
    q4 = q[:, :, None]
    return lambda li: F.scaled_dot_product_attention(
        q4, kl[li], vl[li], attn_mask=mask, scale=key.head_dim ** -0.5)


def _conv_library_bf16(kind, key, args):
    """For an f32 "default" conv key (bf16 products, f32 sums): F.conv2d on
    bf16 copies of I and W (copied here, untimed) and the f32 epilogue, the
    key's own function up to the rounding of the conv's output to bf16;
    None for any other key."""
    import torch
    if key.dtype != "f32" or key.precision != "default":
        return None
    i, w, c, d = args
    half = (i.to(torch.bfloat16), w.to(torch.bfloat16), c, d)
    return _conv_library_call(key, half) if kind == "conv_nhwc" \
        else _conv_blocked_library_call(key, half)


def _sdpa_backward_op(key, args):
    """SDPA's flash backward op alone, on the outputs of one flash forward
    of the same q, k, v (B, H, S, D) and the cotangent: what
    torch.autograd.grad of SDPA runs, without the autograd engine, so that
    a CUDA graph can capture it."""
    import torch
    q, k, v, g = (t.transpose(1, 2).contiguous() for t in args[:4])
    aten = torch.ops.aten
    o, lse, cq, ck, mq, mk, seed, off, _ = \
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, key.causal,
                                                 False, scale=key.scale)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        g, q, k, v, o, lse, cq, ck, mq, mk, 0.0, key.causal, seed, off,
        scale=key.scale)


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


# ---- B2's LN-stats pair; int4 serving; LoRA/QLoRA, remat, checkpoints ----

# B2's producer/consumer pair through the kernel-key API (no pass emits it):
# a GPT-2 fc-class producer (m 2048, k 768, n 3072, + bias, gelu,
# ln_stats_out) and its consumer (k 3072, n 768, + bias, the ln_stats
# prologue on the producer's mean and var), in f32 "default", f32
# "highest" and bf16, and at an n no tile divides (3000: 23.4 tiles of 128)
LN_STATS_M, LN_STATS_K = 2048, 768
LN_STATS_CASES = (("bf16", "default", 3072), ("f32", "default", 3072),
                  ("f32", "highest", 3072), ("bf16", "default", 3000),
                  ("f32", "default", 3000))
TOL_STATS = 1e-5    # the row statistics: f32 sums of the same values

# int4 serving and the LoRA slice at GPT-2 small's full width, bf16
INT4_STEPS = 16
LORA_B, LORA_S, LORA_RANK, LORA_TARGETS = 4, 512, 8, ("wq", "wv")
LORA_STEPS, LORA_LR = 5, 1e-3


def _ln_stats_keys(dtype: str, precision: str, n: int):
    from tpp_mlir_tpu_torch.xsmm import BrgemmKey
    common = dict(batch=1, m=LN_STATS_M, dtype=dtype, precision=precision,
                  beta0=True, binary_kind="add")
    return (BrgemmKey(n=n, k=LN_STATS_K, unary_kind="gelu",
                      ln_stats_out=True, **common),
            BrgemmKey(n=LN_STATS_K, k=n, prologue="ln_stats", **common))


def _ln_stats_inputs(kp, kc, g):
    """The producer's (A, W1, None, bias) and the consumer's (W2, None,
    bias, gamma, beta): W ~ N(0, 1/k), biases ~ N(0, 0.01), gamma near 1."""
    import torch
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kp.dtype]

    def rnd(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device="cuda") * scale + shift
    return ((rnd((1, kp.m, kp.k)).to(dt),
             rnd((1, kp.k, kp.n), kp.k ** -0.5).to(dt), None,
             rnd((kp.n,), 0.1)),
            (rnd((1, kc.k, kc.n), kc.k ** -0.5).to(dt), None,
             rnd((kc.n,), 0.1), rnd((kc.k,), 0.2, 1.0), rnd((kc.k,), 0.1)))


def _ln_stats_pair(prod, cons, pa, ca):
    """The pair as a caller runs it: (y, mean, var) = producer(A), then the
    consumer on y with them. Returns (y, mean, var, z)."""
    y, mu, var = prod(*pa)
    w2, c, b2, gamma, beta = ca
    z = cons(y.reshape(1, *y.shape), w2, c, b2, gamma=gamma, beta=beta,
             mu=mu, var=var)
    return y, mu, var, z


def phase_ln_stats_kernels() -> dict:
    """Phase 3 for B2's pair: at each LN_STATS_CASES key the producer's y
    against its plain version (the single-GEMM tolerance), its mean and var
    against the plain statistics of its own stored y (TOL_STATS; against
    the plain version's own for information), the consumer on them against
    its plain version (the LayerNorm-prologue tolerance), and both launched
    twice bit-equal: no atomics, no k split."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    from tpp_mlir_tpu_torch.xsmm.kernels import gemm_plan
    from tpp_mlir_tpu_torch.xsmm.reference import ln_stats_out
    g = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for dtype, precision, n in LN_STATS_CASES:
        kp, kc = _ln_stats_keys(dtype, precision, n)
        pa, ca = _ln_stats_inputs(kp, kc, g)
        prod, cons = build_kernel(kp), build_kernel(kc)
        got = _ln_stats_pair(prod, cons, pa, ca)
        again = _ln_stats_pair(prod, cons, pa, ca)
        py, pmu, pvar = reference_kernel(kp)(*pa)
        w2, c, b2, gamma, beta = ca
        pz = reference_kernel(kc)(got[0].reshape(1, *got[0].shape), w2, c,
                                  b2, gamma=gamma, beta=beta, mu=got[1],
                                  var=got[2])
        torch.cuda.synchronize()
        y, mu, var, z = got
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rel_y, ab_y = rel_err(y, py)
        own = ln_stats_out(y)
        (rel_mu, ab_mu), (rel_var, ab_var) = rel_err(mu, own[0]), \
            rel_err(var, own[1])
        rel_plain = max(rel_err(mu, pmu)[0], rel_err(var, pvar)[0])
        rel_z, ab_z = rel_err(z, pz)
        ok = (rel_y <= _tol(kp) and max(rel_mu, rel_var) <= TOL_STATS
              and rel_z <= _tol(kc) and same and torch_isfinite(z))
        plan = gemm_plan(kp)
        say(f"kernel brgemm_ln_stats {dtype} {precision} fc {LN_STATS_M}x"
            f"{n}x{LN_STATS_K} +gelu -> {LN_STATS_M}x{LN_STATS_K}x{n}: "
            f"producer y rel {rel_y:.3e} (tol {_tol(kp):.0e}), mean rel "
            f"{rel_mu:.3e} var rel {rel_var:.3e} against its own y's "
            f"(tol {TOL_STATS:.0e}; against the plain version's "
            f"{rel_plain:.3e}); consumer rel {rel_z:.3e} abs {ab_z:.3e} "
            f"(tol {_tol(kc):.0e}); second launch bit-equal {same}; tile "
            f"{plan[0]}x{plan[1]} split {plan[2]}{_route_note(kp)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ln_stats {dtype} {precision} n {n}: y "
                                 f"{rel_y}, stats {rel_mu}/{rel_var}, "
                                 f"consumer {rel_z}, bit-equal {same}")
        worst = max(worst, ab_y, ab_mu, ab_var, ab_z)
    return {"brgemm_ln_stats": {"max_abs_err": worst}}


def phase_ln_stats_path() -> dict:
    """The pair's main path: the bf16 GPT-2 fc-class producer and its
    consumer through xsmm's kernel cache, as a caller of the kernel-key API
    runs them, with the launch counts set to 0 just before and read just
    after (one launch each)."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    kp, kc = _ln_stats_keys(*LN_STATS_CASES[0])
    g = torch.Generator(device="cuda").manual_seed(4)
    pa, ca = _ln_stats_inputs(kp, kc, g)
    cache.reset_launches()
    z = _ln_stats_pair(cache.dispatch(kp), cache.dispatch(kc), pa, ca)[3]
    torch.cuda.synchronize()
    launches = _launches(cache)
    moved = {k: v for k, v in launches.items() if v}
    ok = moved == {"brgemm_ln_stats": 2} and torch_isfinite(z)
    say(f"main brgemm_ln_stats pair {LN_STATS_M}x{kp.n}x{kp.k} bf16 through "
        f"the kernel cache: launches {moved} (want brgemm_ln_stats 2), "
        f"output {tuple(z.shape)} finite {torch_isfinite(z)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"ln_stats path: launches {moved}")
    return launches


def _ln_stats_composed(kp, kc, pa, ca):
    """The pair's function as PyTorch composes it: addmm + gelu, a full
    F.layer_norm, addmm, in the operands' dtype (TF32 off)."""
    import torch
    import torch.nn.functional as F
    a, w1, _, b1 = pa
    w2, _, b2, gamma, beta = ca
    dt = a.dtype
    b1, b2, gamma, beta = (t.to(dt) for t in (b1, b2, gamma, beta))

    def run():
        y = F.gelu(torch.addmm(b1, a[0], w1[0]))
        h = F.layer_norm(y, (kc.k,), gamma, beta, kc.prologue_eps)
        return torch.addmm(b2, h, w2[0])
    return run


def phase_ln_stats_timing() -> dict:
    """The pair (producer then consumer) from a CUDA graph beside its plain
    versions and the composed addmm -> F.layer_norm -> addmm chain, at the
    bf16 GPT-2 fc key (the kernel line's) and f32 "default"; its bound: the
    bytes the two must move (A, both weights, biases, gamma, beta, y once
    each way, the statistics, the output) over HBM's rate, or their
    products at the bf16 rate."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for dtype, precision, n in LN_STATS_CASES[:2]:
        kp, kc = _ln_stats_keys(dtype, precision, n)
        pa, ca = _ln_stats_inputs(kp, kc, g)
        prod, cons = build_kernel(kp), build_kernel(kc)
        pprod, pcons = reference_kernel(kp), reference_kernel(kc)
        ms = graph_ms(lambda: _ln_stats_pair(prod, cons, pa, ca))
        plain_ms = graph_ms(lambda: _ln_stats_pair(pprod, pcons, pa, ca))
        composed = _ln_stats_composed(kp, kc, pa, ca)
        comp_ms = graph_ms(composed)
        y, mu, var, z = _ln_stats_pair(prod, cons, pa, ca)
        nbytes = _nbytes(*pa, *ca, mu, var, z) + 2 * _nbytes(y)
        flops = 2 * kp.m * kp.n * kp.k + 2 * kc.m * kc.n * kc.k
        b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK["bf16"]
        bound, by = max((b_bytes, "bytes"), (b_ops, "operations"))
        bound *= 1e3
        p_ms = graph_ms(lambda: prod(*pa))
        say(f"time kernel brgemm_ln_stats pair {dtype} {precision} "
            f"{LN_STATS_M}x{n}x{LN_STATS_K} -> {LN_STATS_M}x{LN_STATS_K}x"
            f"{n}: {ms:.4f} ms (the producer alone {p_ms:.4f} ms), plain "
            f"versions {plain_ms:.4f} ms, composed addmm + gelu -> "
            f"F.layer_norm -> addmm (not one call) {comp_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}) (from CUDA graphs)")
        out.setdefault("brgemm_ln_stats", {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    return out


def _payload_bytes(params) -> int:
    """The QTensor payloads' bytes of a params tree (scales left out)."""
    from tpp_mlir_tpu_torch.serving import QTensor
    leaves = [v for k, v in params.items() if k != "blocks"]
    leaves += [v for blk in params["blocks"] for v in blk.values()]
    return sum(v.q.numel() * v.q.element_size() for v in leaves
               if isinstance(v, QTensor))


def phase_int4_serving() -> dict:
    """GPT-2 small with packed int4 weights (ROADMAP A7), b8 with a
    512-token prompt, 16 greedy steps through make_generate: its eager
    launches (B7 12, B13 12 x 15), the graph-replayed tokens equal to the
    eager ones, the prefill and teacher-forced decode logits against the
    kernels-off engine on the same int4 weights (TOL_MODEL), the greedy
    tokens against the kernels-off argmax wherever the kernels-off logits'
    top-2 margin exceeds twice the row's max |kernels on - off| (all must
    agree there), and the weights' bytes beside int8's."""
    import torch

    from tpp_mlir_tpu_torch.serving import (make_decode_step, make_generate,
                                            make_prefill, quantize_params,
                                            quantized_bytes)
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    t0 = time.perf_counter()
    cfg, params, ids = _serving_setup(GPT2_SERVE, False, 4)
    cache.reset_launches()
    toks = make_generate(cfg, INT4_STEPS, graph=False)(params, ids)
    torch.cuda.synchronize()
    launches = _launches(cache)
    want = {"attention": cfg.layers,
            "decode_attn": cfg.layers * (INT4_STEPS - 1), "int8_gemm": 0}
    same = torch.equal(make_generate(cfg, INT4_STEPS)(params, ids), toks)
    off = _kernels_off(cfg)
    la, ca = make_prefill(cfg)(params, ids)
    lb, cb = make_prefill(off, use_kernels=False)(params, ids)
    finite = torch_isfinite(la)
    rel_p, _ = rel_err(la, lb)
    step_a = make_decode_step(cfg)
    step_b = make_decode_step(off, use_kernels=False)
    rel_d, clear, agree = 0.0, 0, 0
    for t in range(INT4_STEPS - 1):
        la, ca = step_a(params, ca, toks[:, t])
        lb, cb = step_b(params, cb, toks[:, t])
        finite = finite and torch_isfinite(la)
        rel_d = max(rel_d, rel_err(la, lb)[0])
        noise = (la.float() - lb.float()).abs().amax(-1)
        top = lb.float().topk(2, -1).values
        sure = (top[:, 0] - top[:, 1]) > 2 * noise
        clear += int(sure.sum())
        agree += int((sure & (lb.argmax(-1).to(torch.int32)
                              == toks[:, t + 1])).sum())
    b4, p4 = quantized_bytes(params), _payload_bytes(params)
    q8 = quantize_params(_serving_setup(GPT2_SERVE, False, False)[1])
    b8, p8 = quantized_bytes(q8), _payload_bytes(q8)
    del q8
    ok = (all(launches[k] == v for k, v in want.items()) and same and finite
          and max(rel_p, rel_d) <= TOL_MODEL and agree == clear
          and 2 * p4 == p8)
    say(f"main gpt2_small_serve_b8_int4: generate {tuple(toks.shape)} (b"
        f"{SERVE_BATCH} prompt {SERVE_PROMPT}); eager launches "
        f"{ {k: launches[k] for k in want} } (want {want}); graph tokens == "
        f"eager {same}; vs kernels off: prefill rel {rel_p:.3e}, "
        f"teacher-forced decode rel {rel_d:.3e} (tol {TOL_MODEL:.0e}); "
        f"greedy tokens equal to the kernels-off argmax {agree} of {clear} "
        f"where the top-2 margin exceeds twice the noise (of "
        f"{SERVE_BATCH * (INT4_STEPS - 1)}); weights {b4:,} bytes against "
        f"int8's {b8:,} (payloads {p4:,} against {p8:,}) "
        f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"int4 serving: launches {launches}, graph "
                             f"{same}, finite {finite}, rel {rel_p}/{rel_d},"
                             f" agree {agree}/{clear}, payload {p4}/{p8}")
    return launches


def _lora_adapters(params, seed: int):
    """lora_init's adapters with B drawn too (N(0, 0.01^2), seeded), so
    that step 0's gradient reaches A as well."""
    import torch

    from tpp_mlir_tpu_torch.serving import lora_init
    ad = lora_init(params, rank=LORA_RANK, targets=LORA_TARGETS, seed=seed,
                   device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    for blk in ad["blocks"]:
        for ab in blk.values():
            ab["b"].copy_(torch.randn(ab["b"].shape, generator=g,
                                      device="cuda") * 0.01)
    return ad


class _PlainCache:
    """A kernel cache that hands out plain versions (for _plain_flash)."""

    @staticmethod
    def dispatch(key):
        from tpp_mlir_tpu_torch.xsmm import reference_kernel
        return reference_kernel(key)


@contextlib.contextmanager
def _plain_flash():
    """B14 and B18 run as their plain versions on the card's tensors (the
    same bf16 roundings of P and dS), in place of the kernels, inside
    flash_attention_train."""
    from tpp_mlir_tpu_torch.xsmm import flash_train
    real = flash_train.global_cache
    flash_train.global_cache = _PlainCache
    try:
        yield
    finally:
        flash_train.global_cache = real


def _lora_run(cfg, base, ids, steps: int, kernels: bool = True,
              seed: int = 1):
    """`steps` LoRA steps from fresh adapters: (losses, step-0 grads,
    seconds a step, adapters, optimizer)."""
    import torch

    from tpp_mlir_tpu_torch.parallel import adamw, tree_leaves
    from tpp_mlir_tpu_torch.serving import make_lora_train_step
    ad = _lora_adapters(base, seed)
    step, init = make_lora_train_step(cfg, adamw(LORA_LR),
                                      use_kernels=kernels)
    st = init(ad)
    losses, secs, grads = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, loss = step(base, ad, st, ids)
        losses.append(loss.item())
        secs.append(time.perf_counter() - t)
        if i == 0:
            grads = [x.grad.clone() for x in tree_leaves(ad)]
    return losses, grads, secs, ad, st


def phase_lora() -> dict:
    """LoRA and QLoRA (ROADMAP A10) at GPT-2 small's full width, bf16, B 4 x
    S 512, rank 8 on wq/wv, AdamW, 5 steps, on a bf16, an int8 and a packed
    int4 base: the step-0 adapter grads against the same step with B14/B18's
    plain versions and against the kernels-off route (composed attention
    in f32), all leaves jointly within TOL_GRAD (relative Frobenius), the
    worst leaf of each printed beside the two references' own worst leaf:
    the top layers' wq adapters are ill-conditioned at initialization and
    read ~3.5e-2 against either reference at B 4 (PERF.md), the loss at
    every step, falling, ms per step (steps 2-5), 12
    B14 and 12 B18 launches a step and no B7; the bf16 base's trained
    adapters merged and served (make_generate, 8 steps: B7 12, B13 12 x
    7); a MoE-8 model at 2 layers with adapters on its expert stacks, one
    step through the grouped form (B16, B17 launched). Then remat on and off (the same losses, the peak memory of each),
    and a checkpoint of adapters and optimizer state after 2 steps
    restored into fresh ones and run 2 more: equal, bit for bit, to 4
    uninterrupted steps."""
    import tempfile

    import numpy as np
    import torch

    from tpp_mlir_tpu_torch.parallel import (adamw, restore_checkpoint,
                                             save_checkpoint, tree_leaves)
    from tpp_mlir_tpu_torch.serving import (GptConfig, init_params,
                                            lora_init, make_generate,
                                            make_lora_train_step, merge_lora,
                                            quantize_params)
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    cfg = GptConfig(**GPT2_SERVE)
    base0 = init_params(cfg, seed=0, device="cuda")
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (LORA_B, LORA_S)).astype(np.int32)).to("cuda")
    total: dict[str, int] = {}
    trained = None
    for bits in (0, 8, 4):
        label = {0: "lora bf16", 8: "qlora int8", 4: "qlora int4"}[bits]
        base = quantize_params(base0, bits=bits) if bits else base0
        off_losses, off_grads, _, _, _ = _lora_run(cfg, base, ids, 1,
                                                   kernels=False)
        with _plain_flash():
            _, plain_grads, _, _, _ = _lora_run(cfg, base, ids, 1)
        cache.reset_launches()
        losses, grads, secs, ad, _ = _lora_run(cfg, base, ids, LORA_STEPS)
        launches = _launches(cache)
        names = [f"{i}.{n}.{ab}" for i, blk in enumerate(ad["blocks"])
                 for n in sorted(blk) for ab in ("a", "b")]

        def rel(a, b):
            return ((a.float() - b.float()).norm() / b.float().norm()).item()

        def against(got, ref):
            """(worst leaf, its error, all leaves jointly) of got - ref."""
            errs = {n: rel(a, b) for n, a, b in zip(names, got, ref)}
            worst = max(errs, key=errs.get)
            joint = rel(torch.cat([x.flatten() for x in got]),
                        torch.cat([x.flatten() for x in ref]))
            return worst, errs[worst], joint
        w_off, e_off, j_off = against(grads, off_grads)
        w_pl, e_pl, j_pl = against(grads, plain_grads)
        w_rr, e_rr, _ = against(plain_grads, off_grads)
        want = {"flash_train_fwd": cfg.layers * LORA_STEPS,
                "flash_train_bwd": cfg.layers * LORA_STEPS, "attention": 0}
        finite = all(torch_isfinite(x) for x in grads)
        ms = sum(secs[1:]) / len(secs[1:]) * 1e3
        ok = (max(j_off, j_pl) <= TOL_GRAD and losses[-1] < losses[0]
              and finite and abs(losses[0] - off_losses[0]) <= TOL_BF16
              and all(launches[k] == v for k, v in want.items()))
        say(f"main train {label} gpt2 small b{LORA_B} s{LORA_S} rank "
            f"{LORA_RANK} {'/'.join(LORA_TARGETS)} adamw: losses {losses} "
            f"(kernels off step 0: {off_losses[0]:.6f}); step-0 adapter "
            f"grads, rel Frobenius over {len(names)} leaves, all jointly "
            f"(tol {TOL_GRAD:.0e}) and the worst leaf: against the "
            f"kernels-off route (composed attention) {j_off:.3e}, worst "
            f"{e_off:.3e} ({w_off}); against the same step with B14/B18's "
            f"plain versions {j_pl:.3e}, worst {e_pl:.3e} ({w_pl}); the "
            f"two references against each other, worst {e_rr:.3e} "
            f"({w_rr}); launches { {k: launches[k] for k in want} } (want "
            f"{want}); {ms:.4f} ms/step (steps 2-{LORA_STEPS}, host clock "
            f"around synchronized steps) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: grads jointly {j_off} / {j_pl}"
                                 f", losses {losses}, launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if bits == 0:
            trained = ad
        del base, ad
    # the trained adapters baked in and served: B7 and B13 on the merged
    # weights
    merged = merge_lora(base0, trained)
    cache.reset_launches()
    toks = make_generate(cfg, 8, graph=False)(merged, ids)
    torch.cuda.synchronize()
    launches = _launches(cache)
    want = {"attention": cfg.layers, "decode_attn": cfg.layers * 7}
    ok = all(launches[k] == v for k, v in want.items()) and \
        tuple(toks.shape) == (LORA_B, 8)
    say(f"main serve the merged lora model: generate {tuple(toks.shape)}; "
        f"launches { {k: launches[k] for k in want} } (want {want}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"merged serving: launches {launches}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del merged
    # MoE at small depth: adapters on the expert stacks, trained through
    # the grouped form's autograd Function (B16 forward and dgrads, B17)
    mcfg = GptConfig(**dict(GPT2_SERVE, layers=2), n_experts=8, top_k=2,
                     moe_prefill_form="grouped", moe_group_bm=128)
    mbase = init_params(mcfg, seed=0, device="cuda")
    mloss = {}
    for kernels in (False, True):
        ad = lora_init(mbase, rank=LORA_RANK, targets=("w1", "w2"), seed=3,
                       device="cuda")
        step, init = make_lora_train_step(mcfg, adamw(LORA_LR),
                                          use_kernels=kernels)
        cache.reset_launches()
        mloss[kernels] = step(mbase, ad, init(ad), ids)[2].item()
        launches = _launches(cache)
    want = ("grouped_gemm", "grouped_wgrad", "flash_train_fwd",
            "flash_train_bwd")
    ok = all(launches[k] > 0 for k in want) and \
        all(math.isfinite(v) for v in mloss.values())
    say(f"main train lora moe-8 2 layers (grouped form) w1/w2: step-0 loss "
        f"{mloss[True]:.6f}, kernels off {mloss[False]:.6f} (for "
        f"information: a router near-tie flips a token's experts); "
        f"launches { {k: launches[k] for k in want} } (each must move) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"moe lora: launches {launches}, loss {mloss}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del mbase
    # remat: the same two steps with each layer recomputed in the backward
    runs = {}
    for remat in (False, True):
        rcfg = dataclasses.replace(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, _, secs, ad, st = _lora_run(rcfg, base0, ids, 2)
        runs[remat] = (losses, torch.cuda.max_memory_allocated(),
                       secs[1] * 1e3)
        del ad, st
    (l0, m0, s0), (l1, m1, s1) = runs[False], runs[True]
    dl = max(abs(a - b) for a, b in zip(l0, l1))
    ok = dl <= 1e-6
    say(f"main train lora remat: losses without {l0}, with {l1} (max "
        f"|diff| {dl:.3e}, bit-equal {l0 == l1}; tol 1e-6); peak "
        f"torch.cuda.max_memory_allocated {m0 / 2**20:.1f} MiB without, "
        f"{m1 / 2**20:.1f} MiB with; second step {s0:.4f} ms without, "
        f"{s1:.4f} ms with {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"remat losses {l0} / {l1}")
    # a checkpoint of adapters and AdamW state, resumed
    full, _, _, ad_full, _ = _lora_run(cfg, base0, ids, 4)
    first, _, _, ad2, st2 = _lora_run(cfg, base0, ids, 2)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, {"adapters": ad2, "opt": st2}, step=2)
        del ad2, st2
        _, _, _, ad3, st3 = _lora_run(cfg, base0, ids, 0, seed=7)
        got, at = restore_checkpoint(d, {"adapters": ad3, "opt": st3},
                                     step=2)
    step, _ = make_lora_train_step(cfg, adamw(LORA_LR))
    resumed = [step(base0, got["adapters"], got["opt"], ids)[2].item()
               for _ in range(2)]
    same = (first + resumed == full and at == 2 and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(got["adapters"]),
                                          tree_leaves(ad_full))))
    say(f"main train lora checkpoint: 2 steps, saved, restored into fresh "
        f"adapters and AdamW state, 2 more: losses {first + resumed} against "
        f"uninterrupted {full}; adapters and losses bit-equal {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the resumed LoRA run differs from the "
                             "uninterrupted one")
    return total

# ---------------------------------------------------------------------------
# the parallel layer (ROADMAP A11): a world of one over NCCL and a world of
# two ranks on the one card over gloo

PAR_DECODE_STEPS = 16           # the tp decode's greedy steps, b8
PAR_MLP_B = 256                 # the MLP SGD step: TRAIN_LAYERS at b256 bf16
PAR_PIPE = (4, 256, WIDTH)      # the pipeline: n_micro, microbatch, width
PAR_RING = (2, 2048, 12, 64)    # ring attention: B, S, H, D (bf16)
PAR_MOE = (2048, 768, 3072, 8)  # ep MoE: tokens, d_model, d_ff, experts
PAR_MHA = (8, 512)              # the tp MHA at GPT-2 small's E and H: B, S


def _par_meshes(deg: int) -> dict:
    """Each mode's mesh over the world's `deg` ranks."""
    from tpp_mlir_tpu_torch.parallel import make_mesh
    return {"tp": make_mesh({"dp": 1, "tp": deg}),
            "pp": make_mesh({"pp": deg}), "sp": make_mesh({"sp": deg}),
            "ep": make_mesh({"ep": deg})}


def _par_decode(cfg, params, ids, mesh, graph: bool, force=None):
    """The unsharded prefill, then PAR_DECODE_STEPS greedy tp decode steps
    on this rank's shards (or, given `force` (B, steps + 1), steps fed its
    tokens): (the full prefill cache, tokens (B, steps + 1), each step's
    logits, ms a step on the host clock around the synchronized loop after
    its first step, capture excluded)."""
    import torch

    from tpp_mlir_tpu_torch.parallel import shard_tree
    from tpp_mlir_tpu_torch.serving import DecodeRunner, make_prefill
    from tpp_mlir_tpu_torch.serving.engine import (decode_cache_specs,
                                                   decode_param_specs,
                                                   make_tp_decode_step)
    logits, cache = make_prefill(cfg)(params, ids)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    run = DecodeRunner(make_tp_decode_step(mesh, cfg),
                       shard_tree(params, decode_param_specs(cfg), mesh),
                       shard_tree(cache, decode_cache_specs(cfg), mesh),
                       tok, graph)
    toks, lgs = [tok], []
    for t in range(PAR_DECODE_STEPS):
        if t == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        lg = run(tok if force is None else force[:, t]).clone()
        tok = lg.argmax(-1).to(torch.int32)
        lgs.append(lg)
        toks.append(tok)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (PAR_DECODE_STEPS - 1)
    return cache, torch.stack(toks, 1), lgs, ms


def _par_decode_ref(cfg, params, cache, toks, lgs) -> tuple[float, bool]:
    """The one-device decode teacher-forced on the tp run's tokens: (max
    rel err of the logits, inf where either is not finite; whether its
    greedy tokens are the tp run's)."""
    from tpp_mlir_tpu_torch.serving import make_decode_step
    step, worst, same = make_decode_step(cfg), 0.0, True
    for t, lg in enumerate(lgs):
        ref, _ = step(params, cache, toks[:, t])
        err = rel_err(lg, ref)[0] if torch_isfinite(lg) and \
            torch_isfinite(ref) else math.inf
        worst = max(worst, err)
        same = same and bool((ref.argmax(-1) == toks[:, t + 1]).all())
    return worst, same


def _par_train(cfg, params0, ids, mesh, flash: bool = True):
    """Two AdamW steps of make_gpt_train_step over `mesh` with zero1 and
    vocab_parallel on this rank's shards: (step-0 loss, step-0 grads
    gathered, the losses, the second step's ms on the host clock)."""
    from tpp_mlir_tpu_torch.parallel import (adamw, gpt_param_specs,
                                             make_gpt_train_step,
                                             shard_tree, tree_leaves)
    from tpp_mlir_tpu_torch.parallel.mesh import gather_tensor
    from tpp_mlir_tpu_torch.parallel.optim import spec_leaves
    specs = gpt_param_specs(cfg, vocab_parallel=True)
    params = shard_tree(params0, specs, mesh)
    step, init = make_gpt_train_step(cfg, adamw(1e-3), flash_attn=flash,
                                     mesh=mesh, zero1=True,
                                     vocab_parallel=True)
    state = init(params)
    losses = []
    for i in range(2):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, ids)
        losses.append(loss.item())
        if i == 0:
            grads = [gather_tensor(t.grad, s, mesh) for t, s in
                     zip(tree_leaves(params), spec_leaves(specs))]
    return losses[0], grads, losses, (time.perf_counter() - t0) * 1e3


def _par_train_ref(cfg, params0, ids, loss0, grads) -> tuple:
    """The one-device step's step-0 loss and grads against the tp run's:
    (|loss diff|, rel Frobenius error of all grads jointly, the worst
    leaf's, that leaf); bk excluded, as phase 4d excludes it (its grad is
    zero but for rounding). In bf16 a leaf whose grad nearly cancels at
    initialization (a top layer's bq or wq) moves by a few 1e-2 between
    two valid sum orders, so there the grads are held jointly at TOL_GRAD
    and each leaf only at TOL_GRAD_LEAF; the f32 run holds each leaf at
    TOL_F32."""
    from tpp_mlir_tpu_torch.parallel import (adamw, make_gpt_train_step,
                                             tree_leaves)
    params = _clone(params0)
    step, init = make_gpt_train_step(cfg, adamw(1e-3))
    _, _, loss = step(params, init(params), ids)
    pairs = [(n, a.float(), t.grad.float()) for n, a, t in
             zip(_leaf_names(params), grads, tree_leaves(params))
             if not n.endswith(".bk")]
    errs = {n: ((a - b).norm() / b.norm()).item() for n, a, b in pairs}
    worst = max(errs, key=errs.get)
    joint = (sum(((a - b).norm() ** 2).item() for _, a, b in pairs)
             / sum((b.norm() ** 2).item() for _, _, b in pairs)) ** 0.5
    return abs(loss.item() - loss0), joint, errs[worst], worst


def _par_modes(meshes, g) -> dict:
    """The MLP dp x tp SGD step, the tp MHA, the pipeline, ring attention
    and the ep MoE on this rank's shards, each output gathered, with the
    full inputs it ran from: {mode: (output, inputs)}."""
    import torch

    from tpp_mlir_tpu_torch.parallel import (
        P, gather_tree, make_mha_forward, make_moe_forward,
        make_pipeline_forward, make_ring_attention, make_train_step,
        mha_param_specs, mha_params, mlp_init, moe_init, moe_param_specs,
        param_specs, pipeline_init, pipeline_param_specs, shard_tree)
    out = {}
    tp, pp, sp, ep = (meshes[k] for k in ("tp", "pp", "sp", "ep"))
    layers = TRAIN_LAYERS
    mlp = mlp_init(layers, dtype="bfloat16", seed=3)
    x = torch.randn(PAR_MLP_B, layers[0], generator=g, device="cuda").to(
        torch.bfloat16)
    y = torch.randn(PAR_MLP_B, layers[-1], generator=g, device="cuda").to(
        torch.bfloat16)
    specs = param_specs(len(layers) - 1)
    new, loss = make_train_step(layers, 0.05, mesh=tp)(
        shard_tree(mlp, specs, tp), shard_tree(x, P("dp"), tp),
        shard_tree(y, P("dp"), tp))
    out["mlp"] = ((loss, gather_tree(new, specs, tp)), (mlp, x, y))
    E, H = GPT2_SERVE["embed"], GPT2_SERVE["heads"]
    mp = mha_params(E, H, dtype="bfloat16", seed=4)
    xm = torch.randn(*PAR_MHA, E, generator=g, device="cuda").to(
        torch.bfloat16)
    om = make_mha_forward(tp, E, H)(shard_tree(mp, mha_param_specs(), tp),
                                    shard_tree(xm, P("dp"), tp))
    out["mha"] = (gather_tree(om, P("dp"), tp), (mp, xm))
    n_micro, mb, d = PAR_PIPE
    pparams = pipeline_init(d, pp.size("pp"), dtype="bfloat16", seed=5)
    xs = torch.randn(n_micro, mb, d, generator=g, device="cuda").to(
        torch.bfloat16)
    out["pipeline"] = (make_pipeline_forward(pp, d)(
        shard_tree(pparams, pipeline_param_specs(), pp), xs), (pparams, xs))
    B, S, Hr, D = PAR_RING
    qkv = [torch.randn(B, S, Hr, D, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(3)]
    seq = P(None, "sp")
    ro = make_ring_attention(sp, Hr, causal=True)(
        *(shard_tree(t, seq, sp) for t in qkv))
    out["ring"] = (gather_tree(ro, seq, sp), qkv)
    T, dm, dff, ne = PAR_MOE
    mo = moe_init(dm, dff, ne, seed=6)
    xe = torch.randn(T, dm, generator=g, device="cuda")
    oe = make_moe_forward(ep, dm, dff, ne)(shard_tree(mo, moe_param_specs(),
                                                      ep),
                                           shard_tree(xe, P("ep"), ep))
    out["moe"] = (gather_tree(oe, P("ep"), ep), (mo, xe))
    return out


def _par_modes_ref(out) -> dict:
    """Each mode's one-device run against its gathered output: {mode:
    (rel err, tol)}. The MLP step (loss and params) and the pipeline
    through B1, the MHA through B7 at all heads, held at TOL_MODEL (a
    module of bf16 roundings against its kernels-on one-device run or
    kernels-off oracle); ring attention (f32 math on bf16 inputs) at
    TOL_BF16, the f32 MoE at TOL_F32."""
    from tpp_mlir_tpu_torch.parallel import (make_mha_forward,
                                             make_train_step,
                                             moe_reference,
                                             pipeline_reference,
                                             ring_attention_reference)
    (loss, new), (mlp, x, y) = out["mlp"]
    want, wloss = make_train_step(TRAIN_LAYERS, 0.05)(mlp, x, y)
    mlp_err = max([abs(loss.item() - wloss.item()) / abs(wloss.item())]
                  + [rel_err(a, b)[0] for ab, wb in zip(new, want)
                     for a, b in zip(ab, wb)])
    E, H = GPT2_SERVE["embed"], GPT2_SERVE["heads"]
    om, (mp, xm) = out["mha"]
    po, (pparams, xs) = out["pipeline"]
    ro, (q, k, v) = out["ring"]
    oe, (mo, xe) = out["moe"]
    return {"mlp": (mlp_err, TOL_MODEL),
            "mha": (rel_err(om, make_mha_forward(None, E, H)(mp, xm))[0],
                    TOL_MODEL),
            "pipeline": (rel_err(po, pipeline_reference(pparams, xs))[0],
                         TOL_MODEL),
            "ring": (rel_err(ro, ring_attention_reference(q, k, v, True))[0],
                     TOL_BF16),
            "moe": (rel_err(oe, moe_reference(mo, xe))[0], TOL_F32)}


def _tp_local(key, deg: int) -> bool:
    """Whether a key is one only the degree-`deg` path launches: attention
    (B7, B14, B18) at heads/deg, decode attention at kv heads/deg, B1 at
    the MLP's WIDTH/deg columns or rows."""
    from tpp_mlir_tpu_torch.xsmm import (BrgemmKey, DecodeAttnKey,
                                         FlashMhaKey, FlashTrainBwdKey,
                                         FlashTrainKey)
    heads = GPT2_SERVE["heads"] // deg
    if isinstance(key, (FlashMhaKey, FlashTrainKey, FlashTrainBwdKey,
                        DecodeAttnKey)):
        return key.heads == heads
    return isinstance(key, BrgemmKey) and WIDTH // deg in (key.n, key.k)


# the kernel inputs of each kind the parallel path launches, made from a key
_PAR_INPUTS = {"brgemm": _brgemm_inputs, "attention": _attention_inputs,
               "decode_attn": _decode_attn_inputs,
               "flash_train_fwd": _flash_fwd_timing_inputs,
               "flash_train_bwd": _flash_bwd_timing_inputs}


def _par_tols(kind, key, n: int) -> list:
    """The tolerance of each of a key's n outputs, as phase 3 holds them:
    B14/B18 at 2e-2 in bf16 (1e-4 in f32) and B14's lse2 at TOL_LSE, the
    others by `_tol`."""
    if kind in ("flash_train_fwd", "flash_train_bwd"):
        tol = TOL_F32 if key.dtype == "f32" else 2 * TOL_BF16
        return [tol, TOL_LSE][:n] if kind == "flash_train_fwd" else [tol] * n
    return [_tol(key)] * n


def _par_kernel_checks(keys, g) -> list:
    """Each launched key of the parallel path against its plain version
    on the same inputs: [(kind, key, rel, abs)] (the worst output); a
    failure raises."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    out = []
    for kind, key in keys:
        args = _PAR_INPUTS[kind](key, g)
        got, want = build_kernel(key)(*args), reference_kernel(key)(*args)
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in pairs]
        tols = _par_tols(kind, key, len(pairs))
        if not all(e[0] <= t and torch_isfinite(a) for e, t, (a, _) in
                   zip(errs, tols, pairs)):
            raise AssertionError(f"{key}: rel {[e[0] for e in errs]} "
                                 f"tol {tols}")
        out.append((kind, key, max(e[0] for e in errs),
                    max(e[1] for e in errs)))
    return out


def _par_run(deg: int, graph: bool, lines: list) -> tuple[dict, list]:
    """Every mode over this world's `deg` ranks, the counted part first
    (the launch counts set to 0 before it, read after it), then each held
    against its one-device run (rank 0) and each launched kernel key
    against its plain version (every rank). Returns (launches by kind,
    [(kind, key, launches, rel, abs)]), appending the report to `lines`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpp_mlir_tpu_torch.serving import GptConfig, init_params
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    rank, where = dist.get_rank(), f"{dist.get_backend()} x{deg}"
    meshes = _par_meshes(deg)
    dtypes = ("bf16",) if deg == 1 else ("f32", "bf16")
    serve = {}
    for dt in dtypes:
        cfg = GptConfig(**dict(GPT2_SERVE, dtype=dt))
        ids = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(
                np.int32)).cuda()
        serve[dt] = (cfg, init_params(cfg, seed=0, device="cuda"), ids)
    tcfg = GptConfig(**GPT2_TRAIN)
    tparams = init_params(tcfg, seed=0, device="cuda")
    tids = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)).cuda()
    g = torch.Generator(device="cuda").manual_seed(11)
    torch.cuda.synchronize()
    cache.reset_launches()
    t0 = time.perf_counter()
    decoded = {dt: _par_decode(*serve[dt], meshes["tp"], False)
               for dt in dtypes}
    trained = _par_train(tcfg, tparams, tids, meshes["tp"])
    modes = _par_modes(meshes, g)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = _launches(cache)
    keys = sorted({(_kind(fn.key), fn.key): fn.launches
                   for fn in cache.kernels() if fn.launches and
                   _kind(fn.key) in _PAR_INPUTS}.items(), key=repr)
    lines.append(f"parallel {where} rank {rank}: the path ran in "
                 f"{path_s:.1f} s; launches {dict((k, v) for k, v in launches.items() if v)}")
    # the second witness of the tp step's grads, outside the counted run:
    # the same step in f32, where no leaf loses its low bits to bf16
    # rounding, so each leaf is held alone at the sum-order tolerance
    fcfg = GptConfig(**dict(GPT2_TRAIN, dtype="f32"))
    fparams = init_params(fcfg, seed=0, device="cuda")
    trained_f32 = _par_train(fcfg, fparams, tids, meshes["tp"])
    ok = True
    if graph:
        # the decode replayed from a CUDA graph (NCCL can be captured):
        # the same tokens as the eager run
        # the same steps fed the eager run's tokens: each step's logits
        # bit-equal, so the greedy tokens are the eager run's
        cfg, params, ids = serve["bf16"]
        _, etoks, elgs, ems = decoded["bf16"]
        _, gtoks, glgs, gms = _par_decode(cfg, params, ids, meshes["tp"],
                                          True, force=etoks)
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(glgs, elgs)]
        same = torch.equal(gtoks, etoks) and max(diffs) == 0.0
        ok = ok and same
        lines.append(f"parallel {where}: tp decode b{SERVE_BATCH} "
                     f"{PAR_DECODE_STEPS} steps replayed from a CUDA graph "
                     f"{gms:.4f} ms a step (eager {ems:.4f}; host clock), "
                     f"fed the eager tokens: logits bit-equal {same} (max "
                     f"|graph - eager| per step "
                     f"{' '.join(f'{d:.3g}' for d in diffs)})")
    if rank == 0:
        for dt in dtypes:
            cfg, params, _ = serve[dt]
            pcache, toks, lgs, ms = decoded[dt]
            err, same = _par_decode_ref(cfg, params, pcache, toks, lgs)
            tol = TOL_F32 if dt == "f32" else TOL_MODEL
            good = err <= tol and (same or dt == "bf16")
            ok = ok and good
            lines.append(
                f"parallel {where}: tp decode gpt2 small {dt} b{SERVE_BATCH}"
                f" prompt {SERVE_PROMPT}, {PAR_DECODE_STEPS} steps (eager, "
                f"{ms:.4f} ms a step, host clock): logits vs one device "
                f"teacher-forced rel {err:.3e} (tol "
                f"{tol:.0e}); greedy tokens equal {same} "
                f"{'ok' if good else 'FAIL'}")
        loss0, grads, losses, step_ms = trained
        dl, gerr, lerr, leaf = _par_train_ref(tcfg, tparams, tids, loss0,
                                              grads)
        good = dl <= TOL_BF16 and gerr <= TOL_GRAD and \
            lerr <= TOL_GRAD_LEAF and losses[1] < losses[0]
        ok = ok and good
        lines.append(
            f"parallel {where}: train gpt2 small b{TRAIN_B} s{TRAIN_S} bf16 "
            f"zero1 vocab_parallel: losses {losses}, second step "
            f"{step_ms:.1f} ms (host clock); step-0 loss vs one "
            f"device |diff| {dl:.3e} (tol {TOL_BF16:.0e}), grads rel "
            f"Frobenius jointly {gerr:.3e} (tol {TOL_GRAD:.0e}), worst leaf"
            f" {leaf} {lerr:.3e} (tol {TOL_GRAD_LEAF:.0e}) "
            f"{'ok' if good else 'FAIL'}")
        loss0, grads, losses, step_ms = trained_f32
        dl, gerr, lerr, leaf = _par_train_ref(fcfg, fparams, tids, loss0,
                                              grads)
        good = dl <= TOL_F32 and lerr <= TOL_F32 and losses[1] < losses[0]
        ok = ok and good
        lines.append(
            f"parallel {where}: train gpt2 small b{TRAIN_B} s{TRAIN_S} f32 "
            f"zero1 vocab_parallel: losses {losses}, second step "
            f"{step_ms:.1f} ms (host clock); step-0 loss vs one device "
            f"|diff| {dl:.3e} (tol {TOL_F32:.0e}), grads leaf by leaf: "
            f"worst {leaf} rel {lerr:.3e} (tol {TOL_F32:.0e}), jointly "
            f"{gerr:.3e} {'ok' if good else 'FAIL'}")
        for mode, (err, tol) in _par_modes_ref(modes).items():
            good = err <= tol
            ok = ok and good
            lines.append(f"parallel {where}: {mode} vs one device rel "
                         f"{err:.3e} (tol {tol:.0e}) "
                         f"{'ok' if good else 'FAIL'}")
    checks = _par_kernel_checks([k for k, _ in keys], g)
    counts = dict(keys)
    rows = []
    for kind, key, rel, ab in checks:
        rows.append((kind, key, counts[(kind, key)], rel, ab))
        lines.append(f"parallel {where} rank {rank}: kernel {kind} at "
                     f"{key} vs plain rel {rel:.3e} abs {ab:.3e} (tol "
                     f"{_par_tols(kind, key, 1)[0]:.0e}), "
                     f"{counts[(kind, key)]} launches")
    if not ok:
        raise AssertionError("\n".join(lines))
    return launches, rows


def _parallel_rank(rank, world, device, _):
    """A rank of the gloo world of two on the one card."""
    lines = [f"parallel gloo x{world} rank {rank} on {device} "
             f"(collectives on CUDA tensors staged through pinned host "
             f"memory: a gloo group)"]
    launches, rows = _par_run(world, False, lines)
    return lines, launches, rows


def phase_parallel() -> tuple[dict, list]:
    """The parallel layer in two worlds. A world of one over NCCL in this
    process at full width: the GPT-2 small bf16 tp decode (b8, 16 steps,
    eager, then replayed from a CUDA graph: the same tokens), its AdamW
    train step with zero1 and vocab_parallel (B 8 x S 512), the MLP step,
    the tp MHA, the pipeline, ring attention and MoE, every mode at degree
    1. Then a world of two ranks on the one card over gloo (NCCL refuses
    two ranks on one device): the decode at tp 2 in f32 (token-equal to the
    one-device decode) and bf16, eagerly (a gloo collective is not
    captured), the train step, MLP step and MHA at tp 2, the pipeline at
    P 2, ring attention at sp 2, MoE at ep 2, each against its one-device
    run; each rank holds every kernel key it launched against its plain
    version. Returns the launches of both worlds by kind and the
    tp-local keys' rows."""
    import torch
    import torch.distributed as dist

    from tpp_mlir_tpu_torch.parallel import World
    from tpp_mlir_tpu_torch.parallel.mesh import _free_port
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    lines = [f"parallel: world 1: backend {dist.get_backend()}, "
             f"{dist.get_world_size()} rank, cuda:"
             f"{torch.cuda.current_device()}"]
    try:
        launches, _ = _par_run(1, True, lines)
    finally:
        dist.destroy_process_group()
        for line in lines:
            say(line)
    t1 = time.perf_counter()
    say(f"parallel: world 1 {t1 - t0:.1f} s; world 2: backend gloo, 2 "
        f"ranks on cuda:0")
    torch.cuda.empty_cache()
    ranks = World(_parallel_rank, 2, "gloo", "cuda", (None,)).result()
    rows = {}
    for lines2, counts, got in ranks:
        for line in lines2:
            say(line)
        for kind, n in counts.items():
            launches[kind] = launches.get(kind, 0) + n
        for kind, key, n, rel, ab in got:
            if not _tp_local(key, 2):
                continue
            row = rows.setdefault((kind, key), [0, 0.0])
            row[0] += n
            row[1] = max(row[1], ab)
    say(f"parallel: world 2 {time.perf_counter() - t1:.1f} s; tp-local "
        f"keys {len(rows)}")
    return launches, [(kind, key, n, ab)
                      for (kind, key), (n, ab) in rows.items()]


def phase_parallel_timing(rows) -> list:
    """Each tp-local key of the gloo world's path timed as phase 5 times
    its kind's row (decode attention from a CUDA graph walking the stacked
    layers; the others by CUDA events), beside its plain version, the one
    PyTorch call computing the same function and its bound: kernel-line
    entries."""
    import torch

    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    g = torch.Generator(device="cuda").manual_seed(12)
    out = []
    for kind, key, launches, ab in rows:
        args = _PAR_INPUTS[kind](key, g)
        kern, plain = build_kernel(key), reference_kernel(key)
        library = _library_call(kind, key, args)
        bound, by = _bound(kind, key, args)
        if kind == "decode_attn":
            layer = _decode_library(key, args)
            walk = [_walk(lambda li: kern(*args[:4], li, *args[5:]), key),
                    _walk(lambda li: plain(*args[:4], li, *args[5:]), key),
                    _walk(layer, key) if layer else None]
            ms, plain_ms, lib_ms = (graph_ms(f, iters=2 * key.stacked)
                                    if f else None for f in walk)
            note = " (replayed from a CUDA graph walking the layers)"
        else:
            ms, plain_ms = cuda_ms(lambda: kern(*args)), \
                cuda_ms(lambda: plain(*args))
            lib_ms = cuda_ms(library) if library else None
            # a kernel of tens of us over eager launches reads the host's
            # time a call: its device time, from a graph, beside it
            note = f" (replayed from a CUDA graph " \
                f"{graph_ms(lambda: kern(*args)):.4f} ms)"
        lib = f"{lib_ms:.4f} ms" if lib_ms else "none"
        say(f"time kernel tp-local {describe(key):44s} {ms:.4f} ms, plain "
            f"version {plain_ms:.4f} ms, library call {lib}, bound "
            f"{bound:.4f} ms ({by}); {launches} launches in the gloo world"
            f"{note}")
        out.append((kind, key, {"launches": launches, "max_abs_err": ab,
                                "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound, "bound_by": by,
                                "library_ms": lib_ms}))
    return out



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
    stats.update(phase_ln_stats_kernels())
    for kind, st in phase_warm_kernels().items():
        if kind == "blocked_matmul_warm":
            continue    # its line takes phase 5's, at the key it times
        worst = max(st["max_abs_err"], stats.get(kind, {}).get(
            "max_abs_err", 0.0))
        stats[kind] = {"max_abs_err": worst}
    launches = phase_main_path()
    for kind, n in phase_tuning().items():
        launches[kind] += n
    for kind, n in phase_compiler_path().items():
        launches[kind] += n
    for kind, n in phase_transformer_path().items():
        launches[kind] += n
    serve_launches, setups = phase_serving_path()
    moe_launches, moe_setup = phase_moe_serving()
    for counts in (serve_launches, phase_serving_flash(setups[0]),
                   phase_serving_modes(setups[0]), moe_launches,
                   phase_mlp_training(), phase_gpt_training(),
                   phase_moe_training(), phase_mha_suite(),
                   phase_conv_suite(), phase_packed_suite(),
                   phase_ln_stats_path(), phase_int4_serving(),
                   phase_lora()):
        for kind, n in counts.items():
            launches[kind] += n
    par_launches, par_rows = phase_parallel()
    for kind, n in par_launches.items():
        launches[kind] += n
    timing = phase_timing()
    timing.update(phase_ln_stats_timing())
    phase_serving_timing(setups)
    phase_moe_serving_timing(moe_setup)
    kernels = []
    for kind, replaces in (
            ("brgemm", "kernels.py:580"),
            ("chain", "kernels.py:1475"),
            ("attention", "kernels.py:2232"),
            ("layer_norm", "kernels.py:3257"),
            ("decode_attn", "decode_attn.py:101"),
            ("int8_gemm", "kernels.py:1365"),
            # bf16 (the main path's) on attention.cu's training mode; f32
            # on flash_train.cu's f32-FMA forward
            ("flash_train_fwd", "flash_train.py:146"),
            ("flash_train_bwd", "flash_train.py:190"),
            ("grouped_gemm", "kernels.py:1138"),
            ("grouped_wgrad", "kernels.py:1283"),
            # one kernel for the five flat TPU kernels (B6, B8, B9, B10a,
            # B10b: :1660, :2395, :2721, :2496, :2618)
            ("attention_flat", "kernels.py:1660"),
            ("attention_bench", "kernels.py:2091"),
            ("batch_matmul", "kernels.py:963"),
            ("chain_pingpong", "kernels.py:1919"),
            # one kernel for B24 (window) and B25 (fullrow, :3117)
            ("conv_nhwc", "kernels.py:2919"),
            ("blocked_matmul", "kernels.py:763"),
            ("blocked_matmul_warm", "kernels.py:870"),
            # B24's kernel in the channel-blocked layout
            ("conv_blocked", "kernels.py:2778"),
            # B2's LN-stats producer/consumer pair (the line's times: the
            # two launches, at the bf16 GPT-2 fc key)
            ("brgemm_ln_stats", "kernels.py:243")):
        also = {"attention_flat": [":2395", ":2496", ":2618", ":2721"],
                "batch_matmul": [":1065"], "conv_nhwc": [":3117"]}.get(kind)
        kernels.append({"name": kind, "route": "cuda",
                        "source": _source(kind),
                        "replaces": f"tpp_mlir_tpu/xsmm/{replaces}",
                        **({"also_replaces": [f"tpp_mlir_tpu/xsmm/kernels.py"
                                              f"{x}" for x in also]}
                           if also else {}),
                        "launches": launches[kind],
                        # phase 3's worst case; packed parity mode's
                        # kinds take phase 5's at the line's key
                        "max_abs_err": stats[kind]["max_abs_err"],
                        **timing[kind]})
    # the parallel path's tp-local keys (ROADMAP A11), each a row of its
    # kernel's source
    from tpp_mlir_tpu_torch.tools.trace import describe
    rows = {k["name"]: k for k in kernels}
    for kind, key, entry in phase_parallel_timing(par_rows):
        dx = " transpose_b" if getattr(key, "transpose_b", False) else ""
        kernels.append({**{f: rows[kind][f] for f in ("route", "source",
                                                      "replaces")},
                        "name": f"{kind}@{describe(key)}{dx}", **entry})
    say(f"total: {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
