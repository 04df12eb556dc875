#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpp_mlir_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py fusion_parity   # the build, then phase_<name>s

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
     its two transpose_b dgrads (9216 padded rows), bm 16 and bm 8 keys
     (the WMMA tile; bm 8 in bf16, f32 "default" and "highest"), a stacked
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
f16 keys (ROADMAP A14, `phase_f16`, after phase 4a): (a) B1 (the fc
256x1024x1024 +bias+relu with an f32 and an f16 output, a ragged n on the
convert loader, transpose_b), B3 (the flagship cut to two layers), B4 at
20 repeats, B5 at fc 128x768x2304, B19 (the packed fc, VNNI2 and flat) and
B20 at 20 repeats, He-scaled, against their plain versions (2e-3 a GEMM,
5e-3 a chain); (b) on every route an f16 key takes (B1 tma, convert and
transpose_b; B19 tma and VNNI2 convert; B3, B4, B5, B20 on the warm-panel
engine; B3 and B20 on the first design's WMMA body) A = 1 + 2^-10, K 1024,
an f32 output, bit-equal to the plain version's exact sums (bf16 products
would read A as 1.0); (c) tpp-gen --float-type=f16's two-layer flagship
(B3), fc (B1) and --tiles VNNI2 packed MLP (B19) against
--linalg-to-loops at 1e-2, finite, then the flagship, the packed fc and
fc_128x768x2304 at -n 100 (B4, B20, B5 in the kernel), the launches of
this path counted; the flagship from a CUDA graph of 100 forwards beside
torch.matmul + bias + ReLU in f16; each f16 key the path launched timed
and appended to the kernel line as `kind@key`.
The transformer family's f16 keys (ROADMAP A14 items 1, 2, 3 and 5,
`phase_f16_transformer`, after `phase_f16`): (a) B2's LayerNorm-prologue
GEMMs of GPT-2 and the encoder (one on the convert loader), B12 at GPT-2's
ln_f (its first design forced too), B7 at GPT-2's and the encoder's packed
keys (f16 has the TMA loader only), the flat kernel at the MHA
suite's S 2048 keys under every strategy (B6, B8, B9, B10a, B10b) and B11,
B21/B22 at mha_qk's and mha_softmax_v's keys and the tiled route, and B2's
LN-stats pair at GPT-2's fc width, each against its plain version at 2e-3;
(b) the A = 1 + 2^-10 probes of every route they take (B2 kLnSmem/kLnLoad
and the pair; B12 register and strided; B21/B22 multi and tiled),
bit-equal; attention's TMA loader, flat, token and B11, on a probe whose
output moves if Q or P is rounded to bf16, held within 2e-4 of its plain
version; (c) GPT-2 small
(gpt2_small_s1024_bf16's widths, 12 layers) and the encoder block
(transformer_block_d128's) in f16, and the MHA suite's mha_qk,
mha_softmax_v and flash_attention S 2048 rows in f16 (-n 20: B11 in the
kernel, and the loop under bench_mode scan) through run_entry, against
--linalg-to-loops at TOL_MODEL, finite, with the bf16 rows' op counts,
each path's launches counted; (d) each f16 key the paths launched held
against its plain version and timed beside its bound, SDPA,
F.layer_norm or torch.bmm in f16 where one call computes it (B2: the
composed F.layer_norm -> addmm, marked composed): kernel-line rows;
every other key of (a) and the f16 LN-stats pair timed the same way (no
kernel-line row).
The conv family's f16 keys with the grouped and int8 GEMMs' (ROADMAP A14
items 4, 6 and 7, `phase_f16_conv`, after `phase_f16_transformer`): (a)
conv.cu (B24/B25) at the f16 twins' NHWC and NCHW keys on its tma route
and the forced wmma tile, a ragged-channel key (the wmma tile), B23 at Cb
1 and 2, B16 at the MoE shapes (fc1 + gelu to f16 and to f32, fc2; 8
experts, bm 128, 9,216 rows) and at bm 16 (the WMMA tile), B17's dw1, dw2
and a skewed routing, B15 at the int8 prefill's QKV + bias, fc1 + gelu,
fc2 and LM-head shapes with an f16 output, each against its plain
version at 2e-3; (b) the f16-not-bf16 probe on every new route (conv tma
and wmma, B23, B16 and B17 wgmma and wmma: A = 1 + 2^-10; B15's stores:
an s32 sum of 1025 times 2^-10, 1 + 2^-10 in f16 and 1 in bf16),
bit-equal; (c) conv.json's and vit.json's rows in f16 (each named by the
row it twins: NCHW flat and packed on B23, NHWC, the c256/16 and 1x1
c256/14 keys, the two-layer c128/30, both ResNet blocks, both ViTs) and
the conv-BN-pool stack at N 8, C 128, 32x32 in f16, lowered, against
--linalg-to-loops at TOL_MODEL, finite, f16, their launches counted
(conv_nhwc and conv_blocked must move); (d) each f16 key those paths
launched held against its plain version and timed beside its bf16
twin, its bound and F.conv2d (or SDPA, F.layer_norm, torch.addmm) in
f16: kernel-line rows; every other key of (a) timed the same way (B16/B17
beside torch._grouped_mm or a per-group torch.mm loop, marked composed;
B15 beside the composed torch._int_mm chain), no kernel-line row.
The attention kernels' f16 keys (ROADMAP A14 item 8,
`phase_f16_attention`, after `phase_f16_conv`): (a) B13 (decode_attn.cu
on an f16 KV cache: GPT-2 small's b8 h12 s1024 d64 stacked 12-layer
decode at pos 639, slotted, LLaMA's GQA kv4 g3, f16 q over an int8 cache,
pack2, the tp-local kv6 key; d32 and d128 off the path) at 1e-4, and B14
(attention.cu's training mode at f16 products) and B18 (flash_train.cu's
wgmma passes at f16 products) at GPT-2 small's training key b8 s512 h12
d64 causal, d32, d128, non-causal and ragged keys off it, at 2e-2 (their
bf16 keys' tolerance: P and dS rounded to bf16, O and the grads bf16);
B18 bit-repeatable and fed B14's own lse2; max|dS| printed against f16's
65,504; (b) two probes a kernel: operands 1 + 2^-10 (exact in f16, 1 in
bf16) whose rounding to bf16 moves the output, and logits where P's bf16
and f16 roundings part, each kernel within ATTN_PROBE_LIMIT of its plain
version and every rounded reading more than twice that from it; (c) the
path: every count set to 0, each path key dispatched through the kernel
cache as the decode and training steps call it (the decode keys walking
the 12 layers, B14 then B18 on its outputs), every f16 kernel launched;
(d) each path key timed beside its bf16 twin from CUDA graphs in turns,
its plain version, its bound and SDPA in f16 (B13 on the live rows,
walking the layers; B14 its forward; B18 SDPA's backward op from a
graph): kernel-line rows; the keys off the path timed the same way, no
kernel-line row.
The parity phases (ROADMAP queue A), last: `phase_dispatch_api` (the
libxsmm-shaped gemm/brgemm/fused_brgemm dispatch functions, and the cache's
dispatch of a packed B19 key, a UnaryKey and a BinaryKey, against their
plain versions), `phase_fusion_parity` (the JAX transformer-fusion and
returned-value programs through default-tpp-passes against
--linalg-to-loops) and `phase_serving_fuzz` (the serving fuzzer's ten
architectures at GPT-2 small's widths, every path against the greedy
oracle, with the seeded top-1 combine bug caught); their programs and
harness are tests/torch_parity_cases.py, shared with the CPU tests.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Given phase names, the script runs the
device and build phases and then those phases alone, and prints neither.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import re
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
PEAK = {"bf16": 989e12, "f16": 989e12, "f32": 67e12, "int8": 1979e12}
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
    if info.sources:    # when each source's nvcc ended, the slowest first
        say("build: " + ", ".join(
            f"{name} {end:.1f} s" for name, end in sorted(
                info.sources.items(), key=lambda kv: -kv[1])))
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
    for mxu, code in ((torch.bfloat16, 1), (torch.float32, 0),
                      (torch.float16, 2)):
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
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}[key.dtype]
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
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}[key.dtype]
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
    kernel) and for xsmm.unary/xsmm.binary's keys (PyTorch ops)."""
    kind = KINDS.get(type(key).__name__)
    if kind is None:
        return None
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


# ROADMAP A14: f16 keys on the GEMM family (B1, B3-B5, B19, B20). The
# flagship keeps its width (1024) and batch (256) and is cut to two layers:
# under tpp-gen's normal init the activations' standard deviation grows
# about sqrt(K / 2) = 22.6x a ReLU layer (~32, then ~724, then ~1.6e4), so
# the tail of a third layer's 256 x 1024 outputs passes f16's 65,504 and
# turns inf in both packages.
F16_FLAGSHIP = "--batch=256 --layers=1024,1024,1024 --bias --relu " \
    "--float-type=f16"
F16_FC = "--batch=256 --layers=1024,1024 --bias --relu --float-type=f16"
F16_PACKED = "--batch=256 --layers=1024,1024,1024 --tiles=256,512,512 " \
    "--bias --relu --vnni=2 --float-type=f16"
F16_PACKED_FC = "--batch=256 --layers=1024,1024 --tiles=256,512,512 " \
    "--bias --relu --vnni=2 --float-type=f16"
F16_PINGPONG = "--batch=128 --layers=768,2304 --bias --relu --float-type=f16"
F16_N = 100         # -n of the in-kernel benches (B4, B5, B20)
TOL_F16 = 2e-3      # one GEMM: tests/xsmm/test_kernels.py:677's f16 rtol
TOL_F16_CHAIN = 5e-3    # a chain: f16 roundings between layers add up
F16_ONE = 1 + 2 ** -10  # exact in f16; 1.0 in bf16
# attention's probe: the most its output may differ from the plain
# version's (B7's plain version normalizes P before rounding it, 7.2e-5
# from the kernel's order on the probe), under half what a Q or a P rounded
# to bf16 moves it by (at least 9.6e-4 on the probe's keys)
ATTN_PROBE_LIMIT = 2e-4
F16_KINDS = ("brgemm", "chain", "chain_pingpong", "blocked_matmul",
             "blocked_matmul_warm")
F16_CHAINS = ("chain", "chain_pingpong", "blocked_matmul_warm")


def _f16_inputs(key, g):
    """Inputs of an f16 key on the card: activations N(0, 1), weights
    He-scaled N(0, 2/K), so that a ReLU layer keeps the state's scale and
    the repeats of B4 and B20 stay inside f16's range; B5's one weight W
    Gaussian over its spectral norm: a round trip h -> ReLU(h W + b) W^T
    cannot grow the state then, where any entrywise scale that keeps a
    random h's scale grows the state about 3x a round trip along W W^T's
    top eigenvector (Marchenko-Pastur: up to (1 + sqrt(k/n))^2 over the
    mean), inf before 100 repeats; biases N(0, 0.1^2), a C N(0, 1); B20's
    bias f32 (its launch takes f32)."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import BrgemmKey, ChainKey
    f16 = torch.float16

    def rnd(*shape, scale=1.0, dt=f16):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dt)
    if isinstance(key, BrgemmKey):
        he = (2 / (key.batch * key.k)) ** 0.5
        b = (key.batch, key.n, key.k) if key.transpose_b else \
            (key.batch, key.k, key.n)
        return (rnd(key.batch, key.m, key.k), rnd(*b, scale=he),
                None if key.beta0 else rnd(key.m, key.n),
                rnd(key.n, scale=0.1) if key.binary_kind else None)
    if isinstance(key, ChainKey):
        wb = []
        for k, n in zip(key.dims[:-1], key.dims[1:]):
            if key.pingpong:
                w = rnd(k, n, dt=torch.float32)
                wb.append((w / torch.linalg.matrix_norm(w, ord=2)).to(f16))
            else:
                wb.append(rnd(k, n, scale=(2 / k) ** 0.5))
            if key.has_bias:
                wb.append(rnd(n, scale=0.1))
        return (rnd(key.m, key.dims[0]), *wb)
    K = key.Kb * key.kb
    b = rnd(key.Nb, key.Kb, key.kb, key.nb, scale=(2 / K) ** 0.5)
    if key.vnni:
        b = b.reshape(key.Nb, key.Kb, key.kb // 2, 2, key.nb) \
            .movedim(-2, -1).contiguous()
    d = rnd(key.Nb, key.nb, scale=0.1,
            dt=torch.float32 if key.repeats else f16) \
        if key.binary_kind else None
    return (rnd(key.Mb, key.Kb, key.mb, key.kb), b,
            None if key.beta0 else rnd(key.Mb, key.Nb, key.mb, key.nb), d)


def _f16_kernel_cases():
    """(a): (label, key, tolerance) at the f16 main path's shapes."""
    from tpp_mlir_tpu_torch.xsmm import BlockedMatmulKey, BrgemmKey, ChainKey
    fc = dict(beta0=True, binary_kind="add", unary_kind="relu")
    flagship = (WIDTH,) * 3
    packed = dict(vnni=2, **fc)
    return (
        ("B1 fc 256x1024x1024 f16 +bias+relu, f32 out",
         BrgemmKey(1, BATCH, WIDTH, WIDTH, "f16", out_dtype="f32", **fc),
         TOL_F16),
        ("B1 fc 256x1024x1024 f16 +bias+relu, f16 out",
         BrgemmKey(1, BATCH, WIDTH, WIDTH, "f16", **fc), TOL_F16),
        ("B1 fc 256x1004x1024 f16 +C (convert)",
         BrgemmKey(1, BATCH, 1004, WIDTH, "f16"), TOL_F16),
        ("B1 fc 128x2304x768 f16 +bias+relu (fc_128x768x2304)",
         BrgemmKey(1, 128, 2304, 768, "f16", **fc), TOL_F16),
        ("B1 dx 256x1024x1024 f16 transpose_b",
         BrgemmKey(1, BATCH, WIDTH, WIDTH, "f16", beta0=True,
                   transpose_b=True), TOL_F16),
        ("B3 flagship 256 x 1024x3 f16",
         ChainKey(m=BATCH, dims=flagship, dtype="f16"), TOL_F16_CHAIN),
        ("B4 flagship 256 x 1024x3 f16 r20",
         ChainKey(m=BATCH, dims=flagship, dtype="f16", repeats=20),
         TOL_F16_CHAIN),
        ("B5 fc_128x768x2304 f16 r3",
         ChainKey(m=128, dims=(768, 2304), dtype="f16", repeats=3,
                  pingpong=True, unary_kind=None), TOL_F16_CHAIN),
        ("B19 packed fc f16 VNNI2",
         BlockedMatmulKey(1, 2, 2, BATCH, 512, 512, "f16", **packed),
         TOL_F16),
        ("B19 packed fc f16 flat B (tma)",
         BlockedMatmulKey(1, 2, 2, BATCH, 512, 512, "f16", **fc), TOL_F16),
        ("B20 packed fc f16 VNNI2 r20",
         BlockedMatmulKey(1, 2, 2, BATCH, 512, 512, "f16", repeats=20,
                          **packed), TOL_F16_CHAIN))


def f16_route_probes():
    """(b): (label, key, forced body or loader, or None) for every route an
    f16 key takes: the GEMM family's (phase_f16), the transformer
    family's (phase_f16_transformer) and the conv family's with the grouped
    and int8 GEMMs' (phase_f16_conv)."""
    return _f16_gemm_probes() + _f16_transformer_probes() + \
        _f16_conv_probes()


def _f16_gemm_probes():
    """B1, B19, B3-B5 and B20's routes at K = 1024 and an f32 output."""
    from tpp_mlir_tpu_torch.xsmm import BlockedMatmulKey, BrgemmKey, ChainKey
    b1 = dict(out_dtype="f32", beta0=True)
    one = dict(dtype="f16", out_dtype="f32", has_bias=False,
               unary_kind=None, last_unary=None)
    b19 = dict(out_dtype="f32", beta0=True)
    return (
        ("B1 tma", BrgemmKey(1, 64, 64, WIDTH, "f16", **b1), None),
        ("B1 convert", BrgemmKey(1, 64, 36, WIDTH, "f16", **b1), None),
        ("B1 tma transpose_b", BrgemmKey(1, 64, 64, WIDTH, "f16",
                                         transpose_b=True, **b1), None),
        ("B19 tma", BlockedMatmulKey(1, 1, 2, 64, 64, 512, "f16", **b19),
         None),
        ("B19 convert VNNI2", BlockedMatmulKey(1, 1, 2, 64, 64, 512, "f16",
                                               vnni=2, **b19), None),
        ("B3 panel", ChainKey(m=64, dims=(WIDTH, 64), **one), None),
        ("B3 wmma", ChainKey(m=64, dims=(WIDTH, 64), **one), "wmma"),
        ("B4 panel", ChainKey(m=64, dims=(WIDTH, WIDTH), repeats=3, **one),
         None),
        ("B5 panel", ChainKey(m=64, dims=(WIDTH, WIDTH), repeats=3,
                              pingpong=True, **one), None),
        ("B20 panel", BlockedMatmulKey(1, 2, 2, 64, 512, 512, "f16",
                                       vnni=2, repeats=3, **b19), None),
        ("B20 wmma", BlockedMatmulKey(1, 2, 2, 64, 512, 512, "f16", vnni=2,
                                      repeats=3, **b19), "wmma"))


def _f16_transformer_probes():
    """ROADMAP A14 items 1, 2, 3 and 5: B2's and B21/B22's routes at K 1024
    (B21/B22: 64) and an f32 output, B12's with an f16 output, attention's
    at seq_kv 256."""
    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BrgemmKey,
                                         FlashMhaKey, LayerNormKey)
    from tpp_mlir_tpu_torch.xsmm.reference import LOG2E
    b1 = dict(out_dtype="f32", beta0=True)
    # B2: exact statistics (eps 0), gamma 1 and beta 2^-10 (probe inputs)
    ln = dict(out_dtype="f32", beta0=True, prologue_eps=0.0)
    # attention: scale * log2(e) = 32 (f16_probe)
    attn = dict(dtype="f16", out_dtype="f32", scale=32 / LOG2E)
    bmm = dict(dtype="f16", out_dtype="f32", beta0=True)
    return (
        ("B2 ln tma (kLnSmem)", BrgemmKey(1, 64, 64, WIDTH, "f16",
                                          prologue="layer_norm", **ln), None),
        ("B2 ln convert (kLnLoad)", BrgemmKey(1, 64, 64, WIDTH - 4, "f16",
                                              prologue="layer_norm", **ln),
         None),
        ("B2 ln_stats consumer", BrgemmKey(1, 64, 64, WIDTH, "f16",
                                           prologue="ln_stats", **ln), None),
        ("B2 ln_stats_out producer", BrgemmKey(1, 64, 64, WIDTH, "f16",
                                               ln_stats_out=True, **b1),
         None),
        ("B12 register", LayerNormKey(64, WIDTH, "f16", eps=0.0), None),
        ("B12 strided", LayerNormKey(64, WIDTH, "f16", eps=0.0),
         "strided"),
        ("attn flat tma", FlashMhaKey(4, 256, 256, 64, **attn), None),
        ("attn token packed tma", FlashMhaKey(
            2, 256, 256, 64, heads=2, qkv_packed=True, **attn), None),
        ("attn flat B11 r3 tma", FlashMhaKey(4, 256, 256, 64, repeats=3,
                                             **attn), None),
        ("bmm multi", BatchMatmulKey(64, 32, 32, 64, **bmm), None),
        ("bmm multi softmax_lhs", BatchMatmulKey(64, 32, 64, 64,
                                                 softmax_lhs=True, **bmm),
         None),
        ("bmm multi lhs_shared", BatchMatmulKey(64, 32, 32, 64,
                                                lhs_shared=True, **bmm),
         None),
        ("bmm tiled", BatchMatmulKey(8, 96, 64, 64, **bmm), None))


def _f16_conv_probes():
    """ROADMAP A14 items 4, 6 and 7: conv.cu's tma route and its wmma tile
    (forced), B23, B16's and B17's wgmma and wmma tiles, each at an f32
    output; B15's three stores of an f16 output (the epilogue
    warpgroup's 8-byte runs at split 1, the split pass, the first
    design's)."""
    from tpp_mlir_tpu_torch.xsmm import (ConvBrgemmKey, ConvNhwcKey,
                                         GroupedGemmKey, GroupedWgradKey,
                                         Int8GemmKey)
    conv = ConvNhwcKey(N=2, H=10, W=10, C=128, K=64, R=3, S=3, dtype="f16",
                       out_dtype="f32", beta0=True)
    b16 = dict(n_groups=2, m=128, n=128, k=WIDTH, dtype="f16",
               out_dtype="f32")
    b17 = GroupedWgradKey(n_groups=1, m=WIDTH, k=128, n=128, bm=64,
                          dtype="f16")
    return (
        ("conv tma", conv, None),
        ("conv wmma", conv, "wmma"),
        ("B23 tma Cb 2", ConvBrgemmKey(N=2, H=10, W=10, Cb=2, c=64, Kb=1,
                                       k=64, R=3, S=3, dtype="f16",
                                       out_dtype="f32", beta0=True), None),
        ("B16 wgmma", GroupedGemmKey(bm=64, **b16), None),
        ("B16 wmma bm 16", GroupedGemmKey(bm=16, **b16), None),
        ("B17 wgmma", b17, None),
        ("B17 wmma", b17, "wmma"),
        ("B15 wgmma store", Int8GemmKey(m=WIDTH, n=2304, k=1040,
                                        out_dtype="f16"), None),
        ("B15 wgmma split store", Int8GemmKey(m=64, n=128, k=1040,
                                              out_dtype="f16"), None),
        ("B15 wmma store", Int8GemmKey(m=64, n=128, k=1040,
                                       out_dtype="f16"), "wmma"))


def f16_probe_kernel(key, forced=None):
    """The Kernel of a probe: build_kernel's, or with `forced` the
    warm-panel engine's body (B3-B5, B20), B12's body, conv.cu's tile, B16's
    or B17's tile or B15's first design forced."""
    from tpp_mlir_tpu_torch.xsmm import (ConvBrgemmKey, ConvNhwcKey,
                                         GroupedGemmKey, GroupedWgradKey,
                                         Int8GemmKey, LayerNormKey,
                                         build_kernel)
    from tpp_mlir_tpu_torch.xsmm.kernels import (build_conv,
                                                 build_grouped_gemm,
                                                 build_int8,
                                                 build_layer_norm, build_warm)
    if not forced:
        return build_kernel(key)
    if isinstance(key, LayerNormKey):
        return build_layer_norm(key, forced)
    if isinstance(key, (ConvNhwcKey, ConvBrgemmKey)):
        return build_conv(key, forced)
    if isinstance(key, (GroupedGemmKey, GroupedWgradKey)):
        return build_grouped_gemm(key, forced)
    if isinstance(key, Int8GemmKey):
        return build_int8(key, forced)
    return build_warm(key, forced)


def f16_probe(key):
    """(b)'s inputs at `key` and what the output must be (a value every
    element holds, or a tensor). A = 1 + 2^-10 is exact in f16 and 1.0 in
    bf16. A single GEMM: B 1 (1024 (1 + 2^-10) = 1025); a repeat's weight
    2^-10 (the state stays 1 + 2^-10); bf16 products read 1024, or 1.
    B2's prologue: A's rows alternate +1 and -1 (mean 0, variance 1 with
    eps 0, or the producer's mu 0 and var 1), gamma 1 and beta 2^-10, so
    the normalized rows are 1 + 2^-10 and -(1 - 2^-10), exact in f16, +1
    and -1 in bf16; B 1: k 2^-10 (1 at K 1024), 0 in bf16. The
    ln_stats_out producer: B1's probe, and its rows' mean 1025 and var 0.
    B12: rows alternating 1 + 2^-10 and 1 - 2^-10 (eps 0: mean 1, rstd
    2^10), gamma 1, beta 2^-10: 1 + 2^-10 and -(1 - 2^-10), 2^-10 where
    the row was read in bf16. Attention: _attention_probe. B21/B22: A 1,
    B 1 + 2^-10: k (1 + 2^-10), or under softmax_lhs (P = 1/k) 1 +
    2^-10. The convs: I 1 + 2^-10, W 1, no padding: R S C (1 + 2^-10)
    (R S C in bf16). B16: A 1 + 2^-10, B 1: k (1 + 2^-10). B17: xt (the
    transpose of the (m, k) rows, as the MoE backward passes it) 1 +
    2^-10, dY 1, one group: m (1 + 2^-10). B15: Xq 1, Wq 1 in its first
    1025 rows and 0 below, xscale 2^-10, wscale 1: the s32 sum 1025 scaled
    to 1 + 2^-10, which an f16 store keeps and a bf16 one rounds to 1."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BrgemmKey,
                                         ChainKey, ConvBrgemmKey,
                                         ConvNhwcKey, FlashMhaKey,
                                         GroupedGemmKey, GroupedWgradKey,
                                         Int8GemmKey, LayerNormKey)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float16, device="cuda")
    if isinstance(key, ConvNhwcKey):
        return (full((key.N, key.H, key.W, key.C), F16_ONE),
                full((key.R, key.S, key.C, key.K), 1.0)), \
            key.R * key.S * key.C * F16_ONE
    if isinstance(key, ConvBrgemmKey):
        return (full((key.N, key.Cb, key.H, key.W, key.c), F16_ONE),
                full((key.Kb, key.Cb, key.R, key.S, key.c, key.k), 1.0)), \
            key.R * key.S * key.Cb * key.c * F16_ONE
    if isinstance(key, GroupedGemmKey):
        nb = key.m // key.bm
        ge = torch.arange(nb, dtype=torch.int32, device="cuda") * \
            key.n_groups // nb
        return (ge, full((key.m, key.k), F16_ONE),
                full((key.n_groups, key.k, key.n), 1.0)), key.k * F16_ONE
    if isinstance(key, GroupedWgradKey):
        ge = torch.zeros(key.m // key.bm, dtype=torch.int32, device="cuda")
        return (ge, full((key.m, key.k), F16_ONE).t(),
                full((key.m, key.n), 1.0)), key.m * F16_ONE
    if isinstance(key, Int8GemmKey):
        xq = torch.ones(key.m, key.k, dtype=torch.int8, device="cuda")
        wq = torch.zeros(key.k, key.n, dtype=torch.int8, device="cuda")
        wq[:1025] = 1
        xs = torch.full((key.m,), 2 ** -10, device="cuda")
        ws = torch.ones(key.n, device="cuda")
        return (xq, wq, xs, ws, None, wq.t().contiguous()), F16_ONE

    def alternating(rows, n, lo, hi):
        x = full((rows, n), hi)
        x[:, 1::2] = lo
        return x
    if isinstance(key, BrgemmKey) and key.prologue:
        a = alternating(key.m, key.k, -1.0, 1.0)[None]
        args = (a, full((1, key.k, key.n), 1.0), None, None,
                full((key.k,), 1.0), full((key.k,), 2 ** -10))
        if key.prologue == "ln_stats":
            zero = torch.zeros(key.m, 1, device="cuda")
            args += (zero, zero + 1.0)
        return args, key.k * 2 ** -10
    if isinstance(key, BrgemmKey) and key.ln_stats_out:
        a, b = full((1, key.m, key.k), F16_ONE), full((1, key.k, key.n), 1.0)
        want = key.k * F16_ONE
        stats = torch.full((key.m, 1), want, device="cuda")
        return (a, b), (full((key.m, key.n), want).float(), stats,
                        stats * 0)
    if isinstance(key, LayerNormKey):
        x = alternating(key.m, key.n, 1 - 2 ** -10, F16_ONE)
        want = alternating(key.m, key.n, -(1 - 2 ** -10), F16_ONE)
        return (x, full((key.n,), 1.0), full((key.n,), 2 ** -10)), want
    if isinstance(key, FlashMhaKey):
        return _attention_probe(key)
    if isinstance(key, BatchMatmulKey):
        a = full((key.m, key.k) if key.lhs_shared
                 else (key.batch, key.m, key.k), 1.0)
        return (a, full((key.batch, key.k, key.n), F16_ONE)), \
            F16_ONE if key.softmax_lhs else key.k * F16_ONE
    reps = getattr(key, "repeats", 0) > (1 if isinstance(key, ChainKey)
                                         else 0)
    w, want = (2 ** -10, F16_ONE) if reps else (1.0, WIDTH * F16_ONE)
    if isinstance(key, BrgemmKey):
        b = (1, key.n, key.k) if key.transpose_b else (1, key.k, key.n)
        return (full((1, key.m, key.k), F16_ONE), full(b, w)), want
    if isinstance(key, ChainKey):
        return (full((key.m, key.dims[0]), F16_ONE),
                full(key.dims, w)), want
    b = (key.Nb, key.Kb, key.kb // 2, key.nb, 2) if key.vnni else \
        (key.Nb, key.Kb, key.kb, key.nb)
    return (full((key.Mb, key.Kb, key.mb, key.kb), F16_ONE),
            full(b, w)), want


def _attention_probe(key):
    """Attention's probe, whose output depends on Q's and P's 2^-10 bit.
    Each head's Q rows are (1 + 2^-10, 1, 0, ...), K's first two rows e0
    and e1, V's (1 + 2^-10, 1, 0, ...) and (1 + 2^-10, 1, 1, ...), every
    other K and V row 0, and scale * log2(e) 32. In f16 the scaled Q is
    (32.03125, 32, 0, ...), the first two scores differ by 1/32, P is (1,
    2^(-1/32) = 0.97857) rounded to (1, 0.97852), and columns 2 on read
    0.97852 / 1.97857 = 0.49456. Q rounded to bf16 makes the two scores
    equal (0.5 there); P rounded to bf16 is 0.98047 (0.49554). B11 feeds
    the output back as Q: its first two columns round to (1 + 2^-10, 1)
    in f16, so every repeat reads the same, and to (1, 1) in bf16. Returns
    the inputs and the outputs a kernel that rounded Q (and B11's fed-back
    output) or P to bf16 would give (_attention_rounded)."""
    import torch
    H, D = key.heads or 1, key.head_dim
    B, S, Skv = key.batch, key.seq, key.seq_kv
    q = torch.zeros(B, S, H, D, dtype=torch.float16, device="cuda")
    k, v = (torch.zeros(B, Skv, H, D, dtype=torch.float16, device="cuda")
            for _ in range(2))
    q[..., 0], q[..., 1] = F16_ONE, 1.0
    k[:, 0, :, 0] = k[:, 1, :, 1] = 1.0
    v[:, :2, :, 0], v[:, :2, :, 1], v[:, 1, :, 2:] = F16_ONE, 1.0, 1.0
    q, k, v = (t.reshape(B, t.shape[1], H * D) for t in (q, k, v))
    args = (torch.cat((q, k, v), -1),) * 3 if key.qkv_packed else (q, k, v)
    bf16, f16 = torch.bfloat16, torch.float16
    return args, {"Q in bf16": _attention_rounded(key, args, bf16, f16),
                  "P in bf16": _attention_rounded(key, args, f16, bf16)}


def _attention_rounded(key, args, q_dt, p_dt):
    """attention.cu's math at `key` on `args`, in f64 on the host, with Q
    (and B11's fed-back output) rounded to q_dt and P to p_dt: the scores
    from the rounded and scaled Q, P = exp2(s - max) rounded, P V divided
    by the row sum of the unrounded P."""
    from tpp_mlir_tpu_torch.xsmm.reference import LOG2E
    H, D = key.heads or 1, key.head_dim
    E = H * D
    x = [a.cpu().double() for a in args]
    if key.qkv_packed:
        x = x[0][..., :E], x[0][..., E:2 * E], x[0][..., 2 * E:]

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, D).transpose(1, 2)

    def rnd(t, dt):
        return t.to(dt).double()
    h, k, v = (heads(t) for t in x)
    for _ in range(max(1, key.repeats)):
        s = rnd(rnd(h, q_dt) * (key.scale * LOG2E), q_dt) @ k.transpose(-1,
                                                                        -2)
        p = (s - s.amax(-1, keepdim=True)).exp2()
        h = rnd(p, p_dt) @ v / p.sum(-1, keepdim=True)
        if key.repeats:
            h = rnd(h, q_dt)
    return h.transpose(1, 2).reshape(x[0].shape[0], -1, E).float().to(
        args[0].device)


def f16_probe_holds(got, want, value) -> bool:
    """Whether a probe's output is bit-equal to its plain version's and
    holds the probe's value (a number every element holds, a tensor, or
    a tuple of tensors for the ln_stats_out producer's three results);
    attention's (value: the bf16-rounded readings) is within
    ATTN_PROBE_LIMIT of its plain version's, and each bf16-rounded reading
    more than twice that from it."""
    import torch
    if isinstance(value, dict):
        return rel_err(got, want)[1] <= ATTN_PROBE_LIMIT and \
            all(rel_err(r, want)[1] > 2 * ATTN_PROBE_LIMIT
                for r in value.values())
    if isinstance(got, tuple):
        return all(f16_probe_holds(g_, w_, v_)
                   for g_, w_, v_ in zip(got, want, value))
    if not torch.equal(got, want):
        return False
    if isinstance(value, torch.Tensor):
        return torch.equal(got, value.to(got.dtype))
    return bool((got == value).all())


def _f16_launches(cache) -> dict:
    """The launches of each f16 key of the cache since its last reset."""
    return {fn.key: fn.launches for fn in cache.kernels()
            if "f16" in (fn.key.dtype, getattr(fn.key, "out_dtype", None))
            and fn.launches}


def phase_f16() -> list:
    """ROADMAP A14 on the card: (a) B1, B3, B4, B5, B19 and B20 at f16 keys
    against their plain versions; (b) the f16-not-bf16 check on every
    route an f16 key takes; (c) the f16 main path through run_module (the
    two-layer flagship, B3, and its -n 100 bench, B4; the fc, B1; the
    packed MLP, B19, and the packed fc's -n 100 bench, B20; fc 128x768x2304's
    -n 100 bench, B5), held against --linalg-to-loops, its launches counted;
    the flagship timed from a CUDA graph beside torch.matmul + bias + ReLU
    in f16; then each f16 key the path launched held against its plain
    version at that key and timed beside it, its library call and its
    bound: kernel-line rows, each with its own key's error."""
    import torch

    from tpp_mlir_tpu_torch.runtime import compile as tpp_compile
    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.tools.tpp_run import init_args, run_module
    from tpp_mlir_tpu_torch.xsmm import (build_kernel, global_cache,
                                         reference_kernel)
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(22)
    # (a) each kernel at its f16 keys against its plain version
    for label, key, tol in _f16_kernel_cases():
        args = _f16_inputs(key, g)
        kern = build_kernel(key)
        got = kern(*args)
        want = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        ok = rel <= tol and torch_isfinite(got) and got.dtype == want.dtype
        say(f"f16 kernel {_kind(key):19s} {label:44s} rel {rel:.3e} abs "
            f"{ab:.3e} tol {tol:.0e}{_route_note(key)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {label}: rel {rel} > {tol}")
    # (b) the products are f16: bit-equal to the plain version's exact sums
    # (the GEMM family's routes here; the transformer family's in
    # phase_f16_transformer)
    for label, key, forced in _f16_gemm_probes():
        kern = f16_probe_kernel(key, forced)
        args, value = f16_probe(key)
        got = kern(*args)
        want = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        ok = f16_probe_holds(got, want, value)
        say(f"f16 products {label:20s} route {kern.route:8s} every output "
            f"{got.flatten()[0].item()!r} (plain {want.flatten()[0].item()!r},"
            f" f16 products {value!r}; bf16 products would give "
            f"{1.0 if value < 2 else float(WIDTH)!r}) bit-equal "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 products {label}: {got.flatten()[:4]}"
                                 f" vs {want.flatten()[:4]}")
    # (c) the main path, each launch counted
    cache = global_cache()
    cache.reset_launches()
    runs = (("flagship f16 (2 layers)", F16_FLAGSHIP, "default-tpp-passes",
             ["xsmm.fused_chain"]),
            ("fc 256x1024x1024 f16", F16_FC, "default-tpp-passes",
             ["xsmm.fused_brgemm"]),
            ("packed MLP f16 --tiles VNNI2", F16_PACKED, PACKED,
             ["xsmm.fused_brgemm"] * 2))
    for label, flags, pipeline, invokes in runs:
        res = run_module(_module(flags), device="cuda", pipeline=pipeline,
                         out_stream=sys.stderr)
        ops = [op.opname for op in res["module"]["entry"].ops
               if op.opname.startswith("xsmm.")
               and not op.opname.endswith("_dispatch")]
        if ops != invokes:
            raise AssertionError(f"{label}: lowered to {ops}")
        ref = run_module(_module(flags), device="cuda", linalg_to_loops=True,
                         out_stream=sys.stderr)
        got, want = res["outputs"][0], ref["outputs"][0]
        rel, ab = rel_err(got, want)
        ok = got.dtype == torch.float16 and tuple(got.shape) == \
            tuple(want.shape) and rel <= TOL_BF16 and torch_isfinite(got)
        say(f"f16 main {label:30s} -> {ops} {tuple(got.shape)} "
            f"{got.dtype} vs --linalg-to-loops rel {rel:.3e} abs {ab:.3e} "
            f"tol {TOL_BF16:.0e}, finite {torch_isfinite(got)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {label}: rel {rel}")
    for label, flags, pipeline, bench in (
            ("flagship f16 (2 layers)", F16_FLAGSHIP, "default-tpp-passes",
             "B4"),
            ("packed fc f16 --tiles VNNI2", F16_PACKED_FC, PACKED, "B20"),
            ("fc_128x768x2304 f16", F16_PINGPONG, "default-tpp-passes",
             "B5")):
        res = run_module(_module(flags), n=F16_N, device="cuda",
                         pipeline=pipeline, out_stream=sys.stderr)
        say(f"f16 main {label:30s} -n {F16_N}: bench {res['bench']!r}, "
            f"{res['gflops']:.1f} GFLOP/s ({res['mean_seconds'] * 1e3:.4f} "
            f"ms an iteration)")
        if bench not in str(res["bench"]):
            raise AssertionError(f"f16 {label}: bench {res['bench']}, "
                                 f"expected {bench}")
    launches = _f16_launches(cache)
    by_kind: dict = {}
    for key, n in launches.items():
        by_kind[_kind(key)] = by_kind.get(_kind(key), 0) + n
    say(f"f16 main path launches: {by_kind} "
        f"({time.perf_counter() - t0:.1f} s)")
    missing = [k for k in F16_KINDS if not by_kind.get(k)]
    if missing:
        raise AssertionError(f"f16 kernels of the path never launched: "
                             f"{missing}")
    # the flagship's forwards from a CUDA graph beside torch.matmul
    module = run_module(_module(F16_FLAGSHIP), device="cuda",
                        out_stream=sys.stderr)["module"]
    f = tpp_compile(module, "entry", "cuda")
    x = init_args(module, "entry", "normal", 0, "cuda")
    port = graph_ms(lambda: f(*x), COMPILER_GRAPH_N)
    base, base_g = _baseline_ms(_module(F16_FLAGSHIP), COMPILER_GRAPH_N)
    flops = _module(F16_FLAGSHIP).attrs["flops"]
    say(f"time flagship f16 (2 layers) graph of {COMPILER_GRAPH_N} "
        f"forwards: port {port:.4f} ms a forward "
        f"({flops / port / 1e9:.2f} TFLOP/s), torch.matmul + bias + ReLU in "
        f"f16 {base_g:.4f} ms from a CUDA graph ({base:.4f} ms eager)")
    # each f16 key the path launched, held against its plain version on
    # the inputs it is timed on, then timed: kernel-line rows
    rows = []
    for key, n in launches.items():
        kind = _kind(key)
        args = _f16_inputs(key, g)
        kern, plain = build_kernel(key), reference_kernel(key)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        tol, spread = TOL_F16_CHAIN if kind in F16_CHAINS else TOL_F16, ""
        if getattr(key, "repeats", 0) > 1:
            # a repeat loop carries each ulp a sum order flips on to every
            # later layer, so at -n 100 (200 layers) two sum orders part
            # further than at (a)'s 20: the kernel is held to the larger of
            # the chain tolerance and twice what another sum order alone
            # moves the plain version by (the same plain version, its
            # roundings included, on the host's BLAS)
            host = plain(*(a.cpu() if a is not None else None for a in args))
            host_rel = rel_err(host, want.cpu())[0]
            tol = max(tol, 2 * host_rel)
            spread = f" (plain version on the host vs on the card rel " \
                f"{host_rel:.3e})"
        ok = rel <= tol and torch_isfinite(got) and got.dtype == want.dtype
        say(f"f16 kernel {kind:19s} {describe(key):44s} (main path) rel "
            f"{rel:.3e} abs {ab:.3e} tol {tol:.3e}{spread}"
            f"{_route_note(key)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {describe(key)}: rel {rel} > {tol}")
        library = _library_call(kind, key, args)
        bound, by = _bound(kind, key, args)
        ms, plain_ms = cuda_ms(lambda: kern(*args)), \
            cuda_ms(lambda: plain(*args))
        lib_ms = cuda_ms(library) if library else None
        iters = 2 if getattr(key, "repeats", 0) > 8 else 20
        note = f" (replayed from a CUDA graph " \
            f"{graph_ms(lambda: kern(*args), iters=iters):.4f} ms"
        if kind in F16_CHAINS:
            note += f"; composed f16 chain, not one call, from a CUDA graph " \
                f"{graph_ms(_composed_chain(key, args), iters=iters):.4f} ms"
        note += ")"
        if getattr(key, "repeats", 0) > 1:
            note += f" ({ms / key.repeats:.4f} ms per repeat of " \
                f"{key.repeats})"
        lib = f"{lib_ms:.4f} ms" if lib_ms else "none"
        say(f"time kernel f16 {describe(key):44s} {ms:.4f} ms, plain "
            f"version {plain_ms:.4f} ms, library call {lib}, bound "
            f"{bound:.4f} ms ({by}); {n} launches on the f16 main path; "
            f"route {kern.route}{note}")
        rows.append((kind, key, kern.source, {
            "launches": n, "max_abs_err": ab, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}))
    say(f"phase f16: {time.perf_counter() - t0:.1f} s")
    return rows


# ROADMAP A14 items 1, 2, 3 and 5: the transformer family's f16 keys (B2's
# LayerNorm prologue and LN-stats pair, B12, attention.cu's B6-B11 and B7,
# batch_matmul.cu's B21/B22) on GPT-2 small, the encoder block and the MHA
# suite at their bf16/f32 rows' widths, in f16
F16_GPT2 = GPT2.replace('"dtype": "bf16"', '"dtype": "f16"')
F16_ENCODER = ENCODER[:-1] + ', "dtype": "f16"}'
F16_MHA = (
    {"name": "mha_qk_f16", "model": 'mha_qk:{"batch": 64, "heads": 16, '
     '"seq": 32, "head_dim": 64, "dtype": "f16"}'},
    {"name": "mha_softmax_v_f16", "model": 'mha_softmax_v:{"batch": 64, '
     '"heads": 16, "seq": 32, "head_dim": 64, "dtype": "f16"}'},
    {"name": "flash_attention_f16_s2048", "model": 'mha_full:{"batch": 2, '
     '"heads": 8, "seq": 2048, "head_dim": 64, "fused": true, "dtype": '
     '"f16", "scale": 0.125}'},
    {"name": "flash_attention_causal_f16_s2048", "model": 'mha_full:'
     '{"batch": 2, "heads": 8, "seq": 2048, "head_dim": 64, "causal": true, '
     '"dtype": "f16", "scale": 0.125}', "bench_mode": "scan"},
)
F16T_KINDS = ("brgemm", "attention", "layer_norm", "attention_flat",
              "attention_bench", "batch_matmul")


def _f16t_kernel_cases():
    """(a): (label, key, forced loader or body, or None) at the f16 paths'
    shapes: B2's LayerNorm-prologue GEMMs of GPT-2 (QKV + bias, fc1 + bias
    + gelu) and the encoder, one on the convert loader (k 764); B12 at
    GPT-2's ln_f, its first design forced; B7 at GPT-2's and the
    encoder's packed keys (on TMA, f16's only attention loader); the
    flat kernel at the suite's S 2048 rows (auto, causal, each forced
    strategy: grouped B9, qblock B8, twocall B10a, twocall2 B10b, blocks
    B6) and B11 at 3 repeats; B21/B22 at mha_qk's and mha_softmax_v's
    keys, an lhs_shared and a +C softmax key, and the tiled route."""
    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BrgemmKey,
                                         FlashMhaKey, LayerNormKey)
    ln = dict(beta0=True, binary_kind="add", prologue="layer_norm")
    gpt = FlashMhaKey(2, 1024, 1024, 64, "f16", scale=0.125, causal=True,
                      heads=12, qkv_packed=True)
    flat = FlashMhaKey(16, 2048, 2048, 64, "f16", scale=0.125)
    causal = dataclasses.replace(flat, causal=True)
    return (
        ("ln gpt2 qkv 2048x2304x768 +bias",
         BrgemmKey(1, 2048, 2304, 768, "f16", **ln), None),
        ("ln gpt2 fc1 2048x3072x768 +bias+gelu",
         BrgemmKey(1, 2048, 3072, 768, "f16", unary_kind="gelu", **ln),
         None),
        ("ln enc qkv 2048x3072x1024 +bias",
         BrgemmKey(1, 2048, 3072, 1024, "f16", **ln), None),
        ("ln enc fc1 2048x4096x1024 +bias+gelu",
         BrgemmKey(1, 2048, 4096, 1024, "f16", unary_kind="gelu", **ln),
         None),
        ("ln qkv 2048x2304x764 (convert)",
         BrgemmKey(1, 2048, 2304, 764, "f16", **ln), None),
        ("ln_f gpt2 2048x768", LayerNormKey(2048, 768, "f16"), None),
        ("ln_f gpt2 2048x768 strided", LayerNormKey(2048, 768, "f16"),
         "strided"),
        ("attn gpt2 b2 s1024 h12 d64 causal packed", gpt, None),
        ("attn enc b8 s256 h8 d128 packed",
         FlashMhaKey(8, 256, 256, 128, "f16", scale=128 ** -0.5, heads=8,
                     qkv_packed=True), None),
        ("flat B*H 16 s2048 d64", flat, None),
        ("flat B*H 16 s2048 d64 causal", causal, None),
        ("flat forced grouped (B9)",
         dataclasses.replace(flat, strategy="grouped"), None),
        ("flat forced qblock (B8)",
         dataclasses.replace(flat, strategy="qblock"), None),
        ("flat forced twocall causal (B10a)",
         dataclasses.replace(causal, strategy="twocall"), None),
        ("flat forced twocall2 causal (B10b)",
         dataclasses.replace(causal, strategy="twocall2"), None),
        ("flat blocked bq/bk 256 (B6)",
         dataclasses.replace(flat, bq=256, bk=256), None),
        ("flat B11 r3", dataclasses.replace(flat, repeats=3), None),
        ("bmm mha_qk 1024x32x32x64",
         BatchMatmulKey(1024, 32, 32, 64, "f16", beta0=True), None),
        ("bmm mha_softmax_v 1024x32x64x32",
         BatchMatmulKey(1024, 32, 64, 32, "f16", beta0=True,
                        softmax_lhs=True), None),
        ("bmm lhs_shared 300x48x64x40",
         BatchMatmulKey(300, 48, 64, 40, "f16", beta0=True,
                        lhs_shared=True), None),
        ("bmm softmax +C 130x20x32x64",
         BatchMatmulKey(130, 20, 32, 64, "f16", softmax_lhs=True), None),
        ("bmm tiled +C 16x96x72x100",
         BatchMatmulKey(16, 96, 72, 100, "f16"), None))


def _f16t_inputs(key, g):
    """Inputs of a transformer-family f16 key on the card: a LayerNorm
    prologue's raw A rows N(0.5, 2^2) (so the normalization shows), W
    N(0, 1/k), bias, gamma and beta N(0, 1) (gamma and beta f16, as the
    models keep them), a C N(0, 1); B12's x N(1, 3^2); attention's
    operands N(0, 1) (packed [Q|K|V] passed thrice, as the executor does);
    the batched matmul's A N(0, 2^2), B N(0, 1), C f32; any other key (the
    GEMMs the paths launch) as _f16_inputs makes it."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BrgemmKey,
                                         FlashMhaKey, LayerNormKey)
    f16 = torch.float16

    def rnd(*shape, scale=1.0, shift=0.0, dt=f16):
        return (torch.randn(shape, generator=g, device="cuda") * scale +
                shift).to(dt)
    if isinstance(key, BrgemmKey) and key.prologue == "layer_norm":
        return (rnd(1, key.m, key.k, scale=2.0, shift=0.5),
                rnd(1, key.k, key.n, scale=key.k ** -0.5),
                None if key.beta0 else rnd(key.m, key.n),
                rnd(key.n) if key.binary_kind else None, rnd(key.k),
                rnd(key.k))
    if isinstance(key, LayerNormKey):
        return rnd(key.m, key.n, scale=3.0, shift=1.0), rnd(key.n), \
            rnd(key.n)
    if isinstance(key, FlashMhaKey):
        E = (key.heads or 1) * key.head_dim
        if key.qkv_packed:
            x = rnd(key.batch, key.seq, 3 * E)
            return x, x, x
        return tuple(rnd(key.batch, s, E)
                     for s in (key.seq, key.seq_kv, key.seq_kv))
    if isinstance(key, BatchMatmulKey):
        a = rnd(*((key.m, key.k) if key.lhs_shared
                  else (key.batch, key.m, key.k)), scale=2.0)
        c = None if key.beta0 else rnd(key.batch, key.m, key.n,
                                       dt=torch.float32)
        return a, rnd(key.batch, key.k, key.n), c
    return _f16_inputs(key, g)


def _f16t_pair(g) -> float:
    """B2's LN-stats pair at GPT-2's fc width in f16: the producer (m 2048,
    k 768, n 3072, + bias, gelu, ln_stats_out) and its ln_stats consumer (k
    3072, n 768, + bias) fed the producer's y, mean and var, each against
    its plain version at TOL_F16, the statistics against the plain ones of
    the producer's own y at TOL_F32 (f32 sums of the same stored values),
    and each launched twice bit-equal. Returns the worst abs error."""
    import torch

    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.xsmm import (BrgemmKey, build_kernel,
                                         reference_kernel)
    from tpp_mlir_tpu_torch.xsmm.reference import ln_stats_out
    prod = BrgemmKey(1, 2048, 3072, 768, "f16", beta0=True,
                     binary_kind="add", unary_kind="gelu", ln_stats_out=True)
    cons = BrgemmKey(1, 2048, 768, 3072, "f16", beta0=True,
                     binary_kind="add", prologue="ln_stats")
    a, w1, _, b1 = _f16_inputs(dataclasses.replace(prod, ln_stats_out=False),
                               g)
    _, w2, _, b2 = _f16_inputs(dataclasses.replace(cons, prologue=None), g)
    gamma, beta = (torch.randn(3072, generator=g, device="cuda").to(
        torch.float16) for _ in range(2))
    pk, ck = build_kernel(prod), build_kernel(cons)
    y, mu, var = pk(a, w1, None, b1)
    y2, mu2, var2 = pk(a, w1, None, b1)
    want = reference_kernel(prod)(a, w1, None, b1)[0]
    smu, svar = ln_stats_out(y)
    args = (y[None], w2, None, b2, gamma, beta, mu, var)
    z = ck(*args)
    same = torch.equal(y, y2) and torch.equal(mu, mu2) and \
        torch.equal(var, var2) and torch.equal(ck(*args), z)
    zwant = reference_kernel(cons)(*args)
    torch.cuda.synchronize()
    rel_y, ab_y = rel_err(y, want)
    rel_s = max(rel_err(mu, smu)[0], rel_err(var, svar)[0])
    rel_z, ab_z = rel_err(z, zwant)
    ok = rel_y <= TOL_F16 and rel_z <= TOL_F16 and rel_s <= TOL_F32 and \
        same and torch_isfinite(z)
    say(f"f16 kernel brgemm_ln_stats producer {describe(prod)} rel "
        f"{rel_y:.3e} abs {ab_y:.3e}, mean/var vs its own y's rel "
        f"{rel_s:.3e} (tol {TOL_F32:.0e}); consumer {describe(cons)} "
        f"rel {rel_z:.3e} abs {ab_z:.3e} tol {TOL_F16:.0e}; second "
        f"launches bit-equal {same}{_route_note(prod)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"f16 LN-stats pair: y {rel_y}, stats {rel_s},"
                             f" consumer {rel_z}, bit-equal {same}")
    return max(ab_y, ab_z)


def _ln_composed(key, args):
    """B2's yardstick, composed and not one call, used nowhere in the port:
    F.layer_norm of A's rows in its own dtype (f16), then torch.addmm with
    the bias (or torch.mm) and the unary (F.gelu, the exact-erf gelu that
    gelu_exp2 meets within an ulp, for gelu), on the same operands."""
    import torch
    import torch.nn.functional as F

    from tpp_mlir_tpu_torch.xsmm.reference import UNARY_FNS
    a, b, _, d, gamma, beta = args[:6]
    unary = F.gelu if key.unary_kind == "gelu" else \
        UNARY_FNS.get(key.unary_kind) if key.unary_kind else None

    def run():
        x = F.layer_norm(a[0], (key.k,), gamma, beta, key.prologue_eps)
        y = torch.addmm(d, x, b[0]) if d is not None else torch.mm(x, b[0])
        return unary(y) if unary else y
    return run


def _f16t_times(kind, key, args, kern, plain, where) -> dict:
    """An f16 key's times: the kernel (and from a CUDA graph), its plain
    version, its library call (and from a graph), for B2 the composed
    F.layer_norm -> addmm, and its bound; printed on one line ending with
    `where`. Returns the kernel line's timing keys."""
    from tpp_mlir_tpu_torch.tools.trace import describe
    library = _library_call(kind, key, args)
    composed = _ln_composed(key, args) if getattr(
        key, "prologue", None) == "layer_norm" else None
    bound, by = _bound(kind, key, args)
    ms, plain_ms = cuda_ms(lambda: kern(*args)), \
        cuda_ms(lambda: plain(*args))
    lib_ms = cuda_ms(library) if library else None
    iters = 2 if getattr(key, "repeats", 0) > 8 else 20
    gms = graph_ms(lambda: kern(*args), iters=iters)
    entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms, "graph_ms": gms}
    note = ""
    if library:
        # the yardstick from a CUDA graph too, beside the kernel's
        entry["library_graph_ms"] = graph_ms(library, iters=iters)
        note = f"; library call from a CUDA graph " \
            f"{entry['library_graph_ms']:.4f} ms"
    if composed:
        entry["composed_ms"] = graph_ms(composed, iters=iters)
        entry["composed"] = "F.layer_norm -> torch.addmm (not one call)"
        note += f"; composed F.layer_norm -> addmm, not one call, from " \
            f"a CUDA graph {entry['composed_ms']:.4f} ms"
    if getattr(key, "repeats", 0) > 1:
        note += f" ({ms / key.repeats:.4f} ms per repeat of " \
            f"{key.repeats})"
    lib = f"{lib_ms:.4f} ms" if lib_ms else "none"
    say(f"time kernel f16 {describe(key):48s} {ms:.4f} ms (from a "
        f"CUDA graph {gms:.4f} ms), plain version {plain_ms:.4f} ms, "
        f"library call {lib}, bound {bound:.4f} ms ({by}); {where}; "
        f"route {kern.route}{note}")
    return entry


def phase_f16_transformer() -> list:
    """ROADMAP A14 items 1, 2, 3 and 5 on the card: (a) the transformer
    family's f16 keys against their plain versions at TOL_F16, each line
    naming its route, and B2's LN-stats pair; (b) the f16-not-bf16 probe on
    every route they take (B2 kLnSmem/kLnLoad and the pair, B12 register
    and strided, attention's TMA loader flat and token and B11, B21/B22
    multi and tiled); (c) GPT-2 small at s1024 b2 in f16 (12 layers),
    the f16 encoder block and the MHA suite's f16 rows through the bench
    driver, lowered against --linalg-to-loops at TOL_MODEL, finite, with
    the bf16/f32 rows' op counts, each path's launches counted (attention,
    layer_norm, brgemm, the flat kernel, B11 and batch_matmul must move);
    (d) each f16 key the paths launched held against its plain version at
    the key and timed beside it, its bound and its library call (B2: the
    composed F.layer_norm -> addmm, marked composed): kernel-line rows;
    then every key (a) held that the paths do not launch, and B2's LN-stats
    pair, timed the same way for PERF.md (no kernel-line row)."""
    import torch

    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.xsmm import global_cache, reference_kernel
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(23)
    worst: dict = {}
    # (a) each kernel at its f16 keys against its plain version
    for label, key, forced in _f16t_kernel_cases():
        args = _f16t_inputs(key, g)
        kern = f16_probe_kernel(key, forced)
        got = kern(*args)
        want = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        ok = rel <= TOL_F16 and torch_isfinite(got) and \
            got.dtype == want.dtype and kern.launches == 1
        note = f"; forced {forced}" if forced else _route_note(key)
        say(f"f16 kernel {_kind(key):16s} {label:48s} rel {rel:.3e} abs "
            f"{ab:.3e} tol {TOL_F16:.0e}{note} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {label}: rel {rel} > {TOL_F16}")
        worst[_kind(key)] = max(worst.get(_kind(key), 0.0), ab)
    worst["brgemm_ln_stats"] = _f16t_pair(g)
    # (b) the products are f16: bit-equal to the plain version's exact sums
    # (attention: within ATTN_PROBE_LIMIT, the bf16 readings further)
    for label, key, forced in _f16_transformer_probes():
        kern = f16_probe_kernel(key, forced)
        args, value = f16_probe(key)
        got = kern(*args)
        want = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        ok = f16_probe_holds(got, want, value)
        first = got[0] if isinstance(got, tuple) else got
        held = "bit-equal to the plain version and the probe's f16 value"
        if isinstance(value, dict):
            held = f"{rel_err(got, want)[1]:.3e} from the plain version " \
                f"(limit {ATTN_PROBE_LIMIT:.0e}); " + ", ".join(
                    f"{name} reads {rel_err(r, want)[1]:.3e} from it"
                    for name, r in value.items())
        say(f"f16 products {label:34s} route {kern.route:8s} output "
            f"{first.flatten()[:3].tolist()} {held} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 products {label}: "
                                 f"{first.flatten()[:4]}")
    # (c) the paths at full width, each one's launches counted
    cache = global_cache()
    launches: dict = {}
    entries = [(label, {"model": model}, ops, kinds, 0)
               for label, model, ops, kinds in F16_TRANSFORMERS]
    entries += [(e["name"], e, *_mha_want(e)[:2], MHA_N) for e in F16_MHA]
    for label, entry, want_ops, kinds, n in entries:
        t1 = time.perf_counter()
        cache.reset_launches()
        res = run_entry(entry, n=n, device="cuda", out_stream=sys.stderr)
        path = _launches(cache)
        for key, count in _f16_launches(cache).items():
            launches[key] = launches.get(key, 0) + count
        ops = _invoke_counts(res["lowered"]["module"])
        got = res["lowered"]["outputs"][0]
        want = res["baseline"]["outputs"][0]
        rel, ab = rel_err(got, want)
        finite = torch_isfinite(got)
        ok = ops == want_ops and finite and rel <= TOL_MODEL and \
            got.dtype == torch.float16 and \
            tuple(got.shape) == tuple(want.shape) and \
            all(path[k] for k in kinds)
        moved = {k: v for k, v in path.items() if v}
        timed = f"; -n {n} {res['lowered']['mean_seconds'] * 1e3:.4f} " \
            f"ms/iter, bench {res['lowered']['bench']}" if n else ""
        say(f"f16 main {label}: lowered to {ops}; output "
            f"{tuple(got.shape)} {str(got.dtype)[6:]} finite {finite}, vs "
            f"--linalg-to-loops rel {rel:.3e} abs {ab:.3e} tol "
            f"{TOL_MODEL:.0e}; launches {moved}{timed} "
            f"({time.perf_counter() - t1:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {label}: ops {ops} (want "
                                 f"{want_ops}), rel {rel}, finite {finite},"
                                 f" launches {path} (must move: {kinds})")
        del res, got, want
        torch.cuda.empty_cache()
    by_kind: dict = {}
    for key, count in launches.items():
        by_kind[_kind(key)] = by_kind.get(_kind(key), 0) + count
    say(f"f16 transformer paths launches: {by_kind}")
    missing = [k for k in F16T_KINDS if not by_kind.get(k)]
    if missing:
        raise AssertionError(f"f16 kernels of the paths never launched: "
                             f"{missing}")
    # (d) each f16 key the paths launched, held and timed: kernel-line rows
    rows = []
    for key, count in launches.items():
        kind = _kind(key)
        args = _f16t_inputs(key, g)
        kern, plain = f16_probe_kernel(key), reference_kernel(key)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        tol, spread = TOL_F16, ""
        if getattr(key, "repeats", 0) > 1 and rel > tol:
            # B11 feeds each repeat's rounded output back as Q, so an ulp a
            # sum order flips is carried on: held, as phase_f16 holds a
            # repeat key, to twice what another sum order alone moves the
            # plain version by (the same plain version on the host's BLAS)
            host = plain(*(a.cpu() for a in args))
            host_rel = rel_err(host, want.cpu())[0]
            tol = max(tol, 2 * host_rel)
            spread = f" (plain version on the host vs on the card rel " \
                f"{host_rel:.3e})"
        ok = rel <= tol and torch_isfinite(got) and got.dtype == want.dtype
        say(f"f16 kernel {kind:16s} {describe(key):48s} (paths) rel "
            f"{rel:.3e} abs {ab:.3e} tol {tol:.3e}{spread}"
            f"{_route_note(key)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {describe(key)}: rel {rel}")
        entry = _f16t_times(kind, key, args, kern, plain,
                            f"{count} launches on the f16 paths")
        rows.append((kind, key, kern.source, {
            "launches": count, "max_abs_err": ab, **entry}))
        worst[kind] = max(worst.get(kind, 0.0), ab)
    # every key (a) held that the paths do not launch (the forced flat
    # strategies, B12's first design, the convert and +C keys), and B2's
    # LN-stats pair: timed for PERF.md's f16 table, no kernel-line row
    for label, key, forced in _f16t_kernel_cases():
        if key in launches and not forced:
            continue
        args = _f16t_inputs(key, g)
        _f16t_times(_kind(key), key, args, f16_probe_kernel(key, forced),
                    reference_kernel(key), f"off the paths ({label})")
    _ln_stats_times("f16", "default", 3072, g)
    say(f"phase f16 transformer: {time.perf_counter() - t0:.1f} s; worst "
        f"abs error by kind {worst}")
    return rows


# ROADMAP A14 items 4, 6 and 7: the conv family's f16 keys (csrc/conv.cu's
# B23-B25), B16/B17 (csrc/grouped_gemm.cu) and B15's f16 output
# (csrc/int8_gemm.cu). The paths are conv.json's and vit.json's rows at
# their own sizes in f16, each named by the row it twins ("f16" in place of
# "bf16", or of f32 where the suite has no bf16 row at that size): (name,
# the row it twins, pipeline, kernels that must launch)
F16_CONV_ROWS = (
    ("conv3x3_f16_b8_c128_k128_30", "conv3x3_bf16_b8_c128_k128_30",
     "default-tpp-passes", ("conv_nhwc",)),
    ("conv3x3_f16_b8_c128_k128_30", "conv3x3_bf16_b8_c128_k128_30",
     "default-tpp-passes-packed", ("conv_blocked",)),
    ("conv3x3_nhwc_f16_b8_c128_k128_30", "conv3x3_nhwc_bf16_b8_c128_k128_30",
     "default-tpp-passes", ("conv_nhwc",)),
    ("conv3x3_nhwc_f16_b8_c256_k256_16", "conv3x3_nhwc_fp32_b8_c256_k256_16",
     "default-tpp-passes", ("conv_nhwc",)),
    ("conv1x1_nhwc_f16_b8_c256_k256_14", "conv1x1_nhwc_fp32_b8_c256_k256_14",
     "default-tpp-passes", ("conv_nhwc",)),
    ("conv3x3_f16_b8_c256_k256_16", "conv3x3_fp32_b8_c256_k256_16",
     "default-tpp-passes-packed", ("conv_blocked",)),
    ("conv3x3_f16_2layer", "conv3x3_fp32_2layer", "default-tpp-passes",
     ("conv_nhwc",)),
    ("resnet_block_nhwc_f16", "resnet_block_nhwc_bf16", "default-tpp-passes",
     ("conv_nhwc",)),
    ("resnet_block_torch_import_f16", "resnet_block_torch_import_bf16",
     "default-tpp-passes", ("conv_nhwc",)),
    ("vit_d128_p16_f16", "vit_d128_p16_bf16", "default-tpp-passes",
     ("attention", "brgemm")),
    ("vit_d64_p16_f16", "vit_d64_p16_bf16", "default-tpp-passes",
     ("attention", "brgemm")),
)
F16C_KINDS = ("conv_nhwc", "conv_blocked")
# B16 and B17 at the MoE slice's shapes in f16, and B15 at the int8
# prefill's, with an f16 output
_F16_B16 = dict(dtype="f16")
F16_GROUPED_CASES = (
    ("fc1 9216x3072x768 gelu f16", 4096, 128, 3072, 768,
     dict(_F16_B16, unary_kind="gelu"), False),
    ("fc1 9216x3072x768 gelu f32 out", 4096, 128, 3072, 768,
     dict(_F16_B16, unary_kind="gelu", out_dtype="f32"), False),
    ("fc2 9216x768x3072 f16", 4096, 128, 768, 3072, _F16_B16, False),
    ("small bm 16 2128x768x256 (wmma)", 1000, 16, 768, 256, _F16_B16,
     False),
)
F16_WGRAD_CASES = (
    ("dw2 k3072 n768 over 9216", 4096, 128, 3072, 768, False),
    ("dw1 k768 n3072 over 9216", 4096, 128, 768, 3072, False),
    ("skewed dw1 k768 n3072", 4096, 128, 768, 3072, True),
)


def _f16_twin(name: str, row: str, pipeline: str) -> dict:
    """A bench-driver entry of `row` (conv.json or vit.json) in f16: its
    bf16 marker made f16, or an f32 row given the f16 float type (dtype for
    resnet_block)."""
    entry = next(e for e in _conv_suite() if e["name"] == row)
    model = entry["model"]
    for bf16 in ('"float_type": "bf16"', '"dtype": "bf16"'):
        model = model.replace(bf16, bf16.replace("bf16", "f16"))
    if '"f16"' not in model:
        field = "dtype" if model.startswith("resnet_block:") else \
            "float_type"
        model = model[:-1] + f', "{field}": "f16"}}'
    out = {"name": name, "model": model, "pipeline": pipeline}
    if "bench_mode" in entry:
        out["bench_mode"] = entry["bench_mode"]
    return out


@functools.lru_cache(maxsize=None)
def _f16_row_keys(name: str, pipeline: str) -> tuple:
    """The conv keys (conv_nhwc, or the packed pipeline's channel-blocked
    ones) the pipeline makes of an f16 twin row."""
    from tpp_mlir_tpu_torch.passes import run_pipeline
    from tpp_mlir_tpu_torch.runtime.executor import _dispatch_key
    from tpp_mlir_tpu_torch.tools.bench_driver import build_module
    row = next(r for n, r, p, _ in F16_CONV_ROWS
               if n == name and p == pipeline)
    module = build_module(_f16_twin(name, row, pipeline))
    run_pipeline(module, pipeline)
    return tuple(_dispatch_key(op.operands[0].owner, op)
                 for op in module["entry"].ops
                 if op.opname in ("xsmm.brgemm", "xsmm.fused_brgemm")
                 and op.operands[0].owner.attrs.get("layout")
                 in ("conv_nhwc", "conv"))


def _f16c_kernel_cases():
    """(a): (label, key, forced body or None) at the f16 paths' keys and
    the kernel API's MoE and int8 prefill keys. B16/B17 come as (label,
    tokens, bm, n, k, fields, skew) tuples (their keys follow the
    routing's padding) and are made in phase_f16_conv."""
    from tpp_mlir_tpu_torch.xsmm import ConvNhwcKey
    flat = "default-tpp-passes"
    nhwc = _f16_row_keys("conv3x3_nhwc_f16_b8_c128_k128_30", flat)[0]
    int8 = [(f"{label} f16 out", dataclasses.replace(key, out_dtype="f16"),
             None) for label, key in _int8_cases()[:4]]
    return [
        ("conv c128/30 NHWC +bias+relu", nhwc, None),
        ("conv c128/30 NHWC forced wmma", nhwc, "wmma"),
        ("conv c128/30 NCHW flat +C",
         _f16_row_keys("conv3x3_f16_b8_c128_k128_30", flat)[0], None),
        ("conv c256/16 NHWC",
         _f16_row_keys("conv3x3_nhwc_f16_b8_c256_k256_16", flat)[0], None),
        ("conv 1x1 c256/14 NHWC",
         _f16_row_keys("conv1x1_nhwc_f16_b8_c256_k256_14", flat)[0], None),
        ("conv resnet NHWC same + residual",
         _f16_row_keys("resnet_block_nhwc_f16", flat)[1], None),
        ("conv ragged c12 k20 same +bias+relu (wmma)",
         ConvNhwcKey(N=8, H=16, W=16, C=12, K=20, R=3, S=3, dtype="f16",
                     beta0=True, binary_kind="add", unary_kind="relu",
                     pad=(1, 1, 1, 1)), None),
        ("B23 c128/30 packed Cb 1",
         _f16_row_keys("conv3x3_f16_b8_c128_k128_30", PACKED)[0], None),
        ("B23 c256/16 packed Cb 2",
         _f16_row_keys("conv3x3_f16_b8_c256_k256_16", PACKED)[0], None),
    ] + int8


def _f16c_inputs(key, g):
    """Inputs of a conv-family, grouped or int8 f16 key on the card: a
    conv's I N(0, 1) and W N(0, 1/(R S C)) in f16, its C and D (a bias or a
    residual) N(0, 1) in f16, as the f16 models keep them; B15's as
    _int8_inputs makes them (the engine's bf16 bias, which the kernel reads
    as stored: an f16 one is widened to f32 by the wrapper, one more
    launch a call); any other key (the ViTs' GEMMs, attention, LayerNorm)
    as _f16t_inputs makes it."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (ConvBrgemmKey, ConvNhwcKey,
                                         Int8GemmKey)
    f16 = torch.float16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(f16)
    if isinstance(key, ConvNhwcKey):
        out = (key.N, key.P, key.Q, key.K)
        d = None
        if key.binary_kind:
            d = rnd(*(out if key.binary_bcast == "none" else (key.K,)))
        return (rnd(key.N, key.H, key.W, key.C),
                rnd(key.R, key.S, key.C, key.K,
                    scale=(key.R * key.S * key.C) ** -0.5),
                None if key.beta0 else rnd(*out), d)
    if isinstance(key, ConvBrgemmKey):
        out = (key.N, key.Kb, key.P, key.Q, key.k)
        return (rnd(key.N, key.Cb, key.H, key.W, key.c),
                rnd(key.Kb, key.Cb, key.R, key.S, key.c, key.k,
                    scale=(key.R * key.S * key.Cb * key.c) ** -0.5),
                None if key.beta0 else rnd(*out),
                rnd(key.Kb, key.k) if key.binary_kind else None)
    if isinstance(key, Int8GemmKey):
        return _int8_inputs(key, g)
    return _f16t_inputs(key, g)


def _bf16_twin(key, args):
    """`key` and `args` with bf16 in place of f16 (an f32 output stays
    f32): the bf16 key its f16 key is timed beside."""
    import torch
    fields = {f: "bf16" for f in ("dtype", "out_dtype")
              if getattr(key, f, None) == "f16"}
    return dataclasses.replace(key, **fields), tuple(
        a.to(torch.bfloat16) if isinstance(a, torch.Tensor) and
        a.dtype == torch.float16 else a for a in args)


def _beside_twin(key, kern, args, forced=None) -> float:
    """An f16 key and its bf16 twin (the same route, forced body, tiles and
    bytes) timed from CUDA graphs in turns (bf16, f16, f16, bf16, each pair
    averaged, so that neither gains from its place in the call) and
    printed; returns the twin's ms."""
    from tpp_mlir_tpu_torch.tools.trace import describe
    twin, targs = _bf16_twin(key, args)
    tk = f16_probe_kernel(twin, forced)
    b1, f1, f2, b2 = (graph_ms(fn) for fn in (
        lambda: tk(*targs), lambda: kern(*args), lambda: kern(*args),
        lambda: tk(*targs)))
    f16_ms, bf16_ms = (f1 + f2) / 2, (b1 + b2) / 2
    say(f"time kernel f16 {describe(key):48s} in turns with its bf16 twin "
        f"from CUDA graphs: f16 {f16_ms:.4f} ms, bf16 {bf16_ms:.4f} ms "
        f"(f16/bf16 {f16_ms / bf16_ms:.3f})")
    return bf16_ms


def _grouped_library(kind, key, args):
    """B16/B17's yardstick in f16: torch._grouped_mm where it takes the
    key (no epilogue, f16 out; in f16 it copies to the host, so it is
    timed eagerly, not from a graph), else a per-group torch.mm loop (+
    F.gelu) on the same rows, composed and not one call. Returns
    (callable, whether composed)."""
    import torch
    import torch.nn.functional as F
    call = _grouped_mm_call(kind, key, args)
    if call is not None:
        try:
            call()
            return call, False
        except (RuntimeError, TypeError):
            pass
    ge = args[-3] if kind == "grouped_gemm" else args[0]
    counts = torch.bincount(ge.long(), minlength=key.n_groups).tolist()
    cuts, r = [], 0
    for g_, c in enumerate(counts):
        if c:
            cuts.append((g_, r, r + c * key.bm))
        r += c * key.bm
    if kind == "grouped_gemm":
        _, x, b = args[-3:]
        w = b[0] if key.layers else b
        w = w.transpose(-2, -1) if key.transpose_b else w
        gelu = key.unary_kind == "gelu"

        def run():
            for g_, lo, hi in cuts:
                y = torch.mm(x[lo:hi], w[g_])
                if gelu:
                    F.gelu(y)
        return run, True
    _, xt, dy = args

    def run():
        for g_, lo, hi in cuts:
            torch.mm(xt[:, lo:hi], dy[lo:hi])
    return run, True


def _f16c_api_times(kind, key, args, kern, plain, label) -> None:
    """A kernel-API f16 key's times, for PERF.md (no kernel-line row): the
    kernel eager and from a CUDA graph, its bf16 twin from a graph, its
    plain version, its yardstick from a graph (B16/B17: _grouped_library;
    B15: the composed torch._int_mm chain) and its bound."""
    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.xsmm import Int8GemmKey
    if isinstance(key, Int8GemmKey):
        library, composed = _int8_composed(key, args), True
    else:
        library, composed = _grouped_library(kind, key, args)
    bound, by = _bound(kind, key, args)
    ms, plain_ms = cuda_ms(lambda: kern(*args)), \
        cuda_ms(lambda: plain(*args))
    gms = graph_ms(lambda: kern(*args))
    lib = f"composed (not one call) from a CUDA graph " \
        f"{graph_ms(library):.4f} ms" if composed else \
        f"library call torch._grouped_mm eager {cuda_ms(library):.4f} ms"
    say(f"time kernel f16 {describe(key):48s} {ms:.4f} ms (from a CUDA "
        f"graph {gms:.4f} ms), plain version {plain_ms:.4f} ms, {lib}, "
        f"bound {bound:.4f} ms ({by}); kernel API ({label}); route "
        f"{kern.route}")


def phase_f16_conv() -> list:
    """ROADMAP A14 items 4, 6 and 7 on the card: (a) conv.cu (B24/B25 on
    its tma route and forced wmma tile, a ragged-channel key on the wmma
    tile, B23 at Cb 1 and 2), B16 (fc1 + gelu to f16 and f32, fc2, bm 16
    on the WMMA tile), B17 (dw1, dw2, skewed) and B15 (QKV, fc1, fc2, LM
    head to f16) at f16 keys against their plain versions at TOL_F16; (b)
    the f16-not-bf16 probe on every new route, bit-equal; (c) the f16 twins
    of conv.json's and vit.json's rows and the conv-BN-pool stack (N 8, C
    128, 32x32) in f16, lowered, against --linalg-to-loops at TOL_MODEL,
    finite and f16, each path's launches counted (conv_nhwc and
    conv_blocked must move); (d) each f16 key the paths launched held
    against its plain version and timed beside its bf16 twin, its bound
    and its library call (F.conv2d f16): kernel-line rows; then the (a)
    keys the paths do not launch (the kernel API's B15-B17, the forced and
    ragged conv keys), timed for PERF.md."""
    import torch

    from tpp_mlir_tpu_torch.frontend import import_torch
    from tpp_mlir_tpu_torch.passes import run_pipeline
    from tpp_mlir_tpu_torch.runtime import compile as tpp_compile
    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.xsmm import (build_kernel, global_cache,
                                         reference_kernel)
    from tpp_mlir_tpu_torch.xsmm.reference import conv_route
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(24)
    worst: dict = {}
    api = []        # (kind, key, args, kern, label) of the kernel API's keys

    def held(label, key, forced, args, extra=""):
        kern = f16_probe_kernel(key, forced)
        got = kern(*args)
        want = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        ok = rel <= TOL_F16 and torch_isfinite(got) and \
            got.dtype == want.dtype and kern.launches == 1
        note = f"; forced {forced}" if forced else _route_note(
            key, args[1].stride() if _kind(key) == "grouped_wgrad" else None)
        say(f"f16 kernel {_kind(key):14s} {label:44s} rel {rel:.3e} abs "
            f"{ab:.3e} tol {TOL_F16:.0e}{extra}{note} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {label}: rel {rel} > {TOL_F16}, "
                                 f"launches {kern.launches}")
        worst[_kind(key)] = max(worst.get(_kind(key), 0.0), ab)
        return kern
    # (a) each kernel at its f16 keys against its plain version
    cases = _f16c_kernel_cases()
    for label, key, forced in cases:
        args = _f16c_inputs(key, g)
        kern = held(label, key, forced, args)
        if forced or _kind(key) == "int8_gemm" or "ragged" in label:
            api.append((_kind(key), key, args, kern, label, forced))
    for label, T, bm, n, k, fields, skew in F16_GROUPED_CASES:
        key, args, pad = _grouped_gemm_inputs(g, T, bm, n, k, fields, skew)
        kern = held(label, key, None, args)
        if kern(*args)[pad].any().item():
            raise AssertionError(f"f16 {label}: padding rows not zero")
        api.append(("grouped_gemm", key, args, kern, label, None))
    for label, T, bm, k, n, skew in F16_WGRAD_CASES:
        key, args, untouched = _grouped_wgrad_inputs(g, T, bm, k, n, skew,
                                                     dtype="f16")
        kern = held(label, key, None, args,
                    f"; experts no token chose {untouched}")
        if bool(untouched) != skew or kern(*args)[untouched].any().item():
            raise AssertionError(f"f16 {label}: untouched {untouched}")
        api.append(("grouped_wgrad", key, args, kern, label, None))
    # (b) the products are f16 (B15: the stores keep f16's 2^-10)
    for label, key, forced in _f16_conv_probes():
        kern = f16_probe_kernel(key, forced)
        args, value = f16_probe(key)
        got = kern(*args)
        want = reference_kernel(key)(*args)
        torch.cuda.synchronize()
        ok = f16_probe_holds(got, want, value)
        say(f"f16 products {label:22s} route {kern.route:8s} every output "
            f"{got.flatten()[0].item()!r} (plain "
            f"{want.flatten()[0].item()!r}, f16 {value!r}) bit-equal "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 products {label}: "
                                 f"{got.flatten()[:4]}")
    # (c) the paths at full width, each one's launches counted
    cache = global_cache()
    launches: dict = {}

    def count(label, kinds):
        path = _launches(cache)
        for key, n in _f16_launches(cache).items():
            launches[key] = launches.get(key, 0) + n
        moved = {k: v for k, v in path.items() if v}
        if not all(path[k] for k in kinds):
            raise AssertionError(f"f16 {label}: launches {moved} (must "
                                 f"move: {kinds})")
        return moved
    for name, row, pipeline, kinds in F16_CONV_ROWS:
        t1 = time.perf_counter()
        cache.reset_launches()
        res = run_entry(_f16_twin(name, row, pipeline), n=0, device="cuda",
                        out_stream=sys.stderr)
        module = res["lowered"]["module"]
        keys = [key for _, key in _conv_dispatches(module)]
        routes = [conv_route(key) for key in keys]
        layouts = _packed_layouts(module)
        got = res["lowered"]["outputs"][0]
        want = res["baseline"]["outputs"][0]
        rel, ab = rel_err(got, want)
        finite = torch_isfinite(got)
        moved = count(name, kinds)
        vit = name.startswith("vit")
        ok = finite and rel <= TOL_MODEL and got.dtype == torch.float16 \
            and tuple(got.shape) == tuple(want.shape) and \
            routes == (["xla"] if vit else ["kernel"] * len(routes)) and \
            all(key.dtype == "f16" for key in keys) and \
            (pipeline != PACKED or layouts.get("conv"))
        say(f"f16 main {name} ({pipeline}): lowered to "
            f"{_invoke_counts(module)}; conv routes {routes}, packed "
            f"{layouts}; output {tuple(got.shape)} {str(got.dtype)[6:]} "
            f"finite {finite}, vs --linalg-to-loops rel {rel:.3e} abs "
            f"{ab:.3e} tol {TOL_MODEL:.0e}; launches {moved} "
            f"({time.perf_counter() - t1:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {name}: rel {rel}, finite {finite}, "
                                 f"routes {routes}, layouts {layouts}")
        del res, got, want
        torch.cuda.empty_cache()
    # the imported conv-BN-pool stack in f16
    cache.reset_launches()
    model, x = _conv_bn_pool_stack()
    x = x.to("cuda", torch.float16)
    stack = import_torch(model, CONV_STACK, "f16")
    run_pipeline(stack, "default-tpp-passes")
    got = tpp_compile(stack, "entry", "cuda")(x)
    want = tpp_compile(import_torch(model, CONV_STACK, "f16"), "entry",
                       "cuda")(x)
    rel, ab = rel_err(got, want)
    moved = count("conv-BN-pool stack f16", ("conv_nhwc",))
    ok = torch_isfinite(got) and rel <= TOL_MODEL and \
        got.dtype == torch.float16
    say(f"f16 main conv-BN-pool stack N{CONV_STACK[0]} C{CONV_STACK[1]} "
        f"{CONV_STACK[2]}x{CONV_STACK[3]}: invokes {_invokes(stack)}; "
        f"output {tuple(got.shape)} {str(got.dtype)[6:]} vs "
        f"--linalg-to-loops rel {rel:.3e} abs {ab:.3e} tol "
        f"{TOL_MODEL:.0e}; launches {moved} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"f16 conv-BN-pool stack: rel {rel}")
    by_kind: dict = {}
    for key, n in launches.items():
        by_kind[_kind(key)] = by_kind.get(_kind(key), 0) + n
    say(f"f16 conv paths launches: {by_kind}")
    missing = [k for k in F16C_KINDS if not by_kind.get(k)]
    if missing:
        raise AssertionError(f"f16 kernels of the paths never launched: "
                             f"{missing}")
    # (d) each f16 key the paths launched, held and timed beside its bf16
    # twin: kernel-line rows
    rows = []
    for key, n in launches.items():
        kind = _kind(key)
        args = _f16c_inputs(key, g)
        kern, plain = build_kernel(key), reference_kernel(key)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        ok = rel <= TOL_F16 and torch_isfinite(got) and \
            got.dtype == want.dtype
        say(f"f16 kernel {kind:14s} {describe(key):48s} (paths) rel "
            f"{rel:.3e} abs {ab:.3e} tol {TOL_F16:.0e}{_route_note(key)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 {describe(key)}: rel {rel}")
        entry = _f16t_times(kind, key, args, kern, plain,
                            f"{n} launches on the f16 conv paths")
        entry["bf16_twin_graph_ms"] = _beside_twin(key, kern, args)
        rows.append((kind, key, kern.source, {
            "launches": n, "max_abs_err": ab, **entry}))
        worst[kind] = max(worst.get(kind, 0.0), ab)
    # the kernel API's keys and the conv keys the paths do not launch,
    # timed for PERF.md (no kernel-line row)
    for kind, key, args, kern, label, forced in api:
        if kind in ("grouped_gemm", "grouped_wgrad", "int8_gemm"):
            _f16c_api_times(kind, key, args, kern, reference_kernel(key),
                            label)
        else:
            _f16t_times(kind, key, args, kern, reference_kernel(key),
                        f"off the paths ({label})")
        _beside_twin(key, kern, args, forced)
    say(f"phase f16 conv: {time.perf_counter() - t0:.1f} s; worst abs "
        f"error by kind {worst}")
    return rows


# ROADMAP A14 item 8: the attention kernels' f16 keys. B13 (csrc/
# decode_attn.cu) over an f16 KV cache, f32 out; B14 (attention.cu's
# training mode) and B18 (flash_train.cu's wgmma passes) with f16
# products, P and dS rounded to bf16 and O and the grads stored in bf16, as
# the JAX package's f16 keys do. No f16 engine exists: the paths are the
# kernel API's keys of GPT-2 small's decode and training steps (and
# LLaMA's GQA decode), each (label, key, on the path)
TOL_F16_TRAIN = 2 * TOL_BF16    # B14/B18's bf16 keys' tolerance (phase 3)
F16_MAX = 65504.0               # f16's largest finite value
F16_BIG = 8192.0    # exact in f16 and bf16: F16_BIG * 2^-10 / 8 = 1


def _f16a_decode_cases():
    from tpp_mlir_tpu_torch.xsmm import DecodeAttnKey
    geo = dict(batch=8, seq=1024, head_dim=64, stacked=12, dtype="f16")
    off = dict(batch=2, seq=512, dtype="f16", stacked=2)
    return [
        ("gpt2 mha b8 h12 s1024 d64", DecodeAttnKey(heads=12, **geo), True),
        ("slotted, one sentinel", DecodeAttnKey(heads=12, slotted=True,
                                                **geo), True),
        ("llama gqa kv4 g3", DecodeAttnKey(heads=4, groups=3, **geo), True),
        ("f16 q over an int8 cache", DecodeAttnKey(heads=12, kv_quant=True,
                                                   **geo), True),
        ("pack2", DecodeAttnKey(heads=12, pack2=True, **geo), True),
        ("tp-local kv6", DecodeAttnKey(heads=6, **geo), True),
        ("d32 b2 h8 s512 (off the path)",
         DecodeAttnKey(heads=8, head_dim=32, **off), False),
        ("d128 kv2 g4 b2 s512 (off the path)",
         DecodeAttnKey(heads=2, head_dim=128, groups=4, **off), False),
    ]


def _f16a_train_cases():
    from tpp_mlir_tpu_torch.xsmm import FlashTrainKey
    return [
        ("gpt2 train b8 s512 h12 d64 causal",
         FlashTrainKey(TRAIN_B, 12, TRAIN_S, 64, "f16", True, 0.125), True),
        ("d32 b2 s256 h8 causal (off the path)",
         FlashTrainKey(2, 8, 256, 32, "f16", True, 32 ** -0.5), False),
        ("d128 b2 s256 h4 (off the path)",
         FlashTrainKey(2, 4, 256, 128, "f16", False, 128 ** -0.5), False),
        ("d64 b2 s256 h4 non-causal (off the path)",
         FlashTrainKey(2, 4, 256, 64, "f16", False, 0.125), False),
        ("ragged b2 s200 h4 d64 causal (off the path)",
         FlashTrainKey(2, 4, 200, 64, "f16", True, 0.125), False),
    ]


def _f16_attention_probes():
    """(b): (label, key, probe) for B13, B14 and B18: "operands" (q, K, V
    and dO holding 1 + 2^-10 where a rounding to bf16 moves the output)
    and "P" (logits where P's bf16 and f16 roundings part)."""
    from tpp_mlir_tpu_torch.xsmm import (DecodeAttnKey, FlashTrainBwdKey,
                                         FlashTrainKey)
    from tpp_mlir_tpu_torch.xsmm.reference import LOG2E
    ops = dict(batch=2, heads=2, seq=128, head_dim=64, dtype="f16",
               causal=False, scale=0.125)
    p = dict(ops, seq=64, scale=(1 / 32) / LOG2E)
    return (
        ("B13 operands", DecodeAttnKey(2, 2, 128, 64, "f16"), "operands"),
        ("B13 f16 q int8 kv", DecodeAttnKey(2, 2, 128, 64, "f16",
                                            kv_quant=True), "operands"),
        ("B14 operands", FlashTrainKey(**ops), "operands"),
        ("B18 operands", FlashTrainBwdKey(**ops), "operands"),
        ("B14 P", FlashTrainKey(**p), "P"),
        ("B18 P", FlashTrainBwdKey(**p), "P"))


def _outputs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _f16a_model(key, args, rounded=(), p_dt=None):
    """B14's or B18's function in f64 on the host on `args`, with the named
    operands ("q", "k", "v", "do") rounded to bf16 and P and dS rounded to
    p_dt (bf16, as the JAX package rounds them; f16 for a kernel that kept
    them in f16); the outputs rounded to bf16, as stored."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import FlashTrainBwdKey
    from tpp_mlir_tpu_torch.xsmm.reference import LOG2E
    bf16 = torch.bfloat16
    p_dt = p_dt or bf16
    x = [(a.to(bf16) if n in rounded else a).cpu().double()
         for n, a in zip(("q", "k", "v", "do"), args)]
    q, k, v = (t.transpose(1, 2) for t in x[:3])      # (B, H, S, D)
    s2 = q @ k.transpose(-1, -2) * (key.scale * LOG2E)
    if key.causal:
        S = s2.shape[-1]
        s2 = s2.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                            -1e30)

    def rnd(t):
        return t.to(p_dt).double()

    def out(*ts):
        return tuple(t.transpose(1, 2).to(bf16).to(args[0].device)
                     for t in ts)
    if not isinstance(key, FlashTrainBwdKey):
        p = torch.exp2(s2 - s2.amax(-1, keepdim=True))
        return out(rnd(p) @ v / p.sum(-1, keepdim=True))
    lse2, delta = (a.cpu().double()[..., None] for a in args[4:6])
    do = x[3].transpose(1, 2)
    p = torch.exp2(s2 - lse2)
    ds = rnd(p * (do @ v.transpose(-1, -2) - delta) * key.scale)
    return out(ds @ k, ds.transpose(-1, -2) @ q,
               rnd(p).transpose(-1, -2) @ do)


def f16_attention_probe(key, probe):
    """(b)'s inputs at `key`: (args, keywords, readings, model, subject).
    `readings` are the outputs of a kernel that rounded one operand to
    bf16 (or kept P and dS in f16), `model` those of the kernel's
    roundings in f64 (None for B13, whose readings are its plain version
    on the rounded operands), `subject` the outputs the probe reads.

    "operands": q rows (1 + 2^-10, -1, F16_BIG, F16_BIG, 0, ...), K's even
    rows (F16_BIG, F16_BIG, 0, ...) and odd rows (0, 0, 1 + 2^-10, -1,
    0, ...): both scores F16_BIG 2^-10 / 8 = 1, so P is uniform; in bf16
    q (or K) makes the even (or odd) scores 0. B13 and B14: V's even rows
    64 (1 + 2^-10), odd rows -64 (column 0), so the output is 2^-5 (0 for a
    bf16 V), about -29.7 or 29.8 for a bf16 q or K. B18 (non-causal, S 128,
    P = 1/128): V's rows 64 (1 + 2^-10), dO's even rows 64 (1 + 2^-10) and
    odd rows -64, so dV is 2^-5 (0 for a bf16 dO) and dP - delta is 0 (dS,
    dQ, dK 0; not for a bf16 V). f16 q over an int8 cache: K's even rows
    (64, 64) with scale F16_BIG / 64, V's rows +-1: out (e - 1) / (e + 1)
    = 0.462, 0 for a bf16 q.
    "P" (scale log2(e) = 1/32, S 64): even query rows (1, 1, 0, ...), odd
    (0, 1, 0, ...); K row 0 (1, 0, ...), row 1 zero, rows 2 on (0, -2048,
    ...): base-2 logits (1/32, 0, -64, ...) and (0, 0, -64, ...). B14: V
    rows 0 and 1 (-0.98046875, ...) and (1, ...), so an even row reads
    (P1' - 0.98046875) / l with P1' = 2^(-1/32) rounded, 0 in bf16 and
    -9.87e-4 in f16. B18: P's even rows (0.50541, 0.49459) and odd rows
    (0.5, 0.5), dO's even rows 1 and odd rows -0.98828125, so dV's row 1
    is 32 (P1' - 0.494140625): 0 in bf16, 2^-6 in f16."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (DecodeAttnKey, FlashTrainBwdKey,
                                         FlashTrainKey, reference_kernel)
    f16, bf16 = torch.float16, torch.bfloat16

    def z(*shape, dt=f16):
        return torch.zeros(shape, dtype=dt, device="cuda")
    D = key.head_dim
    if isinstance(key, DecodeAttnKey):
        B, H, S = key.batch, key.heads, key.seq
        q = z(B, H, D)
        q[..., 0], q[..., 1], q[..., 2:4] = F16_ONE, -1.0, F16_BIG
        pos = torch.tensor([S - 1], dtype=torch.int32, device="cuda")
        kw = {}
        if key.kv_quant:
            i8 = torch.int8
            k, v = z(B, H, S, D, dt=i8), z(B, H, S, D, dt=i8)
            k[:, :, 0::2, :2] = 64
            v[:, :, 0::2, 0], v[:, :, 1::2, 0] = 1, -1
            ks = torch.ones(B, H, S, device="cuda")
            ks[:, :, 0::2] = F16_BIG / 64
            kw = {"k_s": ks, "v_s": torch.ones(B, H, S, device="cuda")}
            rounded = ("q",)
        else:
            k, v = z(B, H, S, D), z(B, H, S, D)
            k[:, :, 0::2, :2] = F16_BIG
            k[:, :, 1::2, 2], k[:, :, 1::2, 3] = F16_ONE, -1.0
            v[:, :, 0::2, 0], v[:, :, 1::2, 0] = 64 * F16_ONE, -64.0
            rounded = ("q", "k", "v")
        args, plain = (q, k, v, pos), reference_kernel(key)
        readings = {}
        for i, n in enumerate(rounded):
            r = list(args)
            r[i] = r[i].to(bf16).to(f16)
            readings[f"{n} in bf16"] = (plain(*r, **kw),)
        return args, kw, readings, None, (0,)
    bwd = isinstance(key, FlashTrainBwdKey)
    B, S, H = key.batch, key.seq, key.heads
    q, k, v, do = (z(B, S, H, D) for _ in range(4))
    if probe == "operands":
        q[..., 0], q[..., 1], q[..., 2:4] = F16_ONE, -1.0, F16_BIG
        k[:, 0::2, :, :2] = F16_BIG
        k[:, 1::2, :, 2], k[:, 1::2, :, 3] = F16_ONE, -1.0
        if bwd:
            v[..., 0] = 64 * F16_ONE
            do[:, 0::2, :, 0], do[:, 1::2, :, 0] = 64 * F16_ONE, -64.0
        else:
            v[:, 0::2, :, 0], v[:, 1::2, :, 0] = 64 * F16_ONE, -64.0
    else:
        q[:, 0::2, :, 0], q[..., 1] = 1.0, 1.0
        k[:, 0, :, 0], k[:, 2:, :, 1] = 1.0, -2048.0
        v[:, 0, :, 0], v[:, 1, :, 0] = -0.98046875, 1.0
        do[:, 0::2, :, 0], do[:, 1::2, :, 0] = 1.0, -0.98828125
    args = (q, k, v)
    if bwd:
        fwd = FlashTrainKey(**dataclasses.asdict(key))
        o, lse2 = reference_kernel(fwd)(q, k, v)
        args = (q, k, v, do, lse2, _flash_delta(do, o))
    if probe == "operands":
        names = ("q", "k", "v", "do") if bwd else ("q", "k", "v")
        readings = {f"{n} in bf16": _f16a_model(key, args, (n,))
                    for n in names}
        subject = (0, 1, 2) if bwd else (0,)
    else:
        readings = {"P in f16": _f16a_model(key, args, p_dt=f16)}
        subject = (2,) if bwd else (0,)
    return args, {}, readings, _f16a_model(key, args), subject


def f16_attention_probe_holds(got, want, readings, model, subject) -> bool:
    """Whether the probe's outputs (`subject`) are within ATTN_PROBE_LIMIT
    of the plain version's, as the f64 model of the kernel's roundings is,
    and every reading is more than twice that from them."""
    got, want = _outputs(got), _outputs(want)

    def dist(xs):
        return max(rel_err(xs[i], want[i])[1] for i in subject)
    return dist(got) <= ATTN_PROBE_LIMIT and \
        (model is None or dist(model) <= ATTN_PROBE_LIMIT) and \
        all(dist(r) > 2 * ATTN_PROBE_LIMIT for r in readings.values())


def _f16a_max_ds(key, bargs) -> float:
    """max |dS| = max |P (dP - delta) scale| of B18 at these operands, in
    f32 on the card: what the kernel rounds to bf16 and converts to f16,
    whose largest finite value is F16_MAX."""
    import torch

    from tpp_mlir_tpu_torch.xsmm.reference import _logits2
    q, k, v, do, lse2, delta = bargs
    p = torch.exp2(_logits2(key, q, k) - lse2[..., None])
    dp = torch.matmul(do.transpose(1, 2).float(),
                      v.transpose(1, 2).float().transpose(-1, -2))
    return float((p * (dp - delta[..., None]) * key.scale).abs().max())


def _f16a_times(kind, key, args, where) -> dict:
    """An f16 key's times for the kernel line: beside its bf16 twin from
    CUDA graphs in turns (bf16, f16, f16, bf16), its plain version, its
    bound and SDPA in f16. B13 walks the stacked layers in each graph, as
    a decode step reads them (its plain version and SDPA on the live rows
    too); B14 and B18 eager and from a graph, B18's SDPA backward eager
    (torch.autograd.grad) and its backward op from a graph."""
    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    kern, plain = build_kernel(key), reference_kernel(key)
    twin, targs = _bf16_twin(key, args)
    tk = build_kernel(twin)
    bound, by = _bound(kind, key, args)
    if kind == "decode_attn":
        iters = 2 * key.stacked

        def walk(fn, a):
            return _walk(lambda li: fn(*a[:4], li, *a[5:]), key)
        b1, f1, f2, b2 = (graph_ms(walk(fn, a), iters=iters) for fn, a in (
            (tk, targs), (kern, args), (kern, args), (tk, targs)))
        layer = _decode_library(key, args)
        lib = graph_ms(_walk(layer, key), iters=iters) if layer else None
        entry = {"ms": (f1 + f2) / 2, "graph_ms": (f1 + f2) / 2,
                 "plain_ms": graph_ms(walk(plain, args), iters=iters),
                 "library_ms": lib,
                 "eager_ms": cuda_ms(lambda: kern(*args))}
        note = "walking the layers"
    else:
        b1, f1, f2, b2 = (graph_ms(fn) for fn in (
            lambda: tk(*targs), lambda: kern(*args), lambda: kern(*args),
            lambda: tk(*targs)))
        library = _library_call(kind, key, args)
        glib = _sdpa_backward_op(key, args) \
            if kind == "flash_train_bwd" else library
        entry = {"ms": cuda_ms(lambda: kern(*args)),
                 "graph_ms": (f1 + f2) / 2,
                 "plain_ms": cuda_ms(lambda: plain(*args)),
                 "library_ms": cuda_ms(library),
                 "library_graph_ms": graph_ms(glib)}
        note = f"eager {entry['ms']:.4f} ms"
    entry.update(bound_ms=bound, bound_by=by,
                 bf16_twin_graph_ms=(b1 + b2) / 2)
    ratio = entry["graph_ms"] / entry["bf16_twin_graph_ms"]
    lib = "none" if entry["library_ms"] is None else \
        f"{entry['library_ms']:.4f} ms" + (
            f" (graph {entry['library_graph_ms']:.4f} ms)"
            if "library_graph_ms" in entry else "")
    say(f"time kernel f16 {describe(key):48s} from CUDA graphs {note}: "
        f"f16 {entry['graph_ms']:.4f} ms, bf16 twin "
        f"{entry['bf16_twin_graph_ms']:.4f} ms (f16/bf16 {ratio:.3f}"
        f"{', more than 10% slower' if ratio > 1.1 else ''}); plain "
        f"version {entry['plain_ms']:.4f} ms, SDPA f16 {lib}, bound "
        f"{bound:.4f} ms ({by}); {where}; route {kern.route}")
    return entry


def phase_f16_attention() -> list:
    """ROADMAP A14 item 8 on the card: (a) B13 at f16 keys (GPT-2 small's
    stacked decode, slotted, LLaMA's GQA, f16 q over an int8 cache, pack2,
    the tp-local kv6 key; d32 and d128 off the path) within TOL_F32 of its
    plain version, f32 out; B14 and B18 at GPT-2 small's training key and
    four keys off it within TOL_F16_TRAIN, bf16 O and grads, lse2 within
    TOL_LSE, B18 bit-repeatable and fed B14's own lse2 and delta, max|dS|
    against F16_MAX; each kernel on its hand-written route; (b) the
    operand and P probes (f16_attention_probe); (c) the path: counts set
    to 0, each path key dispatched through the kernel cache (decode
    walking the 12 layers, B14 then B18 on its outputs), every one
    launched; (d) each path key timed (_f16a_times): kernel-line rows; the
    keys off the path timed the same way (no row)."""
    import torch

    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.xsmm import (FlashTrainBwdKey, build_kernel,
                                         global_cache, reference_kernel)
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(25)
    worst: dict = {}
    errs: dict = {}         # each (a) key's worst abs error
    path, off = [], []      # (kind, key, args)

    def record(kind, key, ab, on_path, args):
        errs[key] = ab
        worst[kind] = max(worst.get(kind, 0.0), ab)
        (path if on_path else off).append((kind, key, args))
    # (a) B13
    for label, key, on_path in _f16a_decode_cases():
        args = _decode_attn_inputs(key, g)
        kern = build_kernel(key)
        got, want = kern(*args), reference_kernel(key)(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        ok = rel <= TOL_F32 and torch_isfinite(got) and \
            got.dtype == torch.float32 and kern.launches == 1 and \
            kern.source.endswith("csrc/decode_attn.cu")
        say(f"f16 kernel decode_attn {label:36s} rel {rel:.3e} abs "
            f"{ab:.3e} tol {TOL_F32:.0e}{_route_note(key)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 decode {label}: rel {rel}, "
                                 f"launches {kern.launches}")
        record("decode_attn", key, ab, on_path, args)
    # (a) B14 and B18
    bf16 = torch.bfloat16
    for label, key, on_path in _f16a_train_cases():
        q, k, v, do = _flash_train_inputs(key, g)
        fwd = build_kernel(key)
        o, lse2 = fwd(q, k, v)
        po, plse2 = reference_kernel(key)(q, k, v)
        bkey = FlashTrainBwdKey(**dataclasses.asdict(key))
        bargs = (q, k, v, do, plse2, _flash_delta(do, po))
        bwd = build_kernel(bkey)
        got, again = bwd(*bargs), bwd(*bargs)
        fed = bwd(q, k, v, do, lse2, _flash_delta(do, o))
        want = reference_kernel(bkey)(*bargs)
        ds = _f16a_max_ds(key, bargs)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rels = {"o": rel_err(o, po), "lse2": rel_err(lse2, plse2)}
        rels.update({n: rel_err(a, b) for n, a, b in
                     zip(("dq", "dk", "dv"), got, want)})
        rels.update({f"fed {n}": rel_err(a, b) for n, a, b in
                     zip(("dq", "dk", "dv"), fed, want)})
        ok = same and ds < F16_MAX and \
            all(torch_isfinite(x) for x in (o, lse2, *got)) and \
            all(x.dtype == bf16 for x in (o, *got)) and \
            (fwd.route, fwd.source[-12:], fwd.launches) == \
            ("wgmma", "attention.cu", 1) and \
            (bwd.route, bwd.source[-14:], bwd.launches) == \
            ("wgmma", "flash_train.cu", 3) and \
            all(r <= (TOL_LSE if n == "lse2" else TOL_F16_TRAIN)
                for n, (r, _) in rels.items())
        say(f"f16 kernel flash_train {label:44s} " + " ".join(
            f"{n} rel {r:.3e}" for n, (r, _) in rels.items())
            + f"; B18 repeat bit-equal {same}; max|dS| {ds:.4g} "
            f"({ds / F16_MAX:.2e} of f16's {F16_MAX:.0f}); tol "
            f"{TOL_F16_TRAIN:.0e} (lse2 {TOL_LSE:.0e}){_route_note(key)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 flash_train {label}: {rels}, "
                                 f"bit-equal {same}, max|dS| {ds}")
        record("flash_train_fwd", key, max(rels["o"][1], rels["lse2"][1]),
               on_path, (q, k, v))
        record("flash_train_bwd", bkey, max(
            rels[n][1] for n in ("dq", "dk", "dv")), on_path, bargs)
    # (b) the probes: the operands are read in f16, P and dS rounded to
    # bf16
    for label, key, probe in _f16_attention_probes():
        args, kw, readings, model, subject = f16_attention_probe(key, probe)
        kern = build_kernel(key)
        got = _outputs(kern(*args, **kw))
        want = _outputs(reference_kernel(key)(*args, **kw))
        torch.cuda.synchronize()
        ok = f16_attention_probe_holds(got, want, readings, model, subject)
        gap = {n: max(rel_err(r[i], want[i])[1] for i in subject)
               for n, r in readings.items()}
        near = max(rel_err(got[i], want[i])[1] for i in subject)
        say(f"f16 probe {label:18s} route {kern.route:6s} |kernel - plain| "
            f"{near:.3e} (limit {ATTN_PROBE_LIMIT:.0e}); readings "
            + ", ".join(f"{n} {d:.3e}" for n, d in gap.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f16 probe {label}: {near}, {gap}")
    # (c) the path, as the decode and training steps call the kernels
    cache = global_cache()
    cache.reset_launches()
    for kind, key, args in path:
        kern = cache.dispatch(key)
        if kind == "decode_attn":
            for li in range(key.stacked):
                kern(*args[:4], li, *args[5:])
        elif kind == "flash_train_fwd":
            o, lse2 = kern(*args)
        else:
            kern(*args[:4], lse2, _flash_delta(args[3], o))
    torch.cuda.synchronize()
    launched = _f16_launches(cache)
    by_kind: dict = {}
    for key, n in launched.items():
        by_kind[_kind(key)] = by_kind.get(_kind(key), 0) + n
    say(f"f16 attention path launches: {by_kind}")
    missing = [describe(key) for _, key, _ in path if not launched.get(key)]
    if missing:
        raise AssertionError(f"f16 kernels of the path never launched: "
                             f"{missing}")
    # (d) each path key timed: kernel-line rows; the rest for PERF.md
    rows = []
    for kind, key, args in path:
        n = launched[key]
        entry = _f16a_times(kind, key, args, f"{n} launches on the path")
        rows.append((kind, key, cache.dispatch(key).source, {
            "launches": n, "max_abs_err": errs[key], **entry}))
    for kind, key, args in off:
        _f16a_times(kind, key, args, "off the path")
    say(f"phase f16 attention: {time.perf_counter() - t0:.1f} s; worst abs "
        f"error by kind {worst}")
    return rows


# ROADMAP A14's last item: keys mixing 16-bit types (f16 products with a
# bf16 output, bf16 or f32 products with an f16 output) on every kernel with
# an out_dtype, each output stored by the kernel's own epilogue in its type
# and C, D, biases and gamma/beta read in theirs. The f16 flagship runs at
# its own depth with its last layer retyped to bf16: under tpp-gen's normal
# init the third layer's outputs pass f16's 65,504 (F16_FLAGSHIP keeps two
# layers for that), and a bf16 output holds them.
F16_MIXED_FLAGSHIP = "--batch=256 --layers=1024,1024,1024,1024 --bias " \
    "--relu --float-type=f16"
F16_MIXED_PACKED = "--batch=256 --layers=1024,1024,1024,1024 " \
    "--tiles=256,512,512 --bias --relu --vnni=2 --float-type=f16"
# the three mixed pairs' probe summands (exact in both 16-bit types): one
# rounding of their f32 sum to the output type differs from a rounding
# through the products' type first (f16 then bf16: 1 + 2^-8 + 2^-12 is 1 +
# 2^-7 in one rounding, 1 + 2^-8 in f16 and then a tie to 1.0; bf16 then
# f16: 1 + 2^-11 + 2^-20 is 1 + 2^-10 in one rounding, 1.0 through bf16);
# the large ones sum to 70,016, 70,144 in bf16 and inf through f16
MIXED_SUMMANDS = {"bf16": (1.0, 2 ** -8, 2 ** -12),
                  "f16": (1.0, 2 ** -11, 2 ** -20)}
MIXED_LARGE = (32768.0, 32768.0, 4480.0)
# the repeat benches (B4, B20, B11: the state held in the products' type
# between repeats and cast at the end, as the JAX bodies cast): summands a
# rounding through the products' type moves, so that their value is the
# JAX body's and not one rounding of the f32 state
MIXED_REPEAT_SUMMANDS = {"bf16": (1.0, 2 ** -9, 2 ** -13),
                         "f16": (1.0, 2 ** -11, 2 ** -20)}


def retype_last_layer(text: str) -> str:
    """tpp-gen's f16 text with its last layer in bf16: the last tl.matmul
    (or tl.blocked_matmul), its accumulator and bias, every value computed
    from it (add, relu, and a packed module's bias reshape and unpack), the
    return and the function's result type. The weights stay f16, so the
    lowering keeps one f16 contraction key with a bf16 result; tpp-gen
    itself has no option for it (neither package's)."""
    lines = text.splitlines()
    last = max(i for i, ln in enumerate(lines)
               if re.search(r"= tl\.(blocked_)?matmul ", ln))
    res, _, acc = re.match(r"\s*%(\w+) = tl\.\w+ %\w+, %(\w+), %(\w+)",
                           lines[last]).groups()
    names = {res, acc}
    for ln in lines[last + 1:]:     # the values computed from the result
        m = re.match(r"\s*%(\w+) = tl\.(\w+) (.*)", ln)
        if m and set(re.findall(r"%(\w+)", m.group(3))) & names:
            names.add(m.group(1))
            if m.group(2) == "add":     # its other operand: the bias
                names.update(re.findall(r"%(\w+)", m.group(3)))
    for ln in lines:                    # a packed bias's reshape source
        m = re.match(r"\s*%(\w+) = tl\.reshape %(\w+)", ln)
        if m and m.group(1) in names:
            names.add(m.group(2))
    out = []
    for ln in lines:
        m = re.match(r"\s*%(\w+) = ", ln)
        if (m and m.group(1) in names) or ln.strip().startswith("return"):
            ln = ln.replace("xf16>", "xbf16>")
        elif ln.strip().startswith("func @"):
            ln = re.sub(r"-> tensor<([\dx]+)xf16>", r"-> tensor<\1xbf16>",
                        ln)
        out.append(ln)
    return "\n".join(out) + "\n"


def _mixed_module(flags: str):
    """tpp-gen <flags> with its last layer retyped (retype_last_layer),
    parsed by the port as tpp_run parses a file."""
    from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser,
                                                   config_from_args,
                                                   generate_text)
    from tpp_mlir_tpu_torch.tools.tpp_run import load_module
    tag = f"mixed {flags}"
    if tag not in _GENERATED:
        _GENERATED[tag] = retype_last_layer(generate_text(config_from_args(
            build_parser().parse_args(flags.split()))))
    return load_module(_GENERATED[tag])


def _mixed_rows():
    """(a): (label, key, forced body or None, the C/D/bias type) for every
    route a mixed key takes, the path's keys at its shapes (the flagship's
    last layer, B3 and B4; the packed twin's, B19 and B20)."""
    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                         BrgemmKey, ChainKey, ConvBrgemmKey,
                                         ConvNhwcKey, FlashMhaKey,
                                         GroupedGemmKey, LayerNormKey)
    fc = dict(beta0=True, binary_kind="add", unary_kind="relu")
    hi = dict(precision="highest")
    flag = (WIDTH,) * LAYERS
    packed = dict(vnni=2, **fc)
    ln = dict(beta0=True, binary_kind="add", prologue="layer_norm")
    conv = dict(N=8, H=30, W=30, C=128, K=128, R=3, S=3)
    flat = dict(batch=16, seq=2048, seq_kv=2048, head_dim=64, scale=0.125)
    return (
        ("B1 fc f16->bf16 +bias+relu (tma)",
         BrgemmKey(1, BATCH, WIDTH, WIDTH, "f16", out_dtype="bf16", **fc),
         None, "bf16"),
        ("B1 bf16->f16 +C +bias (tma)",
         BrgemmKey(1, BATCH, WIDTH, WIDTH, "bf16", out_dtype="f16",
                   binary_kind="add"), None, "f16"),
        ("B1 ragged n f16->bf16 +C (convert)",
         BrgemmKey(1, BATCH, 1004, WIDTH, "f16", out_dtype="bf16"), None,
         "bf16"),
        ("B1 f32->f16 +C (convert)",
         BrgemmKey(1, BATCH, WIDTH, WIDTH, "f32", out_dtype="f16"), None,
         "f32"),
        ("B1 f32 highest->f16 +C (fma)",
         BrgemmKey(1, 128, 512, WIDTH, "f32", out_dtype="f16", **hi), None,
         "bf16"),
        ("B1 k split f16->bf16 +C",
         BrgemmKey(1, 64, 128, 8192, "f16", out_dtype="bf16"), None, "f16"),
        ("B1 out-proj bf16->f16 +C +residual (split 1)",
         BrgemmKey(1, 2048, 768, 768, "bf16", out_dtype="f16",
                   binary_kind="add", binary_bcast="none"), None, "f16"),
        ("B1 ragged n f16->bf16 +C (convert, split 1)",
         BrgemmKey(1, 2048, 1004, 768, "f16", out_dtype="bf16"), None,
         "bf16"),
        ("B2 ln gpt2 fc1 f16->bf16 +bias+gelu",
         BrgemmKey(1, 2048, 3072, 768, "f16", out_dtype="bf16",
                   unary_kind="gelu", **ln), None, "bf16"),
        ("B2 ln_stats_out f16->bf16",
         BrgemmKey(1, 1024, 768, 768, "f16", out_dtype="bf16",
                   ln_stats_out=True, **fc), None, "f16"),
        ("B3 flagship 256 x 1024x4 f16->bf16",
         ChainKey(m=BATCH, dims=flag, dtype="f16", out_dtype="bf16"), None,
         "bf16"),
        ("B3 flagship f16->bf16 wmma",
         ChainKey(m=BATCH, dims=flag, dtype="f16", out_dtype="bf16"),
         "wmma", "bf16"),
        ("B3 flagship bf16->f16",
         ChainKey(m=BATCH, dims=flag, dtype="bf16", out_dtype="f16"), None,
         "f16"),
        ("B3 f32 highest->f16 (fma)",
         ChainKey(m=64, dims=(WIDTH, WIDTH), dtype="f32", out_dtype="f16",
                  **hi), None, "f32"),
        ("B4 flagship f16->bf16 r20",
         ChainKey(m=BATCH, dims=flag, dtype="f16", out_dtype="bf16",
                  repeats=20), None, "bf16"),
        ("B4 bf16->f16 r3",
         ChainKey(m=64, dims=(WIDTH, WIDTH), dtype="bf16", out_dtype="f16",
                  repeats=3), None, "f16"),
        ("B5 fc_128x768x2304 f16->bf16 r3",
         ChainKey(m=128, dims=(768, 2304), dtype="f16", out_dtype="bf16",
                  repeats=3, pingpong=True, unary_kind=None), None, "bf16"),
        ("B19 packed fc f16->bf16 VNNI2",
         BlockedMatmulKey(1, 2, 2, BATCH, 512, 512, "f16", out_dtype="bf16",
                          **packed), None, "bf16"),
        ("B19 packed f16->bf16 +C (tma)",
         BlockedMatmulKey(1, 2, 2, BATCH, 512, 512, "f16", out_dtype="bf16"),
         None, "bf16"),
        ("B19 packed bf16->f16 +C +bias (tma)",
         BlockedMatmulKey(1, 2, 2, BATCH, 512, 512, "bf16", out_dtype="f16",
                          binary_kind="add"), None, "f16"),
        ("B19 packed Mb 8 f16->bf16 VNNI2 (split 1)",
         BlockedMatmulKey(8, 4, 2, BATCH, 256, 512, "f16", out_dtype="bf16",
                          **packed), None, "bf16"),
        ("B19 f32 highest->f16 +C (fma)",
         BlockedMatmulKey(1, 2, 2, 64, 64, 512, "f32", out_dtype="f16", **hi),
         None, "bf16"),
        ("B20 packed fc f16->bf16 VNNI2 r20",
         BlockedMatmulKey(1, 2, 2, BATCH, 512, 512, "f16", out_dtype="bf16",
                          repeats=20, **packed), None, "bf16"),
        ("B20 packed fc f16->bf16 VNNI2 r3 wmma",
         BlockedMatmulKey(1, 2, 2, BATCH, 512, 512, "f16", out_dtype="bf16",
                          repeats=3, **packed), "wmma", "f16"),
        ("B20 f32 highest->f16 r3 (fma)",
         BlockedMatmulKey(1, 2, 2, 64, 256, 256, "f32", out_dtype="f16",
                          repeats=3, **hi, **fc), None, "bf16"),
        ("conv NHWC f16->bf16 +bias+relu (tma)",
         ConvNhwcKey(dtype="f16", out_dtype="bf16", **fc, **conv), None,
         "bf16"),
        ("conv NHWC bf16->f16 same +C +residual",
         ConvNhwcKey(dtype="bf16", out_dtype="f16", pad=(1, 1, 1, 1),
                     binary_kind="add", binary_bcast="none", **conv), None,
         "f16"),
        ("conv NHWC 58^2 bf16->f16 +C (split 1)",
         ConvNhwcKey(N=8, H=58, W=58, C=64, K=64, R=3, S=3, dtype="bf16",
                     out_dtype="f16"), None, "bf16"),
        ("conv NHWC f16->bf16 wmma",
         ConvNhwcKey(dtype="f16", out_dtype="bf16", **fc, **conv), "wmma",
         "f32"),
        ("conv NHWC f32->f16 +C (convert)",
         ConvNhwcKey(dtype="f32", out_dtype="f16", **conv), None, "bf16"),
        ("conv NHWC f32 highest->f16 +C (fma)",
         ConvNhwcKey(N=2, H=10, W=10, C=64, K=64, R=3, S=3, dtype="f32",
                     out_dtype="f16", **hi), None, "f16"),
        ("B23 f16->bf16 Cb 2 +C +bias+relu",
         ConvBrgemmKey(N=8, H=16, W=16, Cb=2, c=128, Kb=2, k=128, R=3, S=3,
                       dtype="f16", out_dtype="bf16", binary_kind="add",
                       unary_kind="relu"), None, "f32"),
        ("B16 f16->bf16 +gelu (wgmma)",
         GroupedGemmKey(n_groups=4, m=1024, n=1024, k=WIDTH, bm=64,
                        dtype="f16", out_dtype="bf16", unary_kind="gelu"),
         None, None),
        ("B16 bf16->f16 (wgmma)",
         GroupedGemmKey(n_groups=4, m=1024, n=1024, k=WIDTH, bm=64,
                        dtype="bf16", out_dtype="f16"), None, None),
        ("B16 f16->bf16 bm 16 (wmma)",
         GroupedGemmKey(n_groups=4, m=256, n=512, k=WIDTH, bm=16,
                        dtype="f16", out_dtype="bf16"), None, None),
        ("B16 f32->f16 (wmma)",
         GroupedGemmKey(n_groups=4, m=256, n=512, k=WIDTH, bm=64,
                        dtype="f32", out_dtype="f16"), None, None),
        ("B12 f16->bf16 (register)",
         LayerNormKey(2048, 768, "f16", out_dtype="bf16"), None, "f16"),
        ("B12 bf16->f16 strided",
         LayerNormKey(2048, 768, "bf16", out_dtype="f16"), "strided", "f32"),
        ("B12 f32->f16 (register)",
         LayerNormKey(2048, WIDTH, "f32", out_dtype="f16"), None, "bf16"),
        ("attn flat f16->bf16 (tma)",
         FlashMhaKey(dtype="f16", out_dtype="bf16", **flat), None, None),
        ("attn flat bf16->f16 causal (tma)",
         FlashMhaKey(dtype="bf16", out_dtype="f16", causal=True, **flat),
         None, None),
        ("attn flat f32->f16 (convert)",
         FlashMhaKey(8, 512, 512, 64, "f32", out_dtype="f16", scale=0.125),
         None, None),
        ("attn flat f32 highest->f16 (fma)",
         FlashMhaKey(4, 256, 256, 64, "f32", out_dtype="f16", scale=0.125,
                     **hi), None, None),
        ("attn gpt2 packed causal f16->bf16 (B7)",
         FlashMhaKey(2, 1024, 1024, 64, "f16", out_dtype="bf16",
                     scale=0.125, causal=True, heads=12, qkv_packed=True),
         None, None),
        ("attn B11 f16->bf16 r3",
         FlashMhaKey(dtype="f16", out_dtype="bf16", repeats=3, **flat),
         None, None),
        ("bmm multi f16->bf16",
         BatchMatmulKey(1024, 32, 32, 64, "f16", out_dtype="bf16",
                        beta0=True), None, None),
        ("bmm multi bf16->f16 softmax_lhs",
         BatchMatmulKey(1024, 32, 64, 32, "bf16", out_dtype="f16",
                        beta0=True, softmax_lhs=True), None, None),
        ("bmm tiled f16->bf16 +C",
         BatchMatmulKey(16, 96, 72, 100, "f16", out_dtype="bf16"), None,
         "f32"),
        ("bmm tiled f32 highest->f16",
         BatchMatmulKey(16, 96, 72, 100, "f32", out_dtype="f16", beta0=True,
                        **hi), None, None))


def _mixed_tol(key) -> float:
    """A mixed key's tolerance against its plain version: TOL_BF16 for a
    bf16 output; for an f16 output TOL_F16 where the function rounds once
    (a single GEMM, conv or LayerNorm: the sum order alone moves it), else
    TOL_BF16 over bf16 products (a chain's layers, attention's Q and P, a
    repeat's state, the LayerNorm prologue's rows rounded to bf16 where a
    sum order can flip one) and TOL_F16_CHAIN over f32 ones."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import ChainKey, FlashMhaKey
    from tpp_mlir_tpu_torch.xsmm.reference import mxu_dtype
    if key.out_dtype == "bf16":
        return TOL_BF16
    inside = isinstance(key, (ChainKey, FlashMhaKey)) or \
        getattr(key, "repeats", 0) or getattr(key, "prologue", None) or \
        getattr(key, "softmax_lhs", False)
    if not inside:
        return TOL_F16
    return TOL_BF16 if mxu_dtype(key.dtype, key.precision) == \
        torch.bfloat16 else TOL_F16_CHAIN


def mixed_inputs(key, cd, g, device="cuda"):
    """(args, kwargs) of a mixed key: operands in the key's dtype
    (activations N(0, 1), weights He-scaled N(0, 2/K) so that a ReLU layer
    and a repeat keep the state's scale; B5's weight over its spectral
    norm; attention's N(0, 1); B12's x N(1, 3^2); a LayerNorm prologue's
    rows N(0.5, 2^2)); C N(0, 1) and D or biases N(0, 0.1) (a chain's last
    bias, LayerNorm's gamma/beta) in `cd`, the chain's other biases in the
    key's dtype; B21's C f32 (its wrapper reads it so)."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                         BrgemmKey, ChainKey, ConvBrgemmKey,
                                         ConvNhwcKey, FlashMhaKey,
                                         GroupedGemmKey, LayerNormKey)
    from tpp_mlir_tpu_torch.xsmm.reference import DTYPES
    dt, cdt = DTYPES[key.dtype], DTYPES[cd or "f32"]

    def rnd(*shape, scale=1.0, shift=0.0, to=dt):
        return (torch.randn(shape, generator=g, device=g.device) * scale +
                shift).to(device=device, dtype=to)
    if isinstance(key, BrgemmKey):
        d_shape = {"bcast_col": (key.n,), "none": (key.m, key.n)}[
            key.binary_bcast]
        kw = dict(gamma=rnd(key.k), beta=rnd(key.k)) if key.prologue else {}
        a = rnd(1, key.m, key.k, scale=2.0, shift=0.5) if key.prologue \
            else rnd(1, key.m, key.k)
        return (a, rnd(1, key.k, key.n, scale=(2 / key.k) ** 0.5),
                None if key.beta0 else rnd(key.m, key.n, to=cdt),
                rnd(*d_shape, scale=0.1, to=cdt) if key.binary_kind
                else None), kw
    if isinstance(key, ChainKey):
        wb = []
        L = len(key.dims) - 1
        for li, (k, n) in enumerate(zip(key.dims[:-1], key.dims[1:])):
            if key.pingpong:
                w = rnd(k, n, to=torch.float32)
                wb.append((w / torch.linalg.matrix_norm(w, ord=2)).to(dt))
            else:
                wb.append(rnd(k, n, scale=(2 / k) ** 0.5))
            if key.has_bias:
                wb.append(rnd(n, scale=0.1, to=cdt if li == L - 1 else dt))
        return (rnd(key.m, key.dims[0]), *wb), {}
    if isinstance(key, BlockedMatmulKey):
        K = key.Kb * key.kb
        b = rnd(key.Nb, key.Kb, key.kb, key.nb, scale=(2 / K) ** 0.5)
        if key.vnni:
            b = b.reshape(key.Nb, key.Kb, key.kb // 2, 2, key.nb) \
                .movedim(-2, -1).contiguous()
        return (rnd(key.Mb, key.Kb, key.mb, key.kb), b,
                None if key.beta0 else
                rnd(key.Mb, key.Nb, key.mb, key.nb, to=cdt),
                rnd(key.Nb, key.nb, scale=0.1, to=cdt) if key.binary_kind
                else None), {}
    if isinstance(key, ConvNhwcKey):
        out = (key.N, key.P, key.Q, key.K)
        d = rnd(*(out if key.binary_bcast == "none" else (key.K,)),
                scale=0.1, to=cdt) if key.binary_kind else None
        return (rnd(key.N, key.H, key.W, key.C),
                rnd(key.R, key.S, key.C, key.K,
                    scale=(key.R * key.S * key.C) ** -0.5),
                None if key.beta0 else rnd(*out, to=cdt), d), {}
    if isinstance(key, ConvBrgemmKey):
        out = (key.N, key.Kb, key.P, key.Q, key.k)
        return (rnd(key.N, key.Cb, key.H, key.W, key.c),
                rnd(key.Kb, key.Cb, key.R, key.S, key.c, key.k,
                    scale=(key.R * key.S * key.Cb * key.c) ** -0.5),
                None if key.beta0 else rnd(*out, to=cdt),
                rnd(key.Kb, key.k, scale=0.1, to=cdt) if key.binary_kind
                else None), {}
    if isinstance(key, GroupedGemmKey):
        nb = key.m // key.bm
        ge = (torch.arange(nb) * key.n_groups // nb).to(device, torch.int32)
        return (ge, rnd(key.m, key.k),
                rnd(key.n_groups, key.k, key.n, scale=key.k ** -0.5)), {}
    if isinstance(key, LayerNormKey):
        return (rnd(key.m, key.n, scale=3.0, shift=1.0), rnd(key.n, to=cdt),
                rnd(key.n, to=cdt)), {}
    if isinstance(key, FlashMhaKey):
        E = (key.heads or 1) * key.head_dim
        if key.qkv_packed:
            x = rnd(key.batch, key.seq, 3 * E)
            return (x, x, x), {}
        return tuple(rnd(key.batch, s, E) for s in
                     (key.seq, key.seq_kv, key.seq_kv)), {}
    assert isinstance(key, BatchMatmulKey)
    a = rnd(*((key.m, key.k) if key.lhs_shared
              else (key.batch, key.m, key.k)), scale=2.0)
    return (a, rnd(key.batch, key.k, key.n),
            None if key.beta0 else rnd(key.batch, key.m, key.n,
                                       to=torch.float32)), {}


def mixed_probes():
    """(b): (label, key, forced, summands) for each route of a mixed key:
    a single GEMM, conv, B12, attention and the batched matmul store one
    rounding of an exact f32 sum (MIXED_SUMMANDS, MIXED_LARGE); B4, B5,
    B20 and B11 the JAX body's rounding through the products' type
    (MIXED_REPEAT_SUMMANDS). Shapes are small; K is 1024 where the sum
    runs over a K."""
    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                         BrgemmKey, ChainKey, ConvBrgemmKey,
                                         ConvNhwcKey, FlashMhaKey,
                                         GroupedGemmKey, LayerNormKey)
    one = dict(has_bias=False, unary_kind=None, last_unary=None)
    hi = dict(precision="highest")
    s16, s32 = MIXED_SUMMANDS["bf16"], MIXED_SUMMANDS["f16"]
    r16, r32 = MIXED_REPEAT_SUMMANDS["bf16"], MIXED_REPEAT_SUMMANDS["f16"]
    conv = dict(N=2, H=10, W=10, C=64, K=64, R=3, S=3, pad=(1, 1, 1, 1))
    attn = dict(batch=4, seq=256, seq_kv=256, head_dim=64)
    return (
        ("B1 tma f16->bf16", BrgemmKey(1, 64, 64, WIDTH, "f16",
                                       out_dtype="bf16", beta0=True),
         None, s16),
        ("B1 tma f16->bf16 70016", BrgemmKey(1, 64, 64, WIDTH, "f16",
                                             out_dtype="bf16", beta0=True),
         None, MIXED_LARGE),
        ("B1 tma bf16->f16", BrgemmKey(1, 64, 64, WIDTH, "bf16",
                                       out_dtype="f16", beta0=True),
         None, s32),
        ("B1 convert f32->f16", BrgemmKey(1, 64, 36, WIDTH, "f32",
                                          out_dtype="f16", beta0=True),
         None, s32),
        ("B1 fma f32 highest->f16", BrgemmKey(1, 64, 64, WIDTH, "f32",
                                              out_dtype="f16", beta0=True,
                                              **hi), None, s32),
        ("B1 k split f16->bf16", BrgemmKey(1, 64, 128, 8192, "f16",
                                           out_dtype="bf16", beta0=True),
         None, s16),
        ("B1 split 1 bf16->f16", BrgemmKey(1, 2048, 768, WIDTH, "bf16",
                                           out_dtype="f16", beta0=True),
         None, s32),
        ("B2 ln f16->bf16", BrgemmKey(1, 64, 64, WIDTH, "f16",
                                      out_dtype="bf16", beta0=True,
                                      prologue="layer_norm",
                                      prologue_eps=0.0), None, s16),
        ("B3 panel f16->bf16", ChainKey(m=64, dims=(WIDTH, 64), dtype="f16",
                                        out_dtype="bf16", **one), None, s16),
        ("B3 panel f16->bf16 70016", ChainKey(m=64, dims=(WIDTH, 64),
                                              dtype="f16", out_dtype="bf16",
                                              **one), None, MIXED_LARGE),
        ("B3 wmma bf16->f16", ChainKey(m=64, dims=(WIDTH, 64), dtype="bf16",
                                       out_dtype="f16", **one), "wmma", s32),
        ("B3 fma f32 highest->f16", ChainKey(m=64, dims=(WIDTH, 64),
                                             dtype="f32", out_dtype="f16",
                                             **one, **hi), None, s32),
        ("B4 panel f16->bf16 r2", ChainKey(m=64, dims=(WIDTH, WIDTH),
                                           dtype="f16", out_dtype="bf16",
                                           repeats=2, **one), None, r16),
        ("B4 panel bf16->f16 r2", ChainKey(m=64, dims=(WIDTH, WIDTH),
                                           dtype="bf16", out_dtype="f16",
                                           repeats=2, **one), None, r32),
        ("B5 panel f16->bf16 r3", ChainKey(m=64, dims=(WIDTH, 256),
                                           dtype="f16", out_dtype="bf16",
                                           repeats=3, pingpong=True, **one),
         None, r16),
        ("B19 tma f16->bf16", BlockedMatmulKey(1, 1, 2, 64, 64, 512, "f16",
                                               out_dtype="bf16",
                                               beta0=True), None, s16),
        ("B19 convert VNNI2 f16->bf16 70016",
         BlockedMatmulKey(1, 1, 2, 64, 64, 512, "f16", out_dtype="bf16",
                          vnni=2, beta0=True), None, MIXED_LARGE),
        ("B19 tma bf16->f16", BlockedMatmulKey(1, 1, 2, 64, 64, 512, "bf16",
                                               out_dtype="f16", beta0=True),
         None, s32),
        ("B19 fma f32 highest->f16", BlockedMatmulKey(
            1, 1, 2, 64, 64, 512, "f32", out_dtype="f16", beta0=True, **hi),
         None, s32),
        ("B20 panel f16->bf16 r1", BlockedMatmulKey(
            1, 2, 2, 64, 512, 512, "f16", out_dtype="bf16", vnni=2,
            repeats=1, beta0=True), None, r16),
        ("B20 wmma bf16->f16 r1", BlockedMatmulKey(
            1, 2, 2, 64, 512, 512, "bf16", out_dtype="f16", repeats=1,
            beta0=True), "wmma", r32),
        ("conv tma f16->bf16", ConvNhwcKey(dtype="f16", out_dtype="bf16",
                                           beta0=True, **conv), None, s16),
        ("conv tma bf16->f16", ConvNhwcKey(dtype="bf16", out_dtype="f16",
                                           beta0=True, **conv), None, s32),
        ("conv wmma f16->bf16", ConvNhwcKey(dtype="f16", out_dtype="bf16",
                                            beta0=True, **conv), "wmma",
         s16),
        ("conv convert f32->f16", ConvNhwcKey(dtype="f32", out_dtype="f16",
                                              beta0=True, **conv), None,
         s32),
        ("B23 f16->bf16", ConvBrgemmKey(N=2, H=10, W=10, Cb=2, c=64, Kb=1,
                                        k=64, R=3, S=3, dtype="f16",
                                        out_dtype="bf16", beta0=True), None,
         s16),
        ("B16 wgmma f16->bf16", GroupedGemmKey(
            n_groups=2, m=128, n=128, k=WIDTH, bm=64, dtype="f16",
            out_dtype="bf16"), None, s16),
        ("B16 wmma bm 16 bf16->f16", GroupedGemmKey(
            n_groups=2, m=128, n=128, k=WIDTH, bm=16, dtype="bf16",
            out_dtype="f16"), None, s32),
        ("B12 register f16->bf16", LayerNormKey(64, WIDTH, "f16",
                                                out_dtype="bf16", eps=0.0),
         None, s16),
        ("B12 strided bf16->f16", LayerNormKey(64, WIDTH, "bf16",
                                               out_dtype="f16", eps=0.0),
         "strided", s32),
        ("attn flat tma f16->bf16", FlashMhaKey(dtype="f16",
                                                out_dtype="bf16", **attn),
         None, s16),
        ("attn flat tma bf16->f16", FlashMhaKey(dtype="bf16",
                                                out_dtype="f16", **attn),
         None, s32),
        ("attn flat convert f32->f16", FlashMhaKey(dtype="f32",
                                                   out_dtype="f16", **attn),
         None, s32),
        ("attn token packed f16->bf16", FlashMhaKey(
            2, 256, 256, 64, "f16", out_dtype="bf16", heads=2,
            qkv_packed=True, strategy="tokens"), None, s16),
        ("attn B11 f16->bf16 r2", FlashMhaKey(dtype="f16", out_dtype="bf16",
                                              repeats=2, **attn), None, r16),
        ("bmm multi f16->bf16", BatchMatmulKey(64, 32, 32, 64, "f16",
                                               out_dtype="bf16",
                                               beta0=True), None, s16),
        ("bmm tiled bf16->f16", BatchMatmulKey(8, 96, 64, 64, "bf16",
                                               out_dtype="f16", beta0=True),
         None, s32))


def mixed_probe(key, summands, device="cuda"):
    """A probe's inputs and its exact f32 value (None where the value is a
    repeat bench's, rounded through the products' type: B4, B5, B20 and
    B11). Every output element of a GEMM, chain layer, conv, grouped or
    batched GEMM is the f32 sum a + b + c: A's rows (an image's pixels)
    hold (a, b, c, 0, ...), B (the centre tap of W) ones. B2: A's rows
    alternate +1 and -1 (mean 0, variance 1, eps 0: the normalized rows
    are themselves), gamma 1, beta 0, B's rows 0, 2 and 4 (a +1 column of
    A) hold a, b and c. B12: rows alternating +1 and -1, beta b + c: the +1
    places read a + b + c. Attention: Q and K zero, so P is 1 everywhere
    and l is seq_kv, and V's rows 0, 1 and 2 hold seq_kv (a, b, c): the
    output is a + b + c. B4: W is the identity with rows 1 and 2 also
    added into column 0, so two repeats give a + 2 b + 2 c in column 0, the
    state rounded to the products' type between and after them. B5: W's
    column 0 sums rows 0-2. B20 at repeats 1: one product, its state in
    the products' type, then the output's."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                         BrgemmKey, ChainKey, ConvBrgemmKey,
                                         ConvNhwcKey, FlashMhaKey,
                                         GroupedGemmKey, LayerNormKey)
    from tpp_mlir_tpu_torch.xsmm.reference import DTYPES
    dt = DTYPES[key.dtype]
    a, b, c = summands
    total = torch.tensor(a, dtype=torch.float32) + b + c     # exact

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def rows(*shape):       # (a, b, c, 0, ...) along the last dim
        x = zeros(*shape)
        x[..., 0], x[..., 1], x[..., 2] = a, b, c
        return x

    def full(*shape):
        return torch.full(shape, total.item(), device=device)
    if isinstance(key, BrgemmKey) and key.prologue:
        x = ones(1, key.m, key.k)
        x[..., 1::2] = -1.0
        w = zeros(1, key.k, key.n)
        w[0, 0], w[0, 2], w[0, 4] = a, b, c
        return (x, w, None, None, ones(key.k), zeros(key.k)), {}, \
            full(key.m, key.n)
    if isinstance(key, BrgemmKey):
        return (rows(1, key.m, key.k), ones(1, key.k, key.n)), {}, \
            full(key.m, key.n)
    if isinstance(key, ChainKey):
        K, N = key.dims
        x = rows(key.m, K)
        if key.pingpong:
            w = zeros(K, N)
            w[:3, 0] = 1.0
            return (x, w), {}, None
        if key.repeats > 1:
            w = torch.eye(K, N, dtype=dt, device=device)
            w[1:3, 0] = 1.0
            return (x, w), {}, None
        return (x, ones(K, N)), {}, full(key.m, N)
    if isinstance(key, BlockedMatmulKey):
        x = zeros(key.Mb, key.Kb, key.mb, key.kb)
        x[:, 0, :, :3] = rows(3)
        w = ones(*((key.Nb, key.Kb, key.kb // 2, key.nb, 2) if key.vnni
                   else (key.Nb, key.Kb, key.kb, key.nb)))
        return (x, w), {}, None if key.repeats else \
            full(key.Mb, key.Nb, key.mb, key.nb)
    if isinstance(key, ConvNhwcKey):
        w = zeros(key.R, key.S, key.C, key.K)
        w[key.R // 2, key.S // 2] = 1.0
        return (rows(key.N, key.H, key.W, key.C), w), {}, \
            full(key.N, key.P, key.Q, key.K)
    if isinstance(key, ConvBrgemmKey):
        x = zeros(key.N, key.Cb, key.H, key.W, key.c)
        x[:, 0] = rows(key.N, key.H, key.W, key.c)
        w = zeros(key.Kb, key.Cb, key.R, key.S, key.c, key.k)
        w[:, 0, key.R // 2, key.S // 2] = 1.0
        return (x, w), {}, full(key.N, key.Kb, key.P, key.Q, key.k)
    if isinstance(key, GroupedGemmKey):
        nb = key.m // key.bm
        ge = (torch.arange(nb) * key.n_groups // nb).to(device, torch.int32)
        return (ge, rows(key.m, key.k), ones(key.n_groups, key.k, key.n)), \
            {}, full(key.m, key.n)
    if isinstance(key, LayerNormKey):
        x = ones(key.m, key.n)
        x[:, 1::2] = -1.0
        beta = torch.full((key.n,), b, device=device) + c
        return (x, torch.ones(key.n, device=device), beta), {}, \
            x.float() + beta
    if isinstance(key, FlashMhaKey):
        E, Skv = (key.heads or 1) * key.head_dim, key.seq_kv
        q = zeros(key.batch, key.seq, E)
        v = zeros(key.batch, Skv, E)
        v[:, 0], v[:, 1], v[:, 2] = Skv * a, Skv * b, Skv * c
        args = (torch.cat((q, q, v), -1),) * 3 if key.qkv_packed else \
            (q, zeros(key.batch, Skv, E), v)
        return args, {}, None if key.repeats else full(key.batch, key.seq,
                                                        E)
    assert isinstance(key, BatchMatmulKey)
    return (rows(key.batch, key.m, key.k), ones(key.batch, key.k, key.n)), \
        {}, full(key.batch, key.m, key.n)


def mixed_probe_holds(got, want, exact) -> bool:
    """Whether a probe's output is bit-equal to its plain version's and,
    where the function rounds once, to the exact f32 value rounded once to
    the output type (finite: the large sum's 70,144 in bf16)."""
    import torch
    if not torch.equal(got, want):
        return False
    if exact is None:
        return True
    return torch.equal(got, exact.to(got.dtype)) and \
        bool(torch.isfinite(got.float()).all())


def _through_products(key, exact):
    """The exact value rounded to the products' type first, then to the
    output's: what a kernel rounding through its products' type would
    store (the probe must tell it from one rounding where that type is
    16-bit)."""
    from tpp_mlir_tpu_torch.xsmm.reference import DTYPES, mxu_dtype
    return exact.to(mxu_dtype(key.dtype, key.precision)).to(
        DTYPES[key.out_dtype])


def _mixed_launches(cache) -> dict:
    """Each kind's launches of the cache since its last reset."""
    out: dict = {}
    for fn in cache.kernels():
        if fn.launches:
            out[_kind(fn.key)] = out.get(_kind(fn.key), 0) + fn.launches
    return out


def _mixed_copies(fn) -> int:
    """aten::_to_copy events of one call of fn under torch.profiler: a
    dtype conversion on the path shows here (a packed module's layout
    copies are not conversions)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::_to_copy")


def phase_f16_mixed() -> list:
    """ROADMAP A14's last item on the card: (a) every mixed key
    (_mixed_rows) against its plain version at _mixed_tol; (b) the
    rounding probes (mixed_probes): bit-equal to the plain version, one
    rounding of the exact f32 sum where the JAX body casts once (told from
    a rounding through the products' type), the JAX body's rounding
    through that type at B4, B5, B20 and B11, 70,016 stored finite in
    bf16; (c) the f16 flagship at its own depth (256 x 1024x4) with a bf16
    last layer, flat (B3; -n 100: B4) and packed (B19; the packed fc's -n
    100: B20), through run_module against --linalg-to-loops, finite above
    f16's 65,504, launches counted beside the single-type twins' (tpp-gen's
    text as it is) and the forwards free of conversion kernels; (d) the
    path's mixed keys timed beside their f16 twins from CUDA graphs in
    turns: kernel-line rows."""
    import torch

    from tpp_mlir_tpu_torch.runtime import compile as tpp_compile
    from tpp_mlir_tpu_torch.tools.trace import describe
    from tpp_mlir_tpu_torch.tools.tpp_run import init_args, run_module
    from tpp_mlir_tpu_torch.xsmm import global_cache, reference_kernel
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(26)
    errs: dict = {}
    # (a) each mixed key against its plain version
    for label, key, forced, cd in _mixed_rows():
        args, kw = mixed_inputs(key, cd, g)
        kern = f16_probe_kernel(key, forced)
        got = _outputs(kern(*args, **kw))
        want = _outputs(reference_kernel(key)(*args, **kw))
        torch.cuda.synchronize()
        tol = _mixed_tol(key)
        rel, ab = max(rel_err(x, y) for x, y in zip(got, want))
        ok = rel <= tol and all(torch_isfinite(x) for x in got) and \
            got[0].dtype == want[0].dtype == \
            getattr(torch, {"bf16": "bfloat16", "f16": "float16"}[
                key.out_dtype]) and kern.launches == 1
        errs[key] = ab
        say(f"mixed kernel {_kind(key):19s} {label:40s} rel {rel:.3e} abs "
            f"{ab:.3e} tol {tol:.0e} C/D {cd or '-'} route {kern.route}"
            f"{_route_note(key)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mixed {label}: rel {rel} > {tol}, "
                                 f"launches {kern.launches}")
        # beside its single-type twin (out_dtype the products' own, the
        # same inputs), from CUDA graphs in turns: for PERF.md
        twin = f16_probe_kernel(dataclasses.replace(key, out_dtype=None),
                                forced)
        t1, m1, m2, t2 = (graph_ms(lambda k=k: k(*args, **kw), iters=10)
                          for k in (twin, kern, kern, twin))
        say(f"time mixed {label:40s} {(m1 + m2) / 2:.4f} ms, single-type "
            f"twin {(t1 + t2) / 2:.4f} ms (mixed/twin "
            f"{(m1 + m2) / (t1 + t2):.3f}), from CUDA graphs in turns")
    # (b) the rounding probes
    for label, key, forced, summands in mixed_probes():
        args, kw, exact = mixed_probe(key, summands)
        kern = f16_probe_kernel(key, forced)
        got = kern(*args, **kw)
        want = reference_kernel(key)(*args, **kw)
        torch.cuda.synchronize()
        ok = mixed_probe_holds(got, want, exact)
        if exact is None:
            note = "the plain version's rounding through the products' type"
        else:
            one, via = exact.to(got.dtype), _through_products(key, exact)
            apart = not torch.equal(one.float(), via.float())
            note = (f"one rounding {one.flatten()[0].item()!r}, through the "
                    f"products' type {via.flatten()[0].item()!r}"
                    f"{'' if apart else ' (the same: f32 products)'}")
            ok = ok and (apart or key.precision == "highest")
        say(f"mixed probe {label:36s} route {kern.route or '-':8s} output "
            f"{got.flatten()[0].item()!r} (plain "
            f"{want.flatten()[0].item()!r}; {note}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mixed probe {label}: "
                                 f"{got.flatten()[:4]} vs "
                                 f"{want.flatten()[:4]}")
    # (c) the flagship at its own depth, flat and packed, beside its twins
    cache = global_cache()
    runs = (("flat", F16_MIXED_FLAGSHIP, "default-tpp-passes",
             ["xsmm.fused_chain"], F16_MIXED_FLAGSHIP, "B4"),
            ("packed", F16_MIXED_PACKED, PACKED, ["xsmm.fused_brgemm"] * 3,
             F16_PACKED_FC, "B20"))
    path: dict = {}
    for label, flags, pipeline, invokes, bench_flags, bench in runs:
        counts = {}
        for form, make in (("mixed", _mixed_module), ("twin", _module)):
            cache.reset_launches()
            res = run_module(make(flags), device="cuda", pipeline=pipeline,
                             out_stream=sys.stderr)
            ops = [op.opname for op in res["module"]["entry"].ops
                   if op.opname.startswith("xsmm.")
                   and not op.opname.endswith("_dispatch")]
            if ops != invokes:
                raise AssertionError(f"mixed {label} {form}: lowered to "
                                     f"{ops}")
            got = res["outputs"][0]
            if form == "mixed":
                ref = run_module(make(flags), device="cuda",
                                 linalg_to_loops=True,
                                 out_stream=sys.stderr)["outputs"][0]
                rel, ab = rel_err(got, ref)
                top = got.float().abs().max().item()
                ok = got.dtype == torch.bfloat16 and torch_isfinite(got) \
                    and top > F16_MAX and rel <= TOL_BF16
                say(f"mixed main {label} 256 x 1024x4 f16, bf16 last layer "
                    f"-> {ops} {tuple(got.shape)} {got.dtype}: finite "
                    f"{torch_isfinite(got)}, max {top:.6g} (f16's "
                    f"{F16_MAX:.0f}), vs --linalg-to-loops rel {rel:.3e} "
                    f"abs {ab:.3e} tol {TOL_BF16:.0e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"mixed {label}: rel {rel}, max "
                                         f"{top}")
            nres = run_module((_mixed_module if form == "mixed"
                               else _module)(bench_flags), n=F16_N,
                              device="cuda", pipeline=pipeline,
                              out_stream=sys.stderr)
            if bench not in str(nres["bench"]):
                raise AssertionError(f"mixed {label} {form}: bench "
                                     f"{nres['bench']}, expected {bench}")
            say(f"mixed main {label} {form} -n {F16_N}: bench "
                f"{nres['bench']!r}, {nres['gflops']:.1f} GFLOP/s "
                f"({nres['mean_seconds'] * 1e3:.4f} ms an iteration)")
            counts[form] = _mixed_launches(cache)
            if form == "mixed":
                for fn in cache.kernels():
                    if fn.launches and fn.key.out_dtype == "bf16":
                        path[fn.key] = fn.launches
            # the compiled forward, profiled: no conversion kernel
            module = run_module(make(flags), device="cuda",
                                pipeline=pipeline,
                                out_stream=sys.stderr)["module"]
            f = tpp_compile(module, "entry", "cuda")
            x = init_args(module, "entry", "normal", 0, "cuda")
            copies = _mixed_copies(lambda: f(*x))
            say(f"mixed main {label} {form}: dtype conversions in a "
                f"forward (aten::_to_copy) {copies}")
            if copies:
                raise AssertionError(f"mixed {label} {form}: {copies} "
                                     f"conversions on the path")
        say(f"mixed main {label} launches {counts['mixed']} (single-type "
            f"twin {counts['twin']})")
        if counts["mixed"] != counts["twin"]:
            raise AssertionError(f"mixed {label}: launches "
                                 f"{counts['mixed']} != twin's "
                                 f"{counts['twin']}")
    # (d) the path's mixed keys timed beside their f16 twins, in turns
    rows = []
    for key, n in path.items():
        kind = _kind(key)
        args, _ = mixed_inputs(key, "bf16", g)
        kern, plain = cache.dispatch(key), reference_kernel(key)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        tol = _mixed_tol(key)
        if getattr(key, "repeats", 0) > 1:
            # as phase_f16 holds its repeat keys: at -n 100 two sum orders
            # part further than at (a)'s 20 repeats
            host = plain(*(a.cpu() if a is not None else None
                           for a in args))
            tol = max(tol, 2 * rel_err(host, want.cpu())[0])
        ok = rel <= tol and torch_isfinite(got)
        say(f"mixed kernel {kind:19s} {describe(key)} -> bf16 (main path) "
            f"rel {rel:.3e} abs {ab:.3e} tol {tol:.3e}{_route_note(key)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mixed {describe(key)}: rel {rel}")
        twin = dataclasses.replace(key, out_dtype=None)
        targs = tuple(a.to(torch.float16) if a is not None and
                      a.dtype == torch.bfloat16 else a for a in args)
        tk = cache.dispatch(twin)
        iters = 2 if getattr(key, "repeats", 0) > 8 else 20
        t1, m1, m2, t2 = (graph_ms(fn, iters=iters) for fn in (
            lambda: tk(*targs), lambda: kern(*args), lambda: kern(*args),
            lambda: tk(*targs)))
        ms, twin_ms = (m1 + m2) / 2, (t1 + t2) / 2
        plain_ms = cuda_ms(lambda: plain(*args))
        library = _library_call(kind, key, args)
        lib_ms = cuda_ms(library) if library else None
        bound, by = _bound(kind, key, args)
        say(f"time kernel mixed {describe(key):44s} -> bf16 from CUDA "
            f"graphs in turns with its f16 twin: {ms:.4f} ms, twin "
            f"{twin_ms:.4f} ms (mixed/twin {ms / twin_ms:.3f}); plain "
            f"version {plain_ms:.4f} ms, library call "
            f"{f'{lib_ms:.4f} ms' if lib_ms else 'none'}, bound "
            f"{bound:.4f} ms ({by}); {n} launches on the mixed path; route "
            f"{kern.route}")
        rows.append((kind, key, kern.source, {
            "launches": n, "max_abs_err": ab, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "f16_twin_graph_ms": twin_ms}))
    say(f"phase f16 mixed: {time.perf_counter() - t0:.1f} s")
    return rows


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


# phase_f16_transformer's GPT-2 and encoder rows: the same op counts in f16
F16_TRANSFORMERS = (
    ("gpt2_small_s1024_f16", F16_GPT2, TRANSFORMERS[0][2],
     ("attention", "layer_norm", "brgemm")),
    ("transformer_block_d128_f16", F16_ENCODER, TRANSFORMERS[1][2],
     ("attention", "brgemm")))


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
    # the WMMA tile's 8-row form (one warp, 8 x 32 x 16 fragments): the
    # serving fuzzer's moe_group_bm 8, in bf16 and in f32 as it serves
    ("small bm 8 x768 n768 k256", 1000, 8, 768, 256, _B16, False),
    ("small bm 8 f32 gelu x3072 k768", 1000, 8, 3072, 768,
     dict(dtype="f32", out_dtype="f32", unary_kind="gelu"), False),
    ("small bm 8 f32 highest tb skewed", 1000, 8, 768, 3072,
     dict(dtype="f32", precision="highest", out_dtype="f32",
          transpose_b=True), True),
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
    padded slot order as the engine makes xs, weights ~ N(0, 1/k), in the
    key's dtype (bf16, or f16)."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import GroupedGemmKey
    from tpp_mlir_tpu_torch.xsmm.reference import DTYPES
    d = _moe_routing(g, T, 8, bm, skew)
    key = GroupedGemmKey(n_groups=8, m=d["A_pad"], n=n, k=k, bm=bm,
                         **fields)
    dt = DTYPES[key.dtype]
    h = torch.randn(T, k, generator=g, device="cuda").to(dt)
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    shape = (n, k) if key.transpose_b else (k, n)
    lead = (key.layers,) if key.layers else ()
    w = (torch.randn(*lead, 8, *shape, generator=g, device="cuda")
         * k ** -0.5).to(dt)
    args = ((1,) if key.layers else ()) + (d["ge"], xs, w)
    return key, args, d["tt"] == T


def _grouped_wgrad_inputs(g, T, bm, k, n, skew, contiguous=False,
                          dtype="bf16"):
    """(key, args, experts no token chose): xt the transpose of the
    (A_pad, k) slot rows, read in place as the training backward passes
    it (or, `contiguous`, a contiguous copy), and dY with zero padding
    rows, in `dtype` (bf16, or f16)."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import GroupedWgradKey
    from tpp_mlir_tpu_torch.xsmm.reference import DTYPES
    d = _moe_routing(g, T, 8, bm, skew)
    key = GroupedWgradKey(n_groups=8, m=d["A_pad"], k=k, n=n, bm=bm,
                          dtype=dtype)
    h = torch.randn(T, k, generator=g, device="cuda").to(DTYPES[dtype])
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    dy = torch.randn(d["A_pad"], n, generator=g, device="cuda")
    live = d["tt"] < T
    dy = (dy * live[:, None]).to(DTYPES[dtype])
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


def _out_size(key) -> int:
    """Bytes of one output element of a key: its out_dtype's, else its
    dtype's."""
    return 4 if (key.out_dtype or key.dtype) == "f32" else 2


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

    def mxu_rate(key):      # the products' peak: f32, bf16 or f16
        return {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}[mxu_dtype(key.dtype, key.precision)]
    if kind == "brgemm":
        a, b, c, d = args[:4]
        rate = mxu_rate(key)
        flops = 2 * key.batch * key.m * key.n * key.k
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(a, b, c, d, *args[4:]) + key.m * key.n * size
    elif kind == "chain":
        x, *wb = args
        dims = key.dims
        rate = mxu_rate(key)
        # B4 runs the chain `repeats` times in the launch
        flops = 2 * key.m * sum(k * n for k, n in zip(dims[:-1], dims[1:])) \
            * max(1, key.repeats)
        nbytes = _nbytes(x, *wb) + key.m * dims[-1] * _out_size(key)
    elif kind in ("attention", "attention_flat", "attention_bench"):
        q = args[0]
        B, S, H, D = key.batch, key.seq, key.heads or 1, key.head_dim
        pairs = S * (S + 1) // 2 if key.causal else S * key.seq_kv
        rate = mxu_rate(key)
        flops = 4 * B * H * pairs * D * max(1, key.repeats)
        nbytes = _nbytes(q) * (1 if key.qkv_packed else 3) + \
            B * S * H * D * _out_size(key)
    elif kind == "layer_norm":
        x, gamma, beta = args
        rate, flops = "f32", 8 * key.m * key.n
        nbytes = _nbytes(x, gamma, beta) + key.m * key.n * _out_size(key)
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
        rate = mxu_rate(key)
        flops = 2 * key.batch * key.m * key.n * key.k
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(a, b, c) + key.batch * key.m * key.n * size
    elif kind == "chain_pingpong":     # R contractions of m x k x n
        x, w, bias = args
        rate = mxu_rate(key)
        flops = key.repeats * 2 * key.m * key.dims[0] * key.dims[1]
        nbytes = _nbytes(x, w, bias) + key.m * key.dims[1] * _out_size(key)
    elif kind == "grouped_gemm":
        # this routing's token rows (padding rows need no work) and the
        # weights of the experts it chose; every output row is written
        ge, a, b = args[-3:]
        rows = int((a != 0).any(-1).sum())
        experts = int(torch.unique(ge).numel())
        rate = mxu_rate(key)
        flops = 2 * rows * key.n * key.k
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = (rows * key.k + experts * key.k * key.n) * a.element_size() \
            + key.m * key.n * size + _nbytes(ge)
    elif kind == "conv_nhwc":     # each tap's products; I, W, C, D, out
        rate = mxu_rate(key)
        flops = 2 * key.N * key.P * key.Q * key.K * key.C * key.R * key.S
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(*args) + key.N * key.P * key.Q * key.K * size
    elif kind in ("blocked_matmul", "blocked_matmul_warm"):
        # the packed GEMM (repeats times for B20); A, B, C, bias, out
        rate = mxu_rate(key)
        flops = 2 * key.Mb * key.Nb * key.Kb * key.mb * key.nb * key.kb * \
            max(1, key.repeats)
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(*args) + key.Mb * key.Nb * key.mb * key.nb * size
    elif kind == "conv_blocked":    # each tap's products; I, W, C, D, out
        rate = mxu_rate(key)
        flops = 2 * key.N * key.P * key.Q * key.Kb * key.k * key.Cb * \
            key.c * key.R * key.S
        size = 4 if (key.out_dtype or key.dtype) == "f32" else 2
        nbytes = _nbytes(*args) + \
            key.N * key.Kb * key.P * key.Q * key.k * size
    else:   # grouped_wgrad: the token rows of xt and dY, f32 dW
        ge, xt, dy = args
        rows = int((dy != 0).any(-1).sum())
        rate = mxu_rate(key)
        flops = 2 * rows * key.k * key.n
        nbytes = rows * (key.k + key.n) * dy.element_size() + _nbytes(ge) \
            + key.n_groups * key.k * key.n * 4
    t_ops, t_bytes = flops / PEAK[rate], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes \
        else "bytes"


def _composed_chain(key, args):
    """The composed PyTorch chain of a chain.cu or B20 key on copies of its
    inputs in its products' type (bf16, or f16 for an f16 key), as one
    callable: torch.addmm + torch.relu per layer and repeat (B5: addmm +
    relu, then h @ W^T; B20 on the unpacked operands). A yardstick, not one
    call; used nowhere in the port."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import ChainKey
    bf = torch.float16 if key.dtype == "f16" else torch.bfloat16
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
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}[kp.dtype]

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
    products at the bf16 rate (f16 products, phase_f16_transformer's, at
    the f16 rate)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for dtype, precision, n in LN_STATS_CASES[:2]:
        out.setdefault("brgemm_ln_stats", _ln_stats_times(dtype, precision,
                                                          n, g))
    return out


def _ln_stats_times(dtype: str, precision: str, n: int, g) -> dict:
    """The pair at one key, timed as phase_ln_stats_timing says, printed
    on one line. Returns the kernel line's timing keys."""
    from tpp_mlir_tpu_torch.xsmm import build_kernel, reference_kernel
    kp, kc = _ln_stats_keys(dtype, precision, n)
    pa, ca = _ln_stats_inputs(kp, kc, g)
    prod, cons = build_kernel(kp), build_kernel(kc)
    pprod, pcons = reference_kernel(kp), reference_kernel(kc)
    ms = graph_ms(lambda: _ln_stats_pair(prod, cons, pa, ca))
    plain_ms = graph_ms(lambda: _ln_stats_pair(pprod, pcons, pa, ca))
    comp_ms = graph_ms(_ln_stats_composed(kp, kc, pa, ca))
    y, mu, var, z = _ln_stats_pair(prod, cons, pa, ca)
    nbytes = _nbytes(*pa, *ca, mu, var, z) + 2 * _nbytes(y)
    flops = 2 * kp.m * kp.n * kp.k + 2 * kc.m * kc.n * kc.k
    peak = PEAK["f16" if dtype == "f16" else "bf16"]
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    bound, by = max((b_bytes, "bytes"), (b_ops, "operations"))
    bound *= 1e3
    p_ms = graph_ms(lambda: prod(*pa))
    say(f"time kernel brgemm_ln_stats pair {dtype} {precision} "
        f"{LN_STATS_M}x{n}x{LN_STATS_K} -> {LN_STATS_M}x{LN_STATS_K}x"
        f"{n}: {ms:.4f} ms (the producer alone {p_ms:.4f} ms), plain "
        f"versions {plain_ms:.4f} ms, composed addmm + gelu -> "
        f"F.layer_norm -> addmm (not one call) {comp_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}) (from CUDA graphs)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


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



# ---------------------------------------------------------------------------
# ROADMAP queue A's parity items: the libxsmm-shaped dispatch API, A6's
# pass-fusion programs and A7's serving config-space fuzz

def phase_dispatch_api() -> dict:
    """Each dispatch function of xsmm/cache.py once on CUDA tensors, against
    reference_kernel(key) on the same inputs at phase_kernels' tolerance for
    the key (_tol): gemm_dispatch f32 with and without transpose_b,
    brgemm_dispatch batch 4 bf16, fused_brgemm_dispatch bias+relu (B1);
    then the other keys the JAX package's dispatch functions take, through
    the cache's dispatch(key): phase_packed_kernels' fc key (B19), a relu
    UnaryKey and an add BinaryKey (no kernel: PyTorch ops, equal to the
    plain version). B1's and B19's launch counts must rise by the calls
    made and no other; a repeated key is a cache hit."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import (BinaryKey, BrgemmKey, UnaryKey,
                                         brgemm_dispatch,
                                         fused_brgemm_dispatch,
                                         gemm_dispatch, global_cache,
                                         reference_kernel)
    cache = global_cache()
    g = torch.Generator(device="cuda").manual_seed(27)
    M, N, K = BATCH, WIDTH, WIDTH
    t0 = time.perf_counter()
    cases = []      # (label, key, the wrapper's output, the key's inputs)
    cache.reset_launches()
    for tb in (False, True):
        key = BrgemmKey(1, M, N, K, "f32", beta0=True, transpose_b=tb)
        a, b, _, _ = _brgemm_inputs(key, g)
        gemm = gemm_dispatch(M, N, K, "f32", beta0=True, transpose_b=tb)
        cases.append((f"gemm_dispatch f32{' transpose_b' * tb}", key,
                      gemm(a[0], b[0]), (a, b)))
    key = BrgemmKey(4, M, N, K, "bf16", beta0=True)
    a, b, _, _ = _brgemm_inputs(key, g)
    cases.append(("brgemm_dispatch batch 4 bf16", key,
                  brgemm_dispatch(4, M, N, K, "bf16", beta0=True)(a, b),
                  (a, b)))
    key = BrgemmKey(1, M, N, K, "f32", beta0=True, binary_kind="add",
                    unary_kind="relu")
    args = _brgemm_inputs(key, g)
    cases.append(("fused_brgemm_dispatch f32 bias+relu", key,
                  fused_brgemm_dispatch(1, M, N, K, "f32",
                                        beta0=True)(*args), args))
    key = _packed_key("fc_fp32_packed_warm_1024", 0)
    args = _blocked_inputs(key, g)
    cases.append(("dispatch(BlockedMatmulKey) fc packed", key,
                  cache.dispatch(key)(*args), args))
    x = torch.randn(M, N, generator=g, device="cuda")
    bias = torch.randn(N, generator=g, device="cuda")
    key = UnaryKey("relu", (M, N), "f32")
    cases.append(("dispatch(UnaryKey) relu", key, cache.dispatch(key)(x),
                  (x,)))
    key = BinaryKey("add", (M, N), (N,), "f32")
    cases.append(("dispatch(BinaryKey) add", key,
                  cache.dispatch(key)(x, bias), (x, bias)))
    torch.cuda.synchronize()
    launches = _launches(cache)
    for label, key, got, args in cases:
        want = reference_kernel(key)(*args)
        rel, ab = rel_err(got, want)
        tol = _tol(key) if _kind(key) else 0.0
        ok = tuple(got.shape) == tuple(want.shape) and rel <= tol and \
            torch_isfinite(got)
        say(f"dispatch {label:36s} rel {rel:.3e} abs {ab:.3e} tol "
            f"{tol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rel {rel} > {tol}")
    hits = cache.stats.hits
    gemm_dispatch(M, N, K, "f32", beta0=True)
    hit = cache.stats.hits == hits + 1
    want = {"brgemm": 4, "blocked_matmul": 1}
    moved = {k: n for k, n in launches.items() if n}
    ok = moved == want and hit
    say(f"dispatch launches {moved} (want {want}); a repeated key a cache "
        f"hit: {hit}; {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dispatch API launches {moved}, hit {hit}")
    return launches


def _parity_cases():
    """tests/torch_parity_cases.py, the programs and the serving fuzz
    harness this script shares with the port's parity tests."""
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_parity_cases
    return torch_parity_cases


def phase_fusion_parity() -> dict:
    """ROADMAP A6 on the card: each FUSION_CASES program
    (tests/torch_parity_cases.py) through
    default-tpp-passes and the executor run_module runs (runtime.compile,
    device "cuda", f32 "default") on the tests' inputs, against the same
    program evaluated as --linalg-to-loops does (the tl oracles, no
    lowering), at TOL_BF16 as phase_compiler_path holds its f32 modules.
    Prints each program's lowered invokes and its launches; B1 (with B2's
    LayerNorm prologue on the block's fused GEMMs) and B7 must launch."""
    import torch

    from tpp_mlir_tpu_torch.passes import run_pipeline
    from tpp_mlir_tpu_torch.runtime import compile as tpp_compile
    from tpp_mlir_tpu_torch.xsmm import BrgemmKey, global_cache
    pc = _parity_cases()
    cache = global_cache()
    t0 = time.perf_counter()
    total: dict[str, int] = {"brgemm LN prologue": 0}
    for name in pc.FUSION_CASES:
        low = pc.fusion_module(name)
        run_pipeline(low, "default-tpp-passes")
        args = pc.fusion_inputs(name)
        cache.reset_launches()
        got = tpp_compile(low, device="cuda")(*args)
        torch.cuda.synchronize()
        launches = _launches(cache)
        launches["brgemm LN prologue"] = sum(
            fn.launches for fn in cache.kernels()
            if isinstance(fn.key, BrgemmKey) and fn.key.prologue)
        want = tpp_compile(pc.fusion_module(name), device="cuda")(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst = max(rel_err(a, b)[0] for a, b in zip(got, want))
        ok = len(got) == len(want) and worst <= TOL_BF16 and all(
            tuple(a.shape) == tuple(b.shape) and torch_isfinite(a)
            for a, b in zip(got, want))
        moved = {k: n for k, n in launches.items() if n}
        ops = _invokes(low)
        say(f"fusion {name:44s} {len(ops)} invokes, launches {moved} vs "
            f"--linalg-to-loops rel {worst:.3e} tol {TOL_BF16:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: rel {worst} > {TOL_BF16}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    moved = {k: n for k, n in total.items() if n}
    del total["brgemm LN prologue"]     # counted in brgemm
    say(f"fusion parity: {len(pc.FUSION_CASES)} programs, launches {moved}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(moved.get(k) for k in ("brgemm", "brgemm LN prologue",
                                      "attention")):
        raise AssertionError(f"a kernel of the block's path never "
                             f"launched: {moved}")
    return total


FUZZ_BASE = dict(vocab=50304, embed=768, heads=12, layers=2, mlp_ratio=4,
                 max_seq=64, dtype="f32")
FUZZ_KV_HEADS = 4       # llama_gqa and flash_gqa on the card (3 a group)
FUZZ_SEEDS = 3          # seeds an architecture on the card
# the share of compared steps that may take the near-tie exemption
FUZZ_EXEMPT_SHARE = 0.05


def phase_serving_fuzz() -> dict:
    """ROADMAP A7 on the card: the fuzzer's ten architectures at GPT-2
    small's widths (FUZZ_BASE: E 768, 12 heads, vocab 50304, 2 layers, 64
    positions, f32; kv_heads 4; MoE 4 experts top-2, moe_group_bm 8), the
    first FUZZ_SEEDS seeds of the JAX schedule each, kernels on: every path
    against the kernels-on greedy make_generate by fuzz_compare with the
    near-tie exemption (paths run other kernels: B7 or B14 in the prefill,
    B13 in decode, the composed make_extend, and f32 "default" attention
    rounds its operands to bf16). Fails where more than FUZZ_EXEMPT_SHARE
    of the compared steps took the exemption. Then the seeded bug of the
    JAX meta-test, once: with engine._grouped_combine made top-1, the
    moe_grouped forms check must fail on its first seed (its logits move
    past TOL_MODEL, or a token differs). Prints the launch
    counts of each architecture, each path's steps, exemptions and worst
    |delta logits|, and the phase's time."""
    import torch

    from tpp_mlir_tpu_torch.serving import engine
    from tpp_mlir_tpu_torch.xsmm import global_cache
    cache = global_cache()
    t0 = time.perf_counter()
    pc = _parity_cases()
    arches = pc.fuzz_arches(FUZZ_BASE, FUZZ_KV_HEADS)
    total: dict[str, int] = {}
    table: dict[tuple, list] = {}
    for idx, (name, cfg, bits, paths) in enumerate(arches):
        ta = time.perf_counter()
        harness = pc.FuzzHarness(cfg, bits, paths, "cuda")
        cache.reset_launches()
        seeds = range(idx, idx + FUZZ_SEEDS * len(arches), len(arches))
        for seed in seeds:
            res = pc.fuzz_compare(harness.run(seed), seed, exempt=True,
                                  tol=TOL_MODEL)
            for path, (steps, exempted, worst, notes) in res.items():
                row = table.setdefault((name, path), [0, 0, 0.0])
                row[0] += steps
                row[1] += exempted
                row[2] = max(row[2], worst)
                for note in notes:
                    say(f"fuzz {name} {path} seed {seed}: near tie "
                        f"exempted, {note}")
        torch.cuda.synchronize()
        launches = _launches(cache)
        moved = {k: n for k, n in launches.items() if n}
        want = ["decode_attn", "flash_train_fwd" if cfg.flash_attn
                else "attention"]
        if cfg.moe_prefill_form == "grouped":
            want.append("grouped_gemm")
        ok = all(moved.get(k) for k in want)
        say(f"fuzz {name:15s} seeds {list(seeds)} paths {','.join(paths)} "
            f"launches {moved} {time.perf_counter() - ta:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: a kernel of {want} never "
                                 f"launched: {moved}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    for (name, path), (steps, exempted, worst) in table.items():
        say(f"fuzz {name:15s} {path:8s} steps {steps:3d} near-tie "
            f"exemptions {exempted} worst max|dlogits| {worst:.3e}")
    steps = sum(r[0] for r in table.values())
    exempted = sum(r[1] for r in table.values())
    share = exempted / steps
    ok = share <= FUZZ_EXEMPT_SHARE
    say(f"fuzz: {steps} steps compared, {exempted} near-tie exemptions "
        f"({share:.2%}, at most {FUZZ_EXEMPT_SHARE:.0%}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"near-tie exemptions {share:.2%} of steps")
    # the seeded bug: the grouped form's combine silently top-1
    idx, (name, cfg, _, _) = next((i, a) for i, a in enumerate(arches)
                                  if a[0] == "moe_grouped")
    real = engine._grouped_combine
    engine._grouped_combine = lambda gates, ys, rows, top_k: real(
        gates, ys, rows, 1)
    try:
        runs = pc.FuzzHarness(cfg, 0, ("forms",), "cuda").run(idx)
        try:
            pc.fuzz_compare(runs, idx, exempt=True, tol=TOL_MODEL)
            caught = ""
        except AssertionError as e:
            caught = str(e)
    finally:
        engine._grouped_combine = real
    ok = caught.startswith("forms ")
    say(f"fuzz seeded top-1 combine bug on {name} seed {idx}: "
        f"{caught or 'not caught'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the forms check missed the seeded bug")
    say(f"serving fuzz: {time.perf_counter() - t0:.1f} s")
    return total


def main(phases: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import tpp_mlir_tpu_torch    # noqa: F401  (fail before any output
                                 # outside a checkout)
    unknown = [n for n in phases if not callable(globals().get(f"phase_{n}"))]
    if unknown:
        print(f"chip_smoke: no phase {unknown}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    if phases:
        # the named phases alone, after the build (each must take no
        # argument): no kernel line, no result line
        for name in phases:
            globals()[f"phase_{name}"]()
        say(f"phases {phases}: {time.perf_counter() - t0:.1f} s on {card}")
        return 0
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
    f16_rows = phase_f16()
    f16_rows += phase_f16_transformer()
    f16_rows += phase_f16_conv()
    f16_rows += phase_f16_attention()
    f16_rows += phase_f16_mixed()
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
    for phase in (phase_dispatch_api, phase_fusion_parity,
                  phase_serving_fuzz):
        for kind, n in phase().items():
            launches[kind] += n
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
    # the f16 keys (ROADMAP A14), each a row of its kernel's, launched on
    # phase_f16's main path and the later f16 phases' paths
    for kind, key, source, entry in f16_rows:
        out = getattr(key, "out_dtype", None)
        mixed = f"->{out}" if out in ("bf16", "f16") and \
            out != getattr(key, "dtype", out) else ""
        kernels.append({"route": "cuda", "source": source,
                        "replaces": rows[kind]["replaces"],
                        "name": f"{kind}@{describe(key)}{mixed}", **entry})
    say(f"total: {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
