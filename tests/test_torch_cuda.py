"""The Hopper kernels on the card, against their plain versions.

Marked `cuda`: without an NVIDIA card every test here skips. On the card,
where JAX is absent, run them without tests/conftest.py (which imports it):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Error measure: max|kernel - plain| / max|plain|. 1e-4 where both sides round
the operands the same way and only the sum order differs: a single GEMM
with an f32 output (f32 "default" included), an f32 "highest" chain,
attention or LayerNorm-prologue GEMM, and an f32 LayerNorm. 1e-2 for a bf16
output, for chains that re-round each layer's input to bf16, for attention
in the bf16 MXU dtype (the kernel rounds unnormalized P and divides by the
row sum after P.V, the plain version normalizes P first, as B7 does) and
for a LayerNorm prologue that rounds its f32 result to bf16, where a
sum-order difference can flip a rounding; an f32 "default" chain (one pass)
must also sit nearer the "default" plain version than the "highest" one.
"""

import dataclasses
import io

import pytest
import torch

from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.models.mlp import MlpConfig
from tpp_mlir_tpu_torch.tools.mlir_gen import generate_text
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                     BrgemmKey, ChainKey, ConvBrgemmKey,
                                     ConvNhwcKey, DecodeAttnKey, FlashMhaKey,
                                     FlashTrainBwdKey,
                                     FlashTrainKey, GroupedGemmKey,
                                     GroupedWgradKey, Int8GemmKey,
                                     LayerNormKey, build_kernel,
                                     global_cache, reference_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _err(got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30)


def _tol(key):
    if isinstance(key, BrgemmKey):
        return 1e-4 if (key.out_dtype or key.dtype) == "f32" else 1e-2
    return 1e-4 if key.dtype == "f32" and key.precision == "highest" \
        else 1e-2


def _rnd(g, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(
        {"f32": torch.float32, "bf16": torch.bfloat16}[dtype])


@pytest.mark.parametrize("key", [
    BrgemmKey(1, 100, 72, 40, "f32", beta0=True, binary_kind="add",
              unary_kind="relu"),
    BrgemmKey(1, 64, 64, 64, "f32", precision="highest"),
    BrgemmKey(3, 48, 80, 96, "bf16", beta0=True, binary_kind="max",
              binary_bcast="bcast_row", unary_kind="gelu_tanh"),
    BrgemmKey(1, 33, 65, 64, "bf16", out_dtype="f32", beta0=True,
              transpose_b=True, binary_kind="div",
              binary_bcast="bcast_scalar", unary_kind="exp"),
    BrgemmKey(2, 64, 32, 64, "bf16", vnni=2, binary_kind="add",
              binary_bcast="none", unary_kind="square"),
], ids=["ragged-fc", "highest-C", "batch-row-max", "tb-scalar-div",
        "vnni-full"])
def test_brgemm_kernel_matches_plain(cuda, key):
    g = cuda
    a = _rnd(g, (key.batch, key.m, key.k), key.dtype)
    if key.vnni:
        b = _rnd(g, (key.batch, key.k // 2, key.n, 2), key.dtype, 0.1)
    elif key.transpose_b:
        b = _rnd(g, (key.batch, key.n, key.k), key.dtype, 0.1)
    else:
        b = _rnd(g, (key.batch, key.k, key.n), key.dtype, 0.1)
    c = None if key.beta0 else _rnd(g, (key.m, key.n), "f32")
    shape = {"bcast_col": (key.n,), "bcast_row": (key.m, 1),
             "bcast_scalar": (), "none": (key.m, key.n)}[key.binary_bcast]
    d = _rnd(g, shape, "f32") + (3.0 if key.binary_kind == "div" else 0.0) \
        if key.binary_kind else None
    kern = build_kernel(key)
    got = kern(a, b, c, d)
    want = reference_kernel(key)(a, b, c, d)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert _err(got, want) <= _tol(key)


@pytest.mark.parametrize("key", [
    ChainKey(m=40, dims=(64, 128, 32), dtype="bf16", unary_kind="gelu",
             last_unary=None),
    ChainKey(m=17, dims=(48, 48, 48), precision="highest", has_bias=False),
    ChainKey(m=64, dims=(64, 64, 64), repeats=5),
    ChainKey(m=64, dims=(256, 256, 256, 256)),
], ids=["bf16-gelu", "highest-ragged-rows", "f32-repeats", "f32-default"])
def test_chain_kernel_matches_plain(cuda, key):
    g = cuda
    args = [_rnd(g, (key.m, key.dims[0]), key.dtype)]
    for i in range(len(key.dims) - 1):
        args.append(_rnd(g, (key.dims[i], key.dims[i + 1]), key.dtype,
                         key.dims[i] ** -0.5))
        if key.has_bias:
            args.append(_rnd(g, (key.dims[i + 1],), key.dtype, 0.1))
    got = build_kernel(key)(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert _err(got, want) <= _tol(key)
    if key.dtype == "f32" and key.precision == "default" and \
            key.repeats == 1:
        # f32 "default" means bf16 operands: a true-f32 kernel would sit
        # nearer the "highest" plain version
        hi = reference_kernel(dataclasses.replace(key, precision="highest"))
        assert _err(got, want) < _err(got, hi(*args))


@pytest.mark.parametrize("key", [
    BrgemmKey(1, 100, 72, 200, "bf16", beta0=True, binary_kind="add",
              unary_kind="gelu", prologue="layer_norm"),
    BrgemmKey(1, 64, 96, 128, "f32", precision="highest",
              prologue="layer_norm", prologue_affine=False),
    BrgemmKey(1, 128, 192, 256, "f32", beta0=True, binary_kind="add",
              prologue="layer_norm"),
], ids=["bf16-gelu-ragged", "highest-C-no-affine", "f32-default"])
def test_ln_prologue_gemm_matches_plain(cuda, key):
    g = cuda
    a = _rnd(g, (1, key.m, key.k), key.dtype) * 2 + 0.5
    b = _rnd(g, (1, key.k, key.n), key.dtype, 0.1)
    c = None if key.beta0 else _rnd(g, (key.m, key.n), "f32")
    d = _rnd(g, (key.n,), "f32") if key.binary_kind else None
    gamma, beta = _rnd(g, (key.k,), "f32"), _rnd(g, (key.k,), "f32")
    kern = build_kernel(key)
    got = kern(a, b, c, d, gamma, beta)
    want = reference_kernel(key)(a, b, c, d, gamma, beta)
    torch.cuda.synchronize()
    assert kern.launches == 1
    tol = 1e-4 if key.precision == "highest" else 1e-2
    assert _err(got, want) <= tol


@pytest.mark.parametrize("key", [
    FlashMhaKey(2, 128, 128, 64, "bf16", scale=0.125, causal=True, heads=2,
                qkv_packed=True),
    FlashMhaKey(2, 100, 100, 128, "f32", scale=128 ** -0.5, heads=2),
    FlashMhaKey(1, 96, 160, 64, "f32", scale=0.125, causal=True,
                precision="highest", heads=3),
    FlashMhaKey(2, 128, 128, 32, "bf16", scale=32 ** -0.5, heads=4,
                qkv_packed=True, strategy="tokens"),
    FlashMhaKey(1, 64, 64, 128, "f32", scale=128 ** -0.5, precision="highest",
                heads=1, qkv_packed=True),
    FlashMhaKey(2, 128, 128, 64, "bf16", scale=0.125, causal=True, heads=3),
], ids=["bf16-causal-packed-d64", "f32-ragged-d128", "highest-causal-skv",
        "bf16-packed-d32", "highest-packed-d128", "bf16-causal-split-d64"])
def test_attention_kernel_matches_plain(cuda, key):
    g = cuda
    E = key.heads * key.head_dim
    if key.qkv_packed:
        args = [_rnd(g, (key.batch, key.seq, 3 * E), key.dtype)] * 3
    else:
        args = [_rnd(g, (key.batch, s, E), key.dtype)
                for s in (key.seq, key.seq_kv, key.seq_kv)]
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 1 and got.shape == want.shape
    tol = 1e-4 if key.precision == "highest" else 1e-2
    assert _err(got, want) <= tol


@pytest.mark.parametrize("key", [
    LayerNormKey(m=100, n=768, dtype="bf16"),
    LayerNormKey(m=64, n=1024, dtype="f32", affine=False),
    LayerNormKey(m=33, n=200, dtype="f32", out_dtype="bf16", eps=1e-6),
], ids=["bf16-768", "f32-1024-no-affine", "f32-in-bf16-out"])
def test_layer_norm_kernel_matches_plain(cuda, key):
    g = cuda
    x = _rnd(g, (key.m, key.n), key.dtype) * 3 + 1
    gamma, beta = _rnd(g, (key.n,), "f32"), _rnd(g, (key.n,), "f32")
    kern = build_kernel(key)
    got = kern(x, gamma, beta)
    want = reference_kernel(key)(x, gamma, beta)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert _err(got, want) <= (1e-4 if (key.out_dtype or key.dtype) == "f32"
                               else 1e-2)


@pytest.mark.parametrize("layers,invoke", [
    ((128, 128, 128, 128), "ChainKey"), ((128, 96), "BrgemmKey")])
def test_main_path_on_the_card_matches_linalg_to_loops(cuda, layers, invoke):
    cfg = MlpConfig(batch=64, layers=layers, bias=True, relu=True,
                    float_type="bf16")
    cache = global_cache()
    cache.reset_launches()
    got = run_module(parse_module(generate_text(cfg)), device="cuda",
                     out_stream=io.StringIO())["outputs"][0]
    assert cache.launches_by_kind().get(invoke, 0) == 1
    want = run_module(parse_module(generate_text(cfg)), device="cuda",
                      linalg_to_loops=True,
                      out_stream=io.StringIO())["outputs"][0]
    assert _err(got, want) <= 1e-2


def test_trace_times_each_invoke_of_a_gpt(cuda):
    from tpp_mlir_tpu_torch.tools.bench_driver import build_module
    from tpp_mlir_tpu_torch.tools.trace import trace_module
    res = trace_module(build_module({"model": (
        'gpt:{"batch": 1, "seq": 128, "vocab": 256, "embed": 128, '
        '"heads": 2, "layers": 2, "dtype": "bf16"}')}), iters=2, n=0)
    assert "bench" not in res      # ids -> logits: no perf.bench wrapper
    names = {name.split()[0]: n for name, n, ms in res["invokes"]}
    assert names["attention"] == 2 and names["layer_norm"] == 1
    assert all(ms > 0 for _, _, ms in res["invokes"])


def test_trace_sees_the_chain_kernel(cuda):
    from tpp_mlir_tpu_torch.tools.trace import trace_module
    cfg = MlpConfig(batch=64, layers=(128, 128, 128), bias=True, relu=True,
                    float_type="bf16")
    res = trace_module(parse_module(generate_text(cfg)), iters=3, n=5)
    for region in ("eager", "bench"):
        r = res[region]
        assert 0.0 <= r["idle_share"] < 1.0 and r["busy_ms"] > 0.0
        assert any("chain" in name for _, name in r["shares"])


# -- the serving kernels (B13 decode attention, B15 int8 GEMM) --------------

@pytest.mark.parametrize("key,pos", [
    (DecodeAttnKey(4, 6, 256, 64, "bf16", stacked=3), [200]),
    (DecodeAttnKey(4, 6, 256, 64, "bf16", slotted=True, stacked=3),
     [0, 256, 100, 255]),
    (DecodeAttnKey(4, 2, 256, 64, "bf16", groups=3, stacked=3), [130]),
    (DecodeAttnKey(4, 6, 256, 64, "bf16", kv_quant=True, stacked=3), [77]),
    (DecodeAttnKey(4, 6, 256, 64, "bf16", pack2=True, stacked=3), [199]),
    (DecodeAttnKey(2, 2, 128, 128, "f32", groups=8, kv_quant=True,
                   stacked=3), [127]),
    (DecodeAttnKey(2, 4, 64, 32, "f32", stacked=3), [40]),
], ids=["mha-bf16", "slotted-sentinel", "gqa-g3", "int8-kv", "pack2",
        "d128-g8-f32-int8", "d32-f32"])
def test_decode_attn_kernel_matches_plain(cuda, key, pos):
    """1e-4: the kernel and its plain version compute in f32 from the same
    values and differ in summation order only."""
    g = cuda
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    if key.pack2:
        q_shape, slab = (B, H // 2, 2 * D), (3, B, H // 2, S, 2 * D)
    else:
        q_shape = (B, H, D) if G == 1 else (B, H, G, D)
        slab = (3, B, H, S, D)
    q = _rnd(g, q_shape, key.dtype)
    kw = {}
    if key.kv_quant:
        k = torch.randint(-127, 128, slab, generator=g, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, slab, generator=g, device="cuda",
                          dtype=torch.int8)
        kw = {n: torch.rand(slab[:4], generator=g, device="cuda") * 0.02
              for n in ("k_s", "v_s")}
    else:
        k, v = _rnd(g, slab, key.dtype), _rnd(g, slab, key.dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    kern = build_kernel(key)
    got = kern(q, k, v, pos, 1, **kw)
    want = reference_kernel(key)(q, k, v, pos, 1, **kw)
    torch.cuda.synchronize()
    assert kern.launches == 1 and got.shape == want.shape
    assert _err(got, want) <= 1e-4


@pytest.mark.parametrize("key", [
    Int8GemmKey(m=256, n=384, k=768, has_bias=True),
    Int8GemmKey(m=33, n=200, k=64, has_bias=True, unary_kind="gelu",
                out_dtype="bf16"),
    Int8GemmKey(m=128, n=50304, k=128),
], ids=["bias-f32", "ragged-gelu-bf16", "lm-head-width"])
def test_int8_gemm_kernel_matches_plain(cuda, key):
    """The s32 product is exact on both sides and the epilogue runs the same
    f32 operations in the same order: 1e-5 for an f32 output, 1e-2 for
    bf16."""
    g = cuda
    xq = torch.randint(-127, 128, (key.m, key.k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (key.k, key.n), generator=g, device="cuda",
                       dtype=torch.int8)
    args = [xq, wq, torch.rand(key.m, generator=g, device="cuda") * 0.01,
            torch.rand(1, key.n, generator=g, device="cuda") * 0.01]
    if key.has_bias:
        args.append(_rnd(g, (key.n,), "bf16"))
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert _err(got, want) <= (1e-5 if key.out_dtype == "f32" else 1e-2)


def _serving_model(kv_quant=None, **kw):
    from tpp_mlir_tpu_torch.serving import GptConfig, init_params
    cfg = GptConfig(vocab=512, embed=256, heads=4, layers=2, max_seq=128,
                    dtype="bf16", kv_quant=kv_quant, **kw)
    return cfg, init_params(cfg, seed=0, device="cuda")


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_graph_replay_equals_eager(cuda, kv_quant):
    from tpp_mlir_tpu_torch.serving import make_generate
    cfg, params = _serving_model(kv_quant)
    ids = torch.randint(0, cfg.vocab, (4, 32), generator=cuda,
                        device="cuda", dtype=torch.int32)
    cache = global_cache()
    cache.reset_launches()
    eager = make_generate(cfg, 8, graph=False)(params, ids)
    counts = cache.launches_by_kind()
    assert counts["DecodeAttnKey"] == cfg.layers * 7
    assert counts["FlashMhaKey"] == cfg.layers
    graphed = make_generate(cfg, 8)(params, ids)
    assert torch.equal(graphed, eager)


def test_serving_kernels_match_the_kernels_off_engine(cuda):
    """Prefill (B7 + B15) and decode (B13) through the kernels against the
    same engine on its composed and einsum paths, teacher-forced."""
    import dataclasses

    from tpp_mlir_tpu_torch.serving import (make_decode_step, make_prefill,
                                            quantize_params)
    cfg, params = _serving_model("int8", int8_compute=True)
    params = quantize_params(params)
    off = dataclasses.replace(cfg, decode_attn="xla")
    ids = torch.randint(0, cfg.vocab, (4, 40), generator=cuda,
                        device="cuda", dtype=torch.int32)
    la, ca = make_prefill(cfg)(params, ids[:, :32])
    lb, cb = make_prefill(off, use_kernels=False)(params, ids[:, :32])
    assert _err(la, lb) <= 3e-2
    for t in range(32, 40):
        la, ca = make_decode_step(cfg)(params, ca, ids[:, t])
        lb, cb = make_decode_step(off, use_kernels=False)(params, cb,
                                                          ids[:, t])
        assert _err(la, lb) <= 3e-2


def test_trace_serving_sees_the_decode_kernel(cuda):
    from tpp_mlir_tpu_torch.tools.trace import trace_serving
    cfg, params = _serving_model()
    ids = torch.randint(0, cfg.vocab, (2, 16), generator=cuda,
                        device="cuda", dtype=torch.int32)
    res = trace_serving(cfg, params, ids, steps=3)
    graph = res["decode graph (3 steps)"]
    assert 0.0 <= graph["idle_share"] < 1.0 and graph["busy_ms"] > 0.0
    assert any("decode_attn" in name for _, name in graph["shares"])
    assert any("attention_kernel" in name for _, name in
               res["prefill"]["shares"])


# ---------------------------------------------------------------------------
# the training slice: B14/B18 and the train steps
# Tolerances: f32 1e-4 (sum order only); bf16 2e-2 (P and dS rounded to
# bf16 on both sides; the kernel's online softmax rounds P against the
# running max, the plain version against the row's).

@pytest.mark.parametrize("key", [
    FlashTrainKey(2, 3, 100, 32, "bf16", False, 32 ** -0.5),
    FlashTrainKey(1, 2, 200, 128, "bf16", True, 128 ** -0.5),
    FlashTrainKey(2, 2, 130, 64, "f32", True, 0.125),
], ids=["bf16-d32-tail", "bf16-d128-causal", "f32-d64-causal-tail"])
def test_flash_train_kernels_match_plain(cuda, key):
    import dataclasses
    t = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    q, k, v, do = (torch.randn(key.batch, key.seq, key.heads, key.head_dim,
                               generator=cuda, device="cuda").to(t)
                   for _ in range(4))
    tol = 1e-4 if key.dtype == "f32" else 2e-2
    o, lse2 = build_kernel(key)(q, k, v)
    po, plse2 = reference_kernel(key)(q, k, v)
    assert _err(o, po) <= tol and _err(lse2, plse2) <= 1e-4
    delta = (do.float() * po.float()).sum(-1).transpose(1, 2).contiguous()
    bkey = FlashTrainBwdKey(**dataclasses.asdict(key))
    got = build_kernel(bkey)(q, k, v, do, plse2, delta)
    again = build_kernel(bkey)(q, k, v, do, plse2, delta)
    want = reference_kernel(bkey)(q, k, v, do, plse2, delta)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)           # no atomics: bit-repeatable
        assert _err(a, w) <= tol


def test_flash_attention_train_gqa_grads_match_composed(cuda):
    from tpp_mlir_tpu_torch.serving import composed_causal_attention
    from tpp_mlir_tpu_torch.xsmm.flash_train import flash_attention_train
    q = torch.randn(2, 64, 4, 32, generator=cuda, device="cuda")
    k, v = (torch.randn(2, 64, 2, 32, generator=cuda, device="cuda")
            for _ in range(2))
    g = torch.randn(2, 64, 4, 32, generator=cuda, device="cuda")
    grads = []
    for attn in (flash_attention_train, composed_causal_attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        attn(*leaves, 32 ** -0.5).backward(g)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert _err(a, b) <= 1e-4


def test_f32_matmul_backward_runs_bf16_gemms(cuda):
    from tpp_mlir_tpu_torch.ops.trainable import f32_matmul
    x = torch.randn(64, 48, generator=cuda, device="cuda").bfloat16()
    w = torch.randn(48, 32, generator=cuda, device="cuda").bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = f32_matmul(x, w)
    assert y.dtype == torch.float32
    g = torch.randn(64, 32, generator=cuda, device="cuda")
    y.backward(g)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    gb = g.bfloat16().float()
    assert _err(x.grad, gb @ w.float().t()) <= 1e-2
    assert _err(w.grad, x.float().t() @ gb) <= 1e-2


@pytest.mark.parametrize("dtype,precision", [("bf16", "default"),
                                             ("f32", "highest")])
def test_mlp_train_step_on_the_card_matches_kernels_off(cuda, dtype,
                                                        precision):
    from tpp_mlir_tpu_torch.parallel import make_train_step, mlp_init
    layers = (128, 128, 128, 128)
    params = mlp_init(layers, {"bf16": "bfloat16", "f32": "float32"}[dtype])
    t = params[0][0].dtype
    x = torch.randn(64, 128, generator=cuda, device="cuda").to(t)
    y = torch.randn(64, 128, generator=cuda, device="cuda").to(t)
    out = []
    for kernels in (True, False):
        step = make_train_step(layers, 0.05, use_kernels=kernels,
                               precision=precision)
        cache = global_cache()
        cache.reset_launches()
        p = params
        for _ in range(2):
            p, loss = step(p, x, y)
        assert (cache.launches_by_kind().get("BrgemmKey", 0) > 0) == kernels
        out.append(p)
    for (wk, bk), (wp, bp) in zip(*out):
        assert _err(wk, wp) <= (1e-4 if dtype == "f32" else 1e-2)
        assert _err(bk, bp) <= (1e-4 if dtype == "f32" else 1e-2)


# ---------------------------------------------------------------------------
# the MoE slice: B16 (grouped GEMM) and B17 (grouped weight gradient) on
# routings made by the engine's own dispatch. Tolerances: 1e-4 for an f32
# output (both sides round the operands alike: sum order only), 1e-2 for
# bf16; padding rows and experts no token chose come out exactly zero, and
# B17 is bit-repeatable (no atomics).

def _moe_routing(g, T, n_e, bm, skew):
    """The dispatch maps of a top-2 routing of T random tokens; skewed:
    expert n_e - 1 gets no token (it keeps only its padding block)."""
    from tpp_mlir_tpu_torch.serving.engine import _grouped_dispatch
    logits = torch.randn(T, n_e, generator=g, device="cuda")
    if skew:
        logits[:, 0] += 2.0
        logits[:, n_e - 1] -= 100.0
    return _grouped_dispatch(logits.topk(2, -1).indices, T, n_e, bm, 2)


# (T, n_e, bm, k, n, key fields, skewed routing)
GROUPED = {
    "bf16-gelu-bm128": (512, 8, 128, 256, 512,
                        dict(dtype="bf16", unary_kind="gelu"), False),
    "bf16-bm16-tb-f32out": (200, 4, 16, 128, 96,
                            dict(dtype="bf16", transpose_b=True,
                                 out_dtype="f32"), True),
    "f32-default-bm32": (100, 4, 32, 96, 64, dict(dtype="f32"), False),
    "f32-highest-layers": (64, 4, 64, 64, 128,
                           dict(dtype="f32", precision="highest", layers=3,
                                unary_kind="gelu"), True),
}


@pytest.mark.parametrize("name", list(GROUPED))
def test_grouped_gemm_kernel_matches_plain(cuda, name):
    T, n_e, bm, k, n, fields, skew = GROUPED[name]
    d = _moe_routing(cuda, T, n_e, bm, skew)
    key = GroupedGemmKey(n_groups=n_e, m=d["A_pad"], n=n, k=k, bm=bm,
                         **fields)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key.dtype]
    h = _rnd(cuda, (T, k), key.dtype)
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    wshape = (n, k) if key.transpose_b else (k, n)
    w = _rnd(cuda, ((key.layers,) if key.layers else ()) + (n_e, *wshape),
             key.dtype, k ** -0.5)
    args = ((1,) if key.layers else ()) + (d["ge"], xs.to(dt), w)
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == 1
    assert _err(got, want) <= (1e-4 if (key.out_dtype or key.dtype) == "f32"
                               else 1e-2)
    assert not got[d["tt"] == T].any()          # padding rows stay zero


# (T, n_e, bm, k, n, dtype, precision, skewed routing)
WGRAD = {
    "bf16-bm128": (512, 8, 128, 256, 512, "bf16", "default", False),
    "bf16-bm16-skewed": (200, 4, 16, 128, 96, "bf16", "default", True),
    "f32-highest-skewed": (100, 4, 32, 64, 96, "f32", "highest", True),
}


@pytest.mark.parametrize("name", list(WGRAD))
def test_grouped_wgrad_kernel_matches_plain(cuda, name):
    T, n_e, bm, k, n, dtype, precision, skew = WGRAD[name]
    d = _moe_routing(cuda, T, n_e, bm, skew)
    key = GroupedWgradKey(n_groups=n_e, m=d["A_pad"], k=k, n=n, bm=bm,
                          dtype=dtype, precision=precision)
    h = _rnd(cuda, (T, k), dtype)
    xs = torch.cat([h, h.new_zeros(1, k)])[d["tt"]]
    dy = _rnd(cuda, (d["A_pad"], n), dtype)
    kern = build_kernel(key)
    got = kern(d["ge"], xs.t(), dy)         # the transpose, read in place
    again = kern(d["ge"], xs.t().contiguous(), dy)
    want = reference_kernel(key)(d["ge"], xs.t(), dy)
    torch.cuda.synchronize()
    assert kern.launches == 2 and torch.equal(got, again)
    assert _err(got, want) <= 1e-4
    if skew:
        assert not got[n_e - 1].any()


def _moe_model(**kw):
    from tpp_mlir_tpu_torch.serving import GptConfig, init_params
    cfg = GptConfig(vocab=512, embed=256, heads=4, layers=2, max_seq=128,
                    dtype="bf16", n_experts=4, moe_prefill_form="grouped",
                    moe_group_bm=64, **kw)
    return cfg, init_params(cfg, seed=0, device="cuda")


def test_moe_grouped_prefill_matches_the_kernels_off_engine(cuda,
                                                           monkeypatch):
    """Two B16 launches a layer; logits within the model tolerance of the
    kernels-off engine run at the kernel run's routing: once the numerics
    differ, a bf16 near-tie of the router can flip a token's experts."""
    from tpp_mlir_tpu_torch.serving import engine, make_prefill
    cfg, params = _moe_model()
    ids = torch.randint(0, cfg.vocab, (4, 64), generator=cuda,
                        device="cuda", dtype=torch.int32)
    router, routes = engine._moe_gates, []

    def record(*a):
        out = router(*a)
        routes.append(out[1])
        return out
    monkeypatch.setattr(engine, "_moe_gates", record)
    cache = global_cache()
    cache.reset_launches()
    got = make_prefill(cfg)(params, ids)[0]
    assert cache.launches_by_kind()["GroupedGemmKey"] == 2 * cfg.layers
    pinned = iter(routes)

    def pin(h, wr, top_k, mm=None):
        idx = next(pinned)
        return torch.softmax(engine._mm(h, wr).gather(-1, idx), -1), idx
    monkeypatch.setattr(engine, "_moe_gates", pin)
    want = make_prefill(dataclasses.replace(cfg, decode_attn="xla"),
                        use_kernels=False)(params, ids)[0]
    assert _err(got, want) <= 3e-2


def test_moe_grouped_train_step_launches_b16_and_b17(cuda):
    from tpp_mlir_tpu_torch.parallel import adamw, make_gpt_train_step
    cfg, params = _moe_model()
    ids = torch.randint(0, cfg.vocab, (2, 64), generator=cuda,
                        device="cuda", dtype=torch.int32)
    step, init = make_gpt_train_step(cfg, adamw(1e-3))
    state = init(params)
    cache = global_cache()
    cache.reset_launches()
    losses = [float(step(params, state, ids)[2]) for _ in range(3)]
    counts = cache.launches_by_kind()
    assert counts["GroupedGemmKey"] == 3 * 4 * cfg.layers
    assert counts["GroupedWgradKey"] == 3 * 2 * cfg.layers
    assert losses[-1] < losses[0]


# the MHA suite's kernels: flat-layout attention under each strategy and its
# warm bench (B6, B8-B11), the batched matmul (B21/B22), the ping-pong fc
# bench (B5)
FLAT = {
    "auto-s256-d64": FlashMhaKey(6, 256, 256, 64, "f32", scale=0.125),
    "grouped-causal-bf16": FlashMhaKey(4, 128, 128, 32, "bf16", scale=0.2,
                                       causal=True, strategy="grouped"),
    "qblock-highest-d128": FlashMhaKey(3, 192, 320, 128, "f32",
                                       scale=0.09, precision="highest",
                                       strategy="qblock"),
    "twocall-causal": FlashMhaKey(4, 256, 256, 64, "bf16", scale=0.125,
                                  causal=True, strategy="twocall"),
    "twocall2-causal-ragged": FlashMhaKey(2, 200, 200, 64, "bf16",
                                          scale=0.125, causal=True,
                                          strategy="twocall2"),
    "bench-flat-r3": FlashMhaKey(4, 256, 256, 128, "bf16", scale=0.09,
                                 repeats=3),
    "bench-flat-causal-highest": FlashMhaKey(2, 128, 128, 64, "f32",
                                             scale=0.125, causal=True,
                                             precision="highest", repeats=2),
    "bench-tokens-packed": FlashMhaKey(2, 128, 128, 64, "bf16", scale=0.125,
                                       causal=True, heads=4, repeats=2,
                                       qkv_packed=True),
    "flash-heads": FlashMhaKey(2, 256, 256, 64, "bf16", scale=0.125,
                               causal=True, heads=4,
                               strategy="flash_heads"),
    "xla": FlashMhaKey(2, 128, 128, 64, "bf16", scale=0.125, heads=4,
                       strategy="xla"),
}


@pytest.mark.parametrize("name", list(FLAT))
def test_flat_attention_and_bench_match_plain(cuda, name):
    key = FLAT[name]
    g = cuda
    if key.heads:
        E = key.heads * key.head_dim
        if key.qkv_packed:
            x = _rnd(g, (key.batch, key.seq, 3 * E), key.dtype)
            args = (x, x, x)
        else:
            args = tuple(_rnd(g, (key.batch, s, E), key.dtype)
                         for s in (key.seq, key.seq_kv, key.seq_kv))
    else:
        args = tuple(_rnd(g, (key.batch, s, key.head_dim), key.dtype)
                     for s in (key.seq, key.seq_kv, key.seq_kv))
    kern = build_kernel(key)
    got = kern(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert kern.launches == (0 if key.strategy == "xla" else 1)
    assert torch.isfinite(got.float()).all()
    tol = 2e-2 if key.strategy == "flash_heads" else _tol(key)
    assert _err(got, want) <= tol


BMM = {
    "qk-f32": BatchMatmulKey(64, 32, 32, 64, "f32", beta0=True),
    "softmax-v-bf16": BatchMatmulKey(64, 32, 64, 32, "bf16", beta0=True,
                                     softmax_lhs=True),
    "softmax-highest-C": BatchMatmulKey(5, 70, 90, 100, "f32",
                                        softmax_lhs=True,
                                        precision="highest"),
    "lhs-shared-C-bf16-out-f32": BatchMatmulKey(7, 96, 130, 80, "bf16",
                                                out_dtype="f32",
                                                lhs_shared=True),
}


@pytest.mark.parametrize("name", list(BMM))
def test_batch_matmul_kernel_matches_plain(cuda, name):
    key = BMM[name]
    g = cuda
    a = _rnd(g, (key.m, key.k) if key.lhs_shared
             else (key.batch, key.m, key.k), key.dtype, 2.0)
    b = _rnd(g, (key.batch, key.k, key.n), key.dtype)
    c = None if key.beta0 else _rnd(g, (key.batch, key.m, key.n), "f32")
    kern = build_kernel(key)
    got = kern(a, b, c)
    want = reference_kernel(key)(a, b, c)
    torch.cuda.synchronize()
    assert kern.launches == 1
    f32_out = (key.out_dtype or key.dtype) == "f32"
    assert _err(got, want) <= (1e-4 if f32_out else 1e-2)


@pytest.mark.parametrize("dtype,precision,repeats", [
    ("bf16", "default", 2), ("f32", "default", 3), ("f32", "highest", 4)])
def test_pingpong_chain_matches_plain(cuda, dtype, precision, repeats):
    g = cuda
    key = ChainKey(m=40, dims=(64, 160), dtype=dtype, precision=precision,
                   repeats=repeats, pingpong=True)
    args = (_rnd(g, (40, 64), dtype), _rnd(g, (64, 160), dtype, 64 ** -0.5),
            _rnd(g, (160,), dtype, 0.1))
    got = build_kernel(key)(*args)
    want = reference_kernel(key)(*args)
    torch.cuda.synchronize()
    assert got.shape == (40, 160)
    assert _err(got, want) <= _tol(key)


def test_flat_attention_refuses_shapes_beyond_the_kernel(cuda):
    # head_dim outside attention.cu's instantiations; a batch beyond
    # gridDim.z, where the kernel puts it
    q = torch.zeros(2, 64, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        build_kernel(FlashMhaKey(2, 64, 64, 48))(q, q, q)
    q = torch.zeros(70000, 16, 32, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="65535"):
        build_kernel(FlashMhaKey(70000, 16, 16, 32, "bf16"))(q, q, q)


# the conv family: csrc/conv.cu (B24/B25) at the conv suite's key forms, a
# ragged shape (C, K and the pixel count off the 32/64 tiles), the xla
# route with TF32 off, and the conv suite's nets against --linalg-to-loops
CONV = {
    "3x3-f32-bias-relu": ConvNhwcKey(N=2, H=12, W=12, C=64, K=64, R=3, S=3,
                                     beta0=True, binary_kind="add",
                                     unary_kind="relu"),
    "3x3-highest-acc": ConvNhwcKey(N=2, H=10, W=9, C=64, K=96, R=3, S=3,
                                   precision="highest"),
    "same-residual-bf16": ConvNhwcKey(N=2, H=16, W=16, C=128, K=128, R=3,
                                      S=3, dtype="bf16", pad=(1, 1, 1, 1),
                                      binary_kind="add", binary_bcast="none",
                                      unary_kind="relu"),
    "1x1-w14-fullrow": ConvNhwcKey(N=2, H=14, W=14, C=256, K=64,
                                   beta0=True, binary_kind="add",
                                   unary_kind="relu", strategy="fullrow"),
    "ragged-window-bf16-out-f32": ConvNhwcKey(N=3, H=7, W=11, C=40, K=72,
                                              R=3, S=2, dtype="bf16",
                                              out_dtype="f32",
                                              pad=(2, 0, 1, 1),
                                              strategy="window"),
    "xla-stride2-highest": ConvNhwcKey(N=2, H=9, W=9, C=32, K=32, R=3, S=3,
                                       stride_h=2, stride_w=2, beta0=True,
                                       binary_kind="add",
                                       precision="highest"),
}


@pytest.mark.parametrize("name", list(CONV))
def test_conv_kernel_matches_plain(cuda, name):
    from tpp_mlir_tpu_torch.xsmm.reference import conv_nhwc_reference
    key = CONV[name]
    g = cuda
    i = _rnd(g, (key.N, key.H, key.W, key.C), key.dtype)
    w = _rnd(g, (key.R, key.S, key.C, key.K), key.dtype, key.C ** -0.5)
    c = None if key.beta0 else _rnd(g, (key.N, key.P, key.Q, key.K), "f32")
    d = None
    if key.binary_kind:
        d = _rnd(g, (key.N, key.P, key.Q, key.K)
                 if key.binary_bcast == "none" else (key.K,), "f32")
    kern = build_kernel(key)
    got = kern(i, w, c, d)
    # the per-tap plain version: the xla route's F.conv2d must agree with
    # it at "highest" too, which TF32 would not
    want = conv_nhwc_reference(key)(i, w, c, d)
    torch.cuda.synchronize()
    assert got.shape == (key.N, key.P, key.Q, key.K)
    assert kern.launches == (0 if key.stride_h > 1 else 1)
    assert torch.backends.cudnn.allow_tf32     # restored after the route
    assert _err(got, want) <= _tol(key)


@pytest.mark.parametrize("model", [
    'convnet:{"batch": 2, "channels": 64, "filters": 64, "height": 12, '
    '"width": 12, "kernel": 3, "layers": 2}',
    'convnet:{"batch": 2, "channels": 64, "filters": 64, "height": 8, '
    '"width": 8, "kernel": 3, "layers": 2, "float_type": "bf16", '
    '"layout": "nhwc", "padding": "same", "residual": true}',
    'resnet_block:{"batch": 2, "channels": 64, "hw": 8}',
    'vit:{"batch": 2, "image": 32, "patch": 16, "embed": 128, "heads": 2, '
    '"layers": 1}',
], ids=["convnet-2layer", "resnet-nhwc-bf16", "resnet_block", "vit"])
def test_conv_nets_on_the_card_match_linalg_to_loops(cuda, model):
    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    cache = global_cache()
    cache.reset_launches()
    res = run_entry({"model": model}, device="cuda",
                    out_stream=io.StringIO())
    assert cache.launches_by_kind().get("ConvNhwcKey", 0) >= \
        (0 if model.startswith("vit") else 2)
    got = res["lowered"]["outputs"][0]
    want = res["baseline"]["outputs"][0]
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= 3e-2


# packed parity mode: csrc/blocked_matmul.cu (B19, and B20 with repeats) and
# csrc/conv.cu's channel-blocked entry (B23), at the fc rows' key forms, a
# masked key (mb 8, kb and nb off the 32/64 tiles), VNNI read in place, and
# the packed nets against --linalg-to-loops
BLOCKED = {
    "fc-f32-default": BlockedMatmulKey(1, 2, 2, 64, 128, 128, beta0=True,
                                       binary_kind="add", unary_kind="relu"),
    "fc-f32-highest-c": BlockedMatmulKey(1, 2, 2, 64, 128, 128,
                                         precision="highest"),
    "fc-bf16-vnni": BlockedMatmulKey(1, 2, 2, 64, 128, 128, "bf16",
                                     beta0=True, vnni=2, binary_kind="add",
                                     unary_kind="relu"),
    "masked-mb8-gelu": BlockedMatmulKey(2, 3, 2, 8, 40, 48, "bf16",
                                        out_dtype="f32", vnni=2,
                                        binary_kind="add",
                                        unary_kind="gelu"),
    "warm-f32-default-r3": BlockedMatmulKey(1, 2, 2, 32, 128, 128,
                                            beta0=True, binary_kind="add",
                                            unary_kind="relu", repeats=3),
    "warm-f32-r3": BlockedMatmulKey(1, 2, 2, 32, 128, 128, beta0=True,
                                    binary_kind="add", unary_kind="relu",
                                    precision="highest", repeats=3),
    "warm-bf16-vnni-r3": BlockedMatmulKey(2, 2, 2, 24, 64, 64, "bf16",
                                          beta0=True, vnni=2,
                                          binary_kind="add",
                                          unary_kind="relu", repeats=3),
}


@pytest.mark.parametrize("name", list(BLOCKED))
def test_blocked_matmul_kernel_matches_plain(cuda, name):
    key = BLOCKED[name]
    g = cuda
    a = _rnd(g, (key.Mb, key.Kb, key.mb, key.kb), key.dtype)
    b = _rnd(g, (key.Nb, key.Kb, key.kb, key.nb), key.dtype,
             (key.Kb * key.kb) ** -0.5)
    if key.vnni:
        b = b.reshape(key.Nb, key.Kb, key.kb // 2, 2, key.nb) \
            .movedim(-2, -1).contiguous()
    c = None if key.beta0 else _rnd(g, (key.Mb, key.Nb, key.mb, key.nb),
                                    "f32")
    d = _rnd(g, (key.Nb, key.nb), "f32") if key.binary_kind else None
    kern = build_kernel(key)
    got = kern(a, b, c, d)
    want = reference_kernel(key)(a, b, c, d)
    torch.cuda.synchronize()
    assert got.shape == (key.Mb, key.Nb, key.mb, key.nb)
    assert kern.launches == 1
    out_f32 = (key.out_dtype or key.dtype) == "f32"
    # B20 re-rounds its state to the MXU dtype every repeat
    tol = 1e-4 if out_f32 and (not key.repeats
                               or key.precision == "highest") else 1e-2
    assert _err(got, want) <= tol


CONV_BLOCKED = {
    "c128-30-bias-relu": ConvBrgemmKey(N=2, H=12, W=12, Cb=1, c=128, Kb=1,
                                       k=128, R=3, S=3, beta0=True,
                                       binary_kind="add", unary_kind="relu"),
    "cb2-highest-c-acc": ConvBrgemmKey(N=2, H=8, W=8, Cb=2, c=64, Kb=2, k=64,
                                       R=3, S=3, precision="highest",
                                       unary_kind="relu"),
    "bf16-masked-c16": ConvBrgemmKey(N=2, H=7, W=9, Cb=2, c=16, Kb=3, k=24,
                                     R=3, S=2, dtype="bf16", beta0=True,
                                     binary_kind="add"),
}


@pytest.mark.parametrize("name", list(CONV_BLOCKED))
def test_conv_blocked_kernel_matches_plain(cuda, name):
    key = CONV_BLOCKED[name]
    g = cuda
    i = _rnd(g, (key.N, key.Cb, key.H, key.W, key.c), key.dtype)
    w = _rnd(g, (key.Kb, key.Cb, key.R, key.S, key.c, key.k), key.dtype,
             (key.Cb * key.c) ** -0.5)
    c = None if key.beta0 else _rnd(g, (key.N, key.Kb, key.P, key.Q, key.k),
                                    "f32")
    d = _rnd(g, (key.Kb, key.k), "f32") if key.binary_kind else None
    kern = build_kernel(key)
    got = kern(i, w, c, d)
    want = reference_kernel(key)(i, w, c, d)
    torch.cuda.synchronize()
    assert got.shape == (key.N, key.Kb, key.P, key.Q, key.k)
    assert kern.launches == 1
    assert _err(got, want) <= (1e-4 if key.dtype == "f32" else 1e-2)


@pytest.mark.parametrize("entry", [
    {"gen": "--batch=64 --layers=1024,1024,1024 --bias --relu "
            "--float-type=bf16"},
    {"model": 'convnet:{"batch": 2, "channels": 128, "filters": 128, '
              '"height": 10, "width": 10, "layers": 2}'},
    {"model": 'resnet_block:{"batch": 2, "channels": 128, "hw": 8}'},
], ids=["mlp-bf16", "convnet-2layer", "resnet_block"])
def test_packed_nets_on_the_card_match_linalg_to_loops(cuda, entry):
    from tpp_mlir_tpu_torch.tools.bench_driver import run_entry
    cache = global_cache()
    cache.reset_launches()
    res = run_entry({**entry, "pipeline": "default-tpp-passes-packed"},
                    n=3, device="cuda", out_stream=io.StringIO())
    kinds = cache.launches_by_kind()
    assert kinds.get("BlockedMatmulKey", 0) + kinds.get("ConvBrgemmKey", 0) \
        >= 2
    got = res["lowered"]["outputs"][0]
    want = res["baseline"]["outputs"][0]
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= 3e-2
