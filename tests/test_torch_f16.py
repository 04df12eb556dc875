"""f16 keys (ROADMAP A14) on the port's GEMM family: B1 (BrgemmKey), B3-B5
(ChainKey), B19/B20 (BlockedMatmulKey) and the xsmm.unary/binary ops.

On the CPU the port runs the kernels' plain versions; each is held here to
the JAX package on the same seeded numpy inputs cast to float16, the JAX
side through `build_kernel(key, interpret=True)` (its Pallas bodies) or its
own `run_module`. Tolerances:
  * the three keys of tests/xsmm/test_kernels.py:661 test_f16_kernel_family
    at that test's own tolerances (f16 operands, f32 sums in another order,
    one rounding to f16 on each side: an ulp, ~1e-3 relative);
  * tpp-gen's f16 MLPs (tests/integration/test_gen_configs.py's f16 rows:
    flat, --vnni=2, --tiles=32,32,32 --vnni=2) through both executors,
    lowered and --linalg-to-loops, max|port - jax| / max|jax| <= 2e-3;
  * tensor_init in f16 and the functional ops: bit-equal and 2e-3.
The route tests hold what the card would run: f16 products at either
precision, and no f16 key's route, plan or launch arguments naming a
loader that rounds to bf16 (the launch arguments read from a recording
stand-in for the kernel library, since the CPU has none). The card's own
check that the products are f16 (A = 1 + 2^-10) is
tests/test_torch_cuda.py's test_f16_products_are_not_bf16.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu import ops as jax_ops
from tpp_mlir_tpu.ir import parse_module as jax_parse_module
from tpp_mlir_tpu.runtime.executor import interpret as jax_interpret
from tpp_mlir_tpu.runtime.tensor_init import tensor_init as jax_tensor_init
from tpp_mlir_tpu.tools.mlir_gen import build_parser as jax_gen_parser
from tpp_mlir_tpu.tools.mlir_gen import config_from_args as jax_gen_config
from tpp_mlir_tpu.tools.mlir_gen import generate_text as jax_generate
from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
from tpp_mlir_tpu.xsmm.decode_attn import DecodeAttnKey as JaxDecodeKey
from tpp_mlir_tpu.xsmm.decode_attn import build_decode_attn
from tpp_mlir_tpu.xsmm.flash_train import FlashTrainKey as JaxTrainKey
from tpp_mlir_tpu.xsmm.flash_train import build_flash_train_fwd
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch import ops
from tpp_mlir_tpu_torch.runtime.tensor_init import tensor_init, to_torch
from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser,
                                               config_from_args,
                                               generate_text)
from tpp_mlir_tpu_torch.tools.tpp_run import load_module, run_module
from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                     BrgemmKey, ChainKey, ConvBrgemmKey,
                                     ConvNhwcKey, DecodeAttnKey, FlashMhaKey,
                                     FlashTrainKey, GroupedGemmKey,
                                     GroupedWgradKey, Int8GemmKey,
                                     LayerNormKey, build_kernel)
from tpp_mlir_tpu_torch.xsmm import build as kbuild
from tpp_mlir_tpu_torch.xsmm import kernels, reference

F16 = torch.float16


def _f16(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float16)


def _ref_key(key):
    return getattr(ref_flags, type(key).__name__)(**dataclasses.asdict(key))


def _err(got, want) -> float:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


# tests/xsmm/test_kernels.py:661-684: (key, inputs, atol, rtol)
FAMILY = {
    "brgemm-f32-out": (
        BrgemmKey(batch=2, m=32, n=128, k=64, dtype="f16", out_dtype="f32",
                  beta0=True),
        lambda: (_f16((2, 32, 64), 0), _f16((2, 64, 128), 1)), 1e-5, 1e-3),
    "brgemm-f16-bias-relu": (
        BrgemmKey(batch=1, m=32, n=128, k=64, dtype="f16", out_dtype="f16",
                  beta0=True, binary_kind="add", unary_kind="relu"),
        lambda: (_f16((1, 32, 64), 2), _f16((1, 64, 128), 3), None,
                 _f16((128,), 4)), 2e-3, 2e-3),
    "chain": (
        ChainKey(m=16, dims=(64, 128, 64), dtype="f16", has_bias=True,
                 unary_kind="relu", last_unary=None),
        lambda: (_f16((16, 64), 5), _f16((64, 128), 6), _f16((128,), 8),
                 _f16((128, 64), 7), _f16((64,), 9)), 2e-3, 2e-2),
}


@pytest.mark.parametrize("name", list(FAMILY))
def test_f16_kernel_family_matches_pallas_interpret(name):
    key, make, atol, rtol = FAMILY[name]
    args = make()
    kern = build_kernel(key)
    got = kern(*(None if a is None else to_torch(a) for a in args))
    want = jax_build_kernel(_ref_key(key), interpret=True)(
        *(None if a is None else jnp.asarray(a) for a in args))
    assert got.dtype == reference.DTYPES[key.out_dtype or key.dtype]
    assert kern.launches == 0
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# B5's ping-pong and B4/B20's repeats at f16: the state held in f16
# between repeats on both sides (He-scaled weights keep it in range)
REPEATS = {
    "b4-chain-bench": ChainKey(m=16, dims=(64, 64, 64), dtype="f16",
                               repeats=3),
    "b5-pingpong": ChainKey(m=16, dims=(64, 96), dtype="f16", repeats=3,
                            pingpong=True),
    "b20-warm-vnni": BlockedMatmulKey(1, 2, 2, 16, 32, 32, "f16", vnni=2,
                                      repeats=3, beta0=True,
                                      binary_kind="add", unary_kind="relu"),
}


@pytest.mark.parametrize("name", list(REPEATS))
def test_f16_repeats_match_pallas_interpret(name):
    key = REPEATS[name]
    if isinstance(key, ChainKey):
        dims = key.dims
        args = [_f16((key.m, dims[0]), 0)]
        for li, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
            args += [_f16((k, n), 1 + li, (2 / k) ** 0.5),
                     _f16((n,), 10 + li, 0.1)]
    else:
        K = key.Kb * key.kb
        args = [_f16((key.Mb, key.Kb, key.mb, key.kb), 0),
                _f16((key.Nb, key.Kb, key.kb // 2, key.nb, 2), 1,
                     (2 / K) ** 0.5), None, _f16((key.Nb, key.nb), 2, 0.1)]
    got = build_kernel(key)(*(None if a is None else to_torch(a)
                              for a in args))
    want = jax_build_kernel(_ref_key(key), interpret=True)(
        *(None if a is None else jnp.asarray(a) for a in args))
    assert got.dtype == F16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-3,
                               rtol=2e-2)


# tests/integration/test_gen_configs.py's f16 rows
GEN = {
    "flat": "--batch=16 --layers=64,64 --bias --relu --float-type=f16",
    "vnni": "--batch=16 --layers=64,64 --bias --relu --float-type=f16 "
            "--vnni=2",
    "tiles": "--batch=64 --layers=64,64 --tiles=32,32,32 --float-type=f16 "
             "--vnni=2",
    "chain": "--batch=16 --layers=64,64,64 --bias --relu --float-type=f16",
}
GEN_RUNS = [(n, p) for n in GEN for p in ("default-tpp-passes",
                                          "default-tpp-passes-packed")]


@pytest.mark.parametrize("l2l", [False, True], ids=["lowered", "l2l"])
@pytest.mark.parametrize("name,pipeline", GEN_RUNS,
                         ids=[f"{n}-{p.rsplit('-', 1)[-1]}"
                              for n, p in GEN_RUNS])
def test_gen_f16_runs_like_the_jax_package(name, pipeline, l2l):
    flags = GEN[name].split()
    text = generate_text(config_from_args(build_parser().parse_args(flags)))
    jtext = jax_generate(jax_gen_config(jax_gen_parser().parse_args(flags)))
    assert text == jtext
    got = run_module(load_module(text), init_type="rand", seed=11,
                     device="cpu", pipeline=pipeline, linalg_to_loops=l2l,
                     out_stream=io.StringIO())
    want = jax_run_module(jax_parse_module(jtext), init_type="rand",
                          seed=11, pipeline=pipeline, linalg_to_loops=l2l,
                          out_stream=io.StringIO())
    g, w = got["outputs"][0], want["outputs"][0]
    assert g.dtype == F16 and str(np.asarray(w).dtype) == "float16"
    assert torch.isfinite(g.float()).all()
    assert _err(g, w) <= 2e-3
    if not l2l:
        ops_ = [op.opname for op in got["module"]["entry"].ops
                if op.opname.startswith("xsmm.")
                and not op.opname.endswith("_dispatch")]
        assert ops_ and all(o in ("xsmm.fused_brgemm", "xsmm.brgemm",
                                  "xsmm.gemm", "xsmm.fused_chain",
                                  "xsmm.unary", "xsmm.binary")
                            for o in ops_), ops_


@pytest.mark.parametrize("kind", ["rand", "normal", "simple", "cont",
                                  "const", "identity"])
def test_tensor_init_f16_is_the_jax_copy_bit_for_bit(kind):
    shape = (24, 24)
    got = tensor_init(kind, shape, "f16", seed=5)
    want = np.asarray(jax_tensor_init(kind, shape, "f16", seed=5))
    assert got.dtype == F16
    np.testing.assert_array_equal(got.numpy().view(np.int16),
                                  want.view(np.int16))


@pytest.mark.parametrize("with_c,out_dtype,transpose_b", [
    (False, None, False), (True, None, False), (False, "f32", False),
    (False, None, True)])
def test_ops_gemm_f16_matches_jax(with_c, out_dtype, transpose_b):
    m, n, k = 48, 80, 96
    a = _f16((m, k), 0)
    b = _f16((n, k) if transpose_b else (k, n), 1)
    c = _f16((m, n), 2) if with_c else None
    got = ops.gemm(to_torch(a), to_torch(b),
                   None if c is None else to_torch(c), out_dtype=out_dtype,
                   transpose_b=transpose_b)
    want = jax_ops.gemm(jnp.asarray(a), jnp.asarray(b),
                        None if c is None else jnp.asarray(c),
                        out_dtype=out_dtype, transpose_b=transpose_b,
                        interpret=True)
    assert got.dtype == reference.DTYPES[out_dtype or "f16"]
    assert _err(got, want) <= 2e-3


@pytest.mark.parametrize("bias,activation", [(True, "relu"), (False, "gelu"),
                                             (True, None)])
def test_ops_fused_mlp_layer_f16_matches_jax(bias, activation):
    m, k, n = 32, 64, 48
    x, w = _f16((m, k), 3), _f16((k, n), 4, 0.2)
    bv = _f16((n,), 5) if bias else None
    got = ops.fused_mlp_layer(to_torch(x), to_torch(w),
                              None if bv is None else to_torch(bv),
                              activation=activation)
    want = jax_ops.fused_mlp_layer(jnp.asarray(x), jnp.asarray(w),
                                   None if bv is None else jnp.asarray(bv),
                                   activation=activation, interpret=True)
    assert got.dtype == F16
    assert _err(got, want) <= 2e-3


# ---- routes, plans and launch arguments ---------------------------------

def test_f16_products_are_f16_at_either_precision():
    for precision in ("default", "highest"):
        assert reference.mxu_dtype("f16", precision) is torch.float16
    # f32 "default" keeps its bf16 products
    assert reference.mxu_dtype("f32", "default") is torch.bfloat16


class _Recorder:
    """A stand-in for the kernel library: records each C entry's
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


# each f16 key of the slice, the route its launcher takes, and its inputs
ROUTED = {
    "b1-tma": (BrgemmKey(1, 32, 64, 64, "f16", beta0=True,
                         binary_kind="add", unary_kind="relu"), "tma"),
    "b1-tma-highest": (BrgemmKey(1, 32, 64, 64, "f16", beta0=True,
                                 precision="highest"), "tma"),
    "b1-transpose-b": (BrgemmKey(1, 32, 64, 64, "f16", beta0=True,
                                 transpose_b=True), "tma"),
    "b1-convert-n36": (BrgemmKey(1, 32, 36, 64, "f16", beta0=True), "convert"),
    "b1-vnni-c-f32-out": (BrgemmKey(2, 32, 64, 64, "f16", out_dtype="f32",
                                    vnni=2), "tma"),
    "b3-panel": (ChainKey(m=32, dims=(64, 64, 64), dtype="f16"), "panel"),
    "b4-panel": (ChainKey(m=32, dims=(64, 64), dtype="f16", repeats=5),
                 "panel"),
    "b5-panel": (ChainKey(m=32, dims=(64, 128), dtype="f16", repeats=3,
                          pingpong=True), "panel"),
    "b19-tma": (BlockedMatmulKey(1, 2, 2, 32, 64, 64, "f16", beta0=True,
                                 binary_kind="add", unary_kind="relu"),
                "tma"),
    "b19-vnni-convert": (BlockedMatmulKey(1, 2, 2, 32, 64, 64, "f16",
                                          vnni=2, beta0=True), "convert"),
    "b19-c": (BlockedMatmulKey(1, 2, 2, 32, 64, 64, "f16"), "tma"),
    "b20-panel": (BlockedMatmulKey(1, 2, 2, 32, 64, 64, "f16", vnni=2,
                                   repeats=3, beta0=True, binary_kind="add",
                                   unary_kind="relu"), "panel"),
}


def _inputs(key):
    """CPU tensors of the shapes the key's launcher checks."""
    def t(*shape, dt=F16):
        return torch.zeros(shape, dtype=dt)
    if isinstance(key, BrgemmKey):
        b = (key.batch, key.k // 2, key.n, 2) if key.vnni else \
            (key.batch, key.n, key.k) if key.transpose_b else \
            (key.batch, key.k, key.n)
        return (t(key.batch, key.m, key.k), t(*b),
                None if key.beta0 else t(key.m, key.n),
                t(key.n) if key.binary_kind else None)
    if isinstance(key, ChainKey):
        args = [t(key.m, key.dims[0])]
        for k, n in zip(key.dims[:-1], key.dims[1:]):
            args += [t(k, n), t(n)]
        return tuple(args)
    b = (key.Nb, key.Kb, key.kb // 2, key.nb, 2) if key.vnni else \
        (key.Nb, key.Kb, key.kb, key.nb)
    return (t(key.Mb, key.Kb, key.mb, key.kb), t(*b),
            None if key.beta0 else t(key.Mb, key.Nb, key.mb, key.nb),
            t(key.Nb, key.nb) if key.binary_kind else None)


# the product-type argument's place in each C entry (xsmm/build.py)
_ENTRY = {"tpp_brgemm": (10, 11, 21), "tpp_chain": (8, 9, None),
          "tpp_blocked_matmul": (13, 14, 22)}


@pytest.mark.parametrize("name", list(ROUTED))
def test_no_f16_key_reaches_a_bf16_rounding_loader(name, monkeypatch):
    """The route, the plan and the arguments each f16 launch passes: f16
    operands and f16 products (code 2), never the bf16 products (code 1)
    that make the convert loader and the warm-panel engine round to bf16;
    a GEMM plan from the wgmma tiles (not the f32-FMA body); a warm plan
    (the engine's f16 kernel) where the chain would run it."""
    key, route = ROUTED[name]
    rec = _Recorder()
    monkeypatch.setattr(kbuild, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda: None)
    kern = build_kernel(key)
    assert kern.route == route
    if isinstance(key, ChainKey):
        assert reference.chain_route(key) == route
        assert isinstance(kern.plan, reference.WarmPlan)
    elif isinstance(key, BlockedMatmulKey) and key.repeats:
        assert reference.warm_route(key) == route
        assert isinstance(kern.plan, reference.WarmPlan)
    else:
        assert kern.plan in [reference.GemmPlan(bm, bn, kern.plan.split)
                             for bm, bn in reference.GEMM_TILES]
        kern._launch.work_bytes = 0     # no card: no workspace to size
    kern._launch(*_inputs(key))
    (entry, args), = rec.calls
    i_in, i_mma, i_route = _ENTRY[entry]
    assert args[i_in] == kernels._DT_CODE[F16] == 2
    assert args[i_mma] == 2
    if i_route is not None and not getattr(key, "repeats", 0):
        assert args[i_route] == kernels._GEMM_ROUTE_CODE[route]


@pytest.mark.parametrize("route", ["wmma"])
@pytest.mark.parametrize("name", ["b3-panel", "b5-panel", "b20-panel"])
def test_the_first_design_runs_f16_products_too(name, route, monkeypatch):
    """The warm-panel engine's first design, forced, passes f16 products
    (its WMMA tiles in f16) and no plan."""
    from tpp_mlir_tpu_torch.xsmm.kernels import build_warm
    key, _ = ROUTED[name]
    rec = _Recorder()
    monkeypatch.setattr(kbuild, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda: None)
    kern = build_warm(key, route)
    assert kern.route == route and kern.plan is None
    kern._launch(*_inputs(key))
    (entry, args), = rec.calls
    assert args[_ENTRY[entry][1]] == 2


def test_f16_sizes_as_two_bytes():
    assert kernels.chain_smem_bytes(1024, torch.float16) == \
        kernels.chain_smem_bytes(1024, torch.bfloat16)
    assert kernels.blocked_warm_smem_bytes(1024, torch.float16) == \
        kernels.blocked_warm_smem_bytes(1024, torch.bfloat16)
    f16 = ChainKey(m=256, dims=(1024,) * 3, dtype="f16")
    bf16 = dataclasses.replace(f16, dtype="bf16")
    assert kernels.chain_fits_smem(f16)
    assert reference.warm_plan(f16) == reference.warm_plan(bf16)
    fc = BlockedMatmulKey(1, 2, 2, 256, 512, 512, "f16", vnni=2,
                          repeats=100, beta0=True)
    assert reference.warm_plan(fc) == reference.warm_plan(
        dataclasses.replace(fc, dtype="bf16"))
    assert reference.gemm_plan(BrgemmKey(1, 256, 1024, 1024, "f16")) == \
        reference.gemm_plan(BrgemmKey(1, 256, 1024, 1024, "bf16"))


# f16 keys once refused naming A14: the transformer family's (B12,
# attention, the batched matmul, B2's LayerNorm prologue and LN-stats
# producer) run since ROADMAP A14 items 1, 2, 3 and 5, the conv family's,
# B16/B17's and B15's f16 output since items 4, 6 and 7, B13's decode and
# B14's training forward since item 8 (NOW_RUN below); keys mixing 16-bit
# types keep refusing, naming A14; an f16 token key under flash_heads
# raises the reference's own refusal (FLASH_HEADS_REFUSAL)
OUTSIDE = {
    "layer-norm": LayerNormKey(m=8, n=64, dtype="f16"),
    "attention": FlashMhaKey(batch=2, seq=64, seq_kv=64, head_dim=64,
                             dtype="f16"),
    "batch-matmul": BatchMatmulKey(4, 16, 16, 16, "f16"),
    "ln-prologue": BrgemmKey(1, 8, 64, 64, "f16", beta0=True,
                             prologue="layer_norm"),
    "ln-stats-out": BrgemmKey(1, 8, 64, 64, "f16", beta0=True,
                              ln_stats_out=True),
    "conv-nhwc": ConvNhwcKey(N=1, H=8, W=8, C=16, K=16, R=3, S=3,
                             dtype="f16"),
    "conv-blocked": ConvBrgemmKey(N=1, H=8, W=8, Cb=1, c=16, Kb=1, k=16,
                                  dtype="f16"),
    "int8-f16-out": Int8GemmKey(m=16, n=16, k=16, out_dtype="f16"),
    "grouped": GroupedGemmKey(n_groups=2, m=16, n=16, k=16, bm=8,
                              dtype="f16"),
    "grouped-wgrad": GroupedWgradKey(n_groups=2, m=16, k=16, n=16, bm=8,
                                     dtype="f16"),
    "decode": DecodeAttnKey(batch=1, heads=2, seq=32, head_dim=64,
                            dtype="f16"),
    "flash-train": FlashTrainKey(batch=1, heads=2, seq=64, head_dim=64,
                                 dtype="f16"),
    # keys mixing 16-bit types (MIXED)
    "b1-bf16-to-f16": BrgemmKey(1, 8, 64, 64, "bf16", out_dtype="f16"),
    "b1-f16-to-bf16": BrgemmKey(1, 8, 64, 64, "f16", out_dtype="bf16"),
    "chain-f32-to-f16": ChainKey(m=8, dims=(64, 64), out_dtype="f16"),
    # a token key's flash_heads, which the reference's gate takes in
    # f32/bf16 only, and an attention key mixing f16 operands with a bf16
    # output (MIXED)
    "flash-heads": FlashMhaKey(batch=2, seq=64, seq_kv=64, head_dim=64,
                               dtype="f16", causal=True, heads=2,
                               strategy="flash_heads"),
    "attention-f16-to-bf16": FlashMhaKey(batch=2, seq=64, seq_kv=64,
                                         head_dim=64, dtype="f16",
                                         out_dtype="bf16"),
}
NOW_RUN = ("layer-norm", "attention", "batch-matmul", "ln-prologue",
           "ln-stats-out", "conv-nhwc", "conv-blocked", "int8-f16-out",
           "grouped", "grouped-wgrad", "decode", "flash-train")
# keys mixing 16-bit types, refused naming A14 until its last item: each
# runs now, held to the Pallas body in interpret mode at its output type's
# tolerance (tests/test_torch_f16_mixed.py holds every family's)
MIXED = ("b1-bf16-to-f16", "b1-f16-to-bf16", "chain-f32-to-f16",
         "attention-f16-to-bf16")
# the reference runs another kernel for an f16 flash_heads key without a
# word (its gate takes f32/bf16, kernels.py:1674-1681 there): the port
# refuses it in ADVICE.md #2's words, as every such forced strategy
FLASH_HEADS_REFUSAL = "ADVICE.md #2"


def _now_runs(key):
    """An OUTSIDE key of NOW_RUN built and run on seeded f16 inputs: its
    plain version against the Pallas body in interpret mode at 2e-3 (the
    JAX f16 test's rtol); the LN-stats producer at m 8, which the JAX
    package builds only as its weights-resident kernel (two m blocks or
    more), against the port's own B1 at the key without ln_stats_out
    (bit-equal) and numpy's row statistics of its output. The convs and
    B16 take f16 operands (the conv's C in f16), B17 xt (k, m) and dY in
    f16 (its dW is f32), B15 s8 operands and f32 scales. B13 (f32 out)
    and B14 (bf16 O, f32 lse2), which the JAX package builds in f16 only
    as their Pallas bodies, against those in interpret mode: B13 at 1e-5
    as tests/test_torch_decode_attn.py (f32 math from the same f16
    values), B14's O at 1e-2 as tests/test_torch_flash_train.py's bf16
    (P rounded to bf16 on both sides)."""
    rng = np.random.default_rng(9)
    kern = build_kernel(key)
    if isinstance(key, DecodeAttnKey):     # one layer's cache, every row
        q = _f16((key.batch, key.heads, key.head_dim), 21)
        k, v = (_f16((key.batch, key.heads, key.seq, key.head_dim), 22 + i)
                for i in range(2))
        pos = np.array([key.seq - 1], np.int32)
        got = kern(*map(to_torch, (q, k, v)), torch.from_numpy(pos))
        want = build_decode_attn(JaxDecodeKey(**dataclasses.asdict(key)),
                                 interpret=True)(*map(jnp.asarray,
                                                      (q, k, v, pos)))
        assert got.dtype == torch.float32 and kern.launches == 0
        assert _err(got, want) <= 1e-5
        return
    if isinstance(key, FlashTrainKey):     # (B, S, H, D) operands
        shape = (key.batch, key.seq, key.heads, key.head_dim)
        q, k, v = (_f16(shape, 24 + i) for i in range(3))
        o, lse2 = kern(*map(to_torch, (q, k, v)))
        jo, _ = build_flash_train_fwd(JaxTrainKey(**dataclasses.asdict(key)),
                                      True)(*(jnp.asarray(x.swapaxes(1, 2))
                                              for x in (q, k, v)))
        assert o.dtype == torch.bfloat16 and lse2.dtype == torch.float32
        assert kern.launches == 0
        assert _err(o, np.asarray(jo, np.float32).swapaxes(1, 2)) <= 1e-2
        return
    if isinstance(key, ConvNhwcKey):
        args = (_f16((key.N, key.H, key.W, key.C), 16),
                _f16((key.R, key.S, key.C, key.K), 17, 0.1),
                _f16((key.N, key.P, key.Q, key.K), 18))
    elif isinstance(key, ConvBrgemmKey):
        args = (_f16((key.N, key.Cb, key.H, key.W, key.c), 16),
                _f16((key.Kb, key.Cb, key.R, key.S, key.c, key.k), 17, 0.1),
                _f16((key.N, key.Kb, key.P, key.Q, key.k), 18))
    elif isinstance(key, Int8GemmKey):
        args = (rng.integers(-127, 128, (key.m, key.k)).astype(np.int8),
                rng.integers(-127, 128, (key.k, key.n)).astype(np.int8),
                (rng.random(key.m) * 0.02).astype(np.float32),
                (rng.random(key.n) * 0.02).astype(np.float32))
    elif isinstance(key, (GroupedGemmKey, GroupedWgradKey)):
        ge = np.arange(key.m // key.bm, dtype=np.int32) % key.n_groups
        args = (ge, _f16((key.m, key.k), 19).T, _f16((key.m, key.n), 20)) \
            if isinstance(key, GroupedWgradKey) else \
            (ge, _f16((key.m, key.k), 19),
             _f16((key.n_groups, key.k, key.n), 20, 0.25))
    elif isinstance(key, LayerNormKey):
        args = (_f16((key.m, key.n), 1), _f16((key.n,), 2),
                _f16((key.n,), 3))
    elif isinstance(key, FlashMhaKey):
        args = tuple(_f16((key.batch, s, key.head_dim), 4 + i)
                     for i, s in enumerate((key.seq, key.seq_kv,
                                            key.seq_kv)))
    elif isinstance(key, BatchMatmulKey):
        args = (_f16((key.batch, key.m, key.k), 7),
                _f16((key.batch, key.k, key.n), 8),
                rng.standard_normal((key.batch, key.m, key.n))
                .astype(np.float32))
    elif getattr(key, "prologue", None):
        args = (_f16((1, key.m, key.k), 10, 3.0), _f16((1, key.k, key.n), 11,
                                                       0.1),
                None, None, _f16((key.k,), 12), _f16((key.k,), 13))
    else:
        a, b = _f16((1, key.m, key.k), 14), _f16((1, key.k, key.n), 15, 0.1)
        y, mu, var = kern(to_torch(a), to_torch(b))
        plain = dataclasses.replace(key, ln_stats_out=False)
        assert torch.equal(y, build_kernel(plain)(to_torch(a), to_torch(b)))
        yf = y.float().numpy()
        np.testing.assert_allclose(mu.numpy()[:, 0], yf.mean(1), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(var.numpy()[:, 0], yf.var(1), rtol=1e-4,
                                   atol=1e-6)
        return
    got = kern(*(None if a is None else to_torch(a) for a in args))
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    if getattr(key, "prologue", None):
        want = jax_build_kernel(_ref_key(key), interpret=True)(
            *jargs[:4], gamma=jargs[4], beta=jargs[5])
    else:
        want = jax_build_kernel(_ref_key(key), interpret=True)(*jargs)
    out = torch.float32 if isinstance(key, GroupedWgradKey) else F16
    assert got.dtype == out and kern.launches == 0
    assert _err(got, want) <= 2e-3


def _mixed_runs(key):
    """A MIXED key on seeded operands of its own dtype (f32 ones rounded
    to bf16 values first: the port's "default" products round them, the
    JAX interpret mode keeps f32), its plain version against the Pallas
    body at 1e-2 for a bf16 output and 2e-3 (the JAX f16 test's rtol) for
    an f16 one."""
    np_dt = {"f32": np.float32, "bf16": jnp.bfloat16, "f16": np.float16}
    rng = np.random.default_rng(10)

    def arr(*shape, scale=1.0):
        x = rng.standard_normal(shape) * scale
        if key.dtype == "f32":
            x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        return x.astype(np_dt[key.dtype])
    if isinstance(key, BrgemmKey):
        args = (arr(1, key.m, key.k), arr(1, key.k, key.n, scale=0.125),
                arr(key.m, key.n))
    elif isinstance(key, ChainKey):
        args = (arr(key.m, key.dims[0]),
                arr(*key.dims, scale=key.dims[0] ** -0.5),
                arr(key.dims[1], scale=0.1))
    else:
        args = tuple(arr(key.batch, s, key.head_dim)
                     for s in (key.seq, key.seq_kv, key.seq_kv))
    kern = build_kernel(key)
    got = kern(*map(to_torch, args))
    want = jax_build_kernel(_ref_key(key), interpret=True)(
        *map(jnp.asarray, args))
    assert got.dtype == reference.DTYPES[key.out_dtype]
    assert kern.launches == 0
    assert _err(got, np.asarray(jnp.asarray(want, jnp.float32))) <= \
        (1e-2 if key.out_dtype == "bf16" else 2e-3)


@pytest.mark.parametrize("name", list(OUTSIDE))
def test_f16_keys_outside_the_slice_name_a14(name):
    if name in NOW_RUN:
        _now_runs(OUTSIDE[name])
        return
    if name in MIXED:
        _mixed_runs(OUTSIDE[name])
        return
    with pytest.raises(NotImplementedError, match=FLASH_HEADS_REFUSAL):
        build_kernel(OUTSIDE[name])


def _f16_dispatch_module(dispatch, invoke, attrs, operands, out):
    """One lowered f16 dispatch and its invoke, as the port's passes write
    them."""
    from tpp_mlir_tpu_torch.ir import I64, Function, Module, TensorType, \
        TppBuilder
    types = [TensorType(s, "f16") for s in operands]
    m = Module()
    f = m.add(Function("entry", types, [f"a{i}" for i in range(len(types))]))
    b = TppBuilder(f)
    d = b.create(dispatch, [], [I64], {"dtype": "f16", **attrs})
    f.returns = [b.create(invoke, [d.result, *f.args],
                          [TensorType(out, "f16")]).result]
    return m


# f16 IR once refused by verify-slice, naming A14, before anything ran: the
# LayerNorm prologue's and B12's pass verify-slice and run since ROADMAP
# A14 items 1 and 2, the NHWC conv's since items 4 and 6, and an f16
# tl.generic since item 8 (IR_NOW_RUN)
F16_IR_OUTSIDE = {
    "ln-prologue": ("xsmm.fused_brgemm_dispatch", "xsmm.fused_brgemm",
                    dict(batch=1, m=8, n=64, k=64, flags=("beta_0",),
                         binary_kind="add", binary_bcast="bcast_col",
                         unary_kind="none", prologue="layer_norm"),
                    [(1, 8, 64), (1, 64, 64), (8, 64), (64,), (64,), (64,)],
                    (8, 64)),
    "layer-norm": ("xsmm.layer_norm_dispatch", "xsmm.layer_norm",
                   dict(m=8, n=64), [(8, 64), (64,), (64,)], (8, 64)),
    "conv-nhwc": ("xsmm.brgemm_dispatch", "xsmm.brgemm",
                  dict(layout="conv_nhwc", N=2, H=8, W=8, C=16, K=16, R=3,
                       S=3, m=0, n=16, k=16, batch=144, strides=(1, 1),
                       flags=()),
                  [(2, 8, 8, 16), (3, 3, 16, 16), (2, 6, 6, 16)],
                  (2, 6, 6, 16)),
    "generic": (None, None, None, [(8, 16), (8, 16)], (8, 16)),
}


IR_NOW_RUN = ("ln-prologue", "layer-norm", "conv-nhwc", "generic")


def _f16_generic_module():
    """An elementwise f16 tl.generic (a * b), which the JAX package's
    evaluator and the port's run by widening to f32 and rounding once."""
    from tpp_mlir_tpu_torch.ir import Function, Module, TensorType, \
        TppBuilder
    m = Module()
    t = TensorType((8, 16), "f16")
    f = m.add(Function("entry", [t, t], ["a0", "a1"]))
    f.returns = [TppBuilder(f).generic(
        [f.args[0], f.args[1]], f.args[0], [(0, 1), (0, 1), (0, 1)],
        ("parallel", "parallel"), ("mul", ("arg", 0), ("arg", 1)))]
    m.verify()
    return m


@pytest.mark.parametrize("name", list(F16_IR_OUTSIDE))
def test_verify_slice_refuses_f16_ir_outside_the_gemm_family(name):
    from tpp_mlir_tpu_torch.passes import run_pipeline
    from tpp_mlir_tpu_torch.runtime import compile as port_compile
    module = _f16_generic_module() if name == "generic" else \
        _f16_dispatch_module(*F16_IR_OUTSIDE[name])
    if name in IR_NOW_RUN:
        # verify-slice admits it, and the executor runs it to the f16
        # output its invoke declares, within one kernel's f16 tolerance of
        # the JAX package's evaluator on the same IR (Pallas bodies in
        # interpret mode)
        run_pipeline(module, "verify-slice")
        shapes = F16_IR_OUTSIDE[name][3]
        args = [_f16(s, 20 + i) for i, s in enumerate(shapes)]
        got = port_compile(module, device="cpu")(*map(to_torch, args))
        want, = jax_interpret(jax_parse_module(str(module)), "entry",
                              *map(jnp.asarray, args),
                              interpret_kernels=True)
        assert got.dtype == F16 and tuple(got.shape) == \
            F16_IR_OUTSIDE[name][4]
        assert torch.isfinite(got.float()).all()
        assert _err(got, want) <= 2e-3
        if name == "generic":   # both evaluators: f32, one rounding
            assert np.array_equal(got.numpy(), np.asarray(want))
        return
    with pytest.raises(NotImplementedError, match="A14") as e:
        run_pipeline(module, "verify-slice")
    assert "outside the port's slice" in str(e.value)
