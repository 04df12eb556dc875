"""f16 keys (ROADMAP A14 item 8) of the attention kernels the earlier f16
slices left out: decode attention (B13, DecodeAttnKey, csrc/decode_attn.cu)
and the training attention's forward and backward (B14 FlashTrainKey on
attention.cu's training mode, B18 FlashTrainBwdKey on flash_train.cu's
wgmma passes); and the f16 tl.generic, which verify-slice once refused.

On the CPU the port runs the kernels' plain versions; each is held here to
the JAX package's Pallas body in interpret mode on the same seeded numpy
inputs cast to float16 (what the JAX package's f16 keys mean: its compiled
path has no f16 form of these kernels). Error measure: max|port - jax| /
max|jax|. Tolerances:
  * B13: 1e-5, as tests/test_torch_decode_attn.py (both sides compute in
    f32 from the same f16 values; f32 out; sum order only);
  * B14/B18: 1e-2, as tests/test_torch_flash_train.py's bf16 (both sides
    round P and dS to bf16 and store bf16 O, dQ, dK and dV, as the JAX
    package's `_pv_dtype` and `odt` do for f16 operands; a sum-order
    difference can flip a rounding);
  * the tl.generic: bit-equal through both packages' run_module.
The route test holds what the card would run: each f16 key's launch passes
the f16 operand code, an f16 K/V code distinct from int8's, the wgmma
route, and bf16 outputs (the launch arguments read from a recording
stand-in for the kernel library, since the CPU has none). The card's own
checks are tests/test_torch_cuda.py's f16 attention cases and
chip_smoke.py's phase_f16_attention.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.ir as jax_ir
from tpp_mlir_tpu.serving.quant import quantize_tokens as jax_quantize_tokens
from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
from tpp_mlir_tpu.xsmm.decode_attn import DecodeAttnKey as JaxDecodeKey
from tpp_mlir_tpu.xsmm.decode_attn import build_decode_attn
from tpp_mlir_tpu.xsmm.flash_train import FlashTrainKey as JaxTrainKey
from tpp_mlir_tpu.xsmm.flash_train import (build_flash_train_bwd,
                                           build_flash_train_fwd)
import tpp_mlir_tpu_torch.ir as port_ir
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.tools.tpp_run import run_module
from tpp_mlir_tpu_torch.xsmm import (DecodeAttnKey, FlashTrainBwdKey,
                                     FlashTrainKey, build_kernel)
from tpp_mlir_tpu_torch.xsmm import build as kbuild
from tpp_mlir_tpu_torch.xsmm import kernels, reference

F16, BF16 = torch.float16, torch.bfloat16
TOL_DECODE, TOL_TRAIN = 1e-5, 1e-2
L, LI = 2, 1     # a stacked cache of two layers, read at the second


def _f16(rng, shape):
    return rng.standard_normal(shape).astype(np.float16)


def _err(got, want) -> float:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


# ---- B13: decode attention over an f16 (or int8) KV cache ---------------

DECODE = {
    "mha": (DecodeAttnKey(2, 4, 32, 64, "f16", stacked=L), 20),
    "gqa-g3": (DecodeAttnKey(2, 2, 32, 32, "f16", groups=3, stacked=L), 12),
    "pack2": (DecodeAttnKey(2, 4, 32, 32, "f16", pack2=True, stacked=L), 17),
    "slotted": (DecodeAttnKey(2, 4, 32, 16, "f16", slotted=True, stacked=L),
                [5, 32]),
    "stacked-li1": (DecodeAttnKey(2, 4, 32, 64, "f16", stacked=L), 31),
    "f16-q-int8-kv": (DecodeAttnKey(2, 4, 32, 64, "f16", kv_quant=True,
                                    stacked=L), 25),
}


def _decode_operands(key, seed=0):
    """q, a stacked cache of L layers in f16 (or int8 payloads with f32
    scales, as the JAX engine quantizes tokens), pos, and the scales."""
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    rng = np.random.default_rng(seed)
    if key.pack2:
        q_shape, slab = (B, H // 2, 2 * D), (L, B, H // 2, S, 2 * D)
    else:
        q_shape = (B, H, D) if G == 1 else (B, H, G, D)
        slab = (L, B, H, S, D)
    q, k, v = _f16(rng, q_shape), _f16(rng, slab), _f16(rng, slab)
    scales = {}
    if key.kv_quant:
        jk, ks = jax_quantize_tokens(jnp.asarray(k, jnp.float32))
        jv, vs = jax_quantize_tokens(jnp.asarray(v, jnp.float32))
        k, v = np.array(jk), np.array(jv)
        scales = {"k_s": np.array(ks), "v_s": np.array(vs)}
    return q, k, v, scales


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_attn_f16_matches_pallas_interpret(name):
    key, pos = DECODE[name]
    q, k, v, scales = _decode_operands(key)
    pos = np.asarray(pos, np.int32)
    want = build_decode_attn(JaxDecodeKey(**dataclasses.asdict(key)),
                             interpret=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), LI,
        **{n: jnp.asarray(s) for n, s in scales.items()})
    kern = build_kernel(key)        # CPU tensors: the wrapper's plain path
    got = kern(*(torch.from_numpy(a) for a in (q, k, v, pos)), LI,
               **{n: torch.from_numpy(s) for n, s in scales.items()})
    assert kern.launches == 0
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert _err(got, want) <= TOL_DECODE


# ---- B14/B18: the training attention, bf16 P/dS and bf16 outputs --------

# (causal, head_dim): B 2, S 24, H 4
TRAIN = {"causal-d32": (True, 32), "full-d32": (False, 32),
         "causal-d64": (True, 64), "full-d64": (False, 64)}
B, S, H = 2, 24, 4


def _t(x):          # (B, S, H, D) <-> (B, H, S, D)
    return np.ascontiguousarray(np.swapaxes(np.asarray(x), 1, 2))


@pytest.mark.parametrize("name", list(TRAIN))
def test_flash_train_f16_matches_pallas_interpret(name):
    """B14 and then B18 fed B14's lse2 and delta = rowsum(dO O) in f32, as
    the JAX custom VJP computes them (flash_train.py:258-262): O, dQ, dK
    and dV bf16 on both sides, lse2 f32 within 1e-5 (sum order only)."""
    causal, D = TRAIN[name]
    rng = np.random.default_rng(4)
    q, k, v, do = (_f16(rng, (B, S, H, D)) for _ in range(4))
    scale = D ** -0.5
    jkey = JaxTrainKey(B, H, S, D, "f16", causal, scale)
    jq, jk, jv, jdo = (jnp.asarray(_t(x)) for x in (q, k, v, do))
    jo, jl = build_flash_train_fwd(jkey, True)(jq, jk, jv)
    jdelta = jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), -1,
                     keepdims=True)
    jgrads = build_flash_train_bwd(jkey, True)(jq, jk, jv, jdo, jl, jdelta)

    key = FlashTrainKey(B, H, S, D, "f16", causal, scale)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    fwd, bwd = build_kernel(key), build_kernel(FlashTrainBwdKey(
        **dataclasses.asdict(key)))
    o, lse2 = fwd(tq, tk, tv)
    assert o.dtype == BF16 and str(jo.dtype) == "bfloat16"
    assert _err(o, _t(jo)) <= TOL_TRAIN
    assert _err(lse2, np.asarray(jl)[..., 0]) <= 1e-5
    delta = (tdo.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    grads = bwd(tq, tk, tv, tdo, lse2, delta)
    for g, w in zip(grads, jgrads):
        assert g.dtype == BF16 and str(w.dtype) == "bfloat16"
        assert _err(g, _t(w)) <= TOL_TRAIN
    assert fwd.launches == bwd.launches == 0


def test_flash_train_f16_rounds_p_to_bf16_not_f16():
    """B14's plain version rounds an f16 key's P to bf16, as the JAX
    package does: its O is bit-equal to P rounded to bf16 times V, divided
    by the f32 row sum, and differs from P rounded to f16 (what the key's
    own dtype would give)."""
    rng = np.random.default_rng(5)
    D = 32
    q, k, v = (torch.from_numpy(_f16(rng, (B, S, H, D))) for _ in range(3))
    key = FlashTrainKey(B, H, S, D, "f16", True, D ** -0.5)
    o, _ = reference.flash_train_fwd_reference(key)(q, k, v)
    assert reference.flash_train_pv_dtype(key) == BF16
    s2 = reference._logits2(key, q, k)
    p = torch.exp2(s2 - s2.amax(-1, keepdim=True))

    def attend(dt):
        return (p.to(dt).float() @ v.transpose(1, 2).float()
                / p.sum(-1, keepdim=True)).transpose(1, 2).to(BF16)
    assert torch.equal(o, attend(BF16))
    assert not torch.equal(o, attend(F16))


# ---- routes, plans and the launch arguments ------------------------------

def test_f16_routes_and_plans_equal_their_bf16_twins():
    """f16 takes bf16's routes and plans (2-byte elements): B13's chunk and
    splits, B14's and B18's wgmma route at every head dim, causal or
    not; f32 keeps the FMA route."""
    for key, _ in DECODE.values():
        bf16 = dataclasses.replace(key, dtype="bf16")
        assert reference.decode_attn_plan(key) == \
            reference.decode_attn_plan(bf16)
    serving = DecodeAttnKey(8, 12, 1024, 64, "f16", stacked=12)
    assert reference.decode_attn_plan(serving) == reference.decode_attn_plan(
        dataclasses.replace(serving, dtype="bf16")) == (128, 8)
    for d in (32, 64, 128):
        for causal in (True, False):
            key = FlashTrainKey(2, 4, 100, d, "f16", causal, 0.25)
            bf16 = dataclasses.replace(key, dtype="bf16")
            assert reference.flash_train_fwd_route(key) == \
                reference.flash_train_fwd_route(bf16) == "wgmma"
            assert reference.flash_train_bwd_route(key) == \
                reference.flash_train_bwd_route(bf16) == "wgmma"
            assert reference.flash_train_fwd_route(
                dataclasses.replace(key, dtype="f32")) == "fma"


def test_f16_kv_code_differs_from_int8():
    """decode_attn.cu reads its K/V code in the one dtype table of every C
    entry (csrc/epilogue.cuh's Dtype, xsmm/kernels.py _DT_CODE): an f16
    cache takes f16's code 2, an int8 one int8's 3, so an f16 cache can
    never read as int8."""
    codes = kernels._DT_CODE
    assert codes[F16] == 2 and codes[torch.int8] == 3
    assert len({codes[t] for t in (F16, torch.int8, BF16,
                                   torch.float32)}) == 4


class _Recorder:
    """A stand-in for the kernel library: records each entry's arguments
    and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _zeros(key):
    """CPU tensors of the shapes and dtypes each launcher checks."""
    if isinstance(key, DecodeAttnKey):
        q, k, v, scales = _decode_operands(key)
        n = key.batch if key.slotted else 1
        return (*(torch.from_numpy(a) for a in (q, k, v)),
                torch.zeros(n, dtype=torch.int32), LI), \
            {n_: torch.from_numpy(s) for n_, s in scales.items()}
    shape = (key.batch, key.seq, key.heads, key.head_dim)
    ops = [torch.zeros(shape, dtype=F16) for _ in range(3)]
    if isinstance(key, FlashTrainBwdKey):
        stat = (key.batch, key.heads, key.seq)
        ops += [torch.zeros(shape, dtype=F16), torch.zeros(stat),
                torch.zeros(stat)]
    return tuple(ops), {}


# each key, its C entry, and the places of its operand code, K/V code or
# route among the entry's arguments (xsmm/build.py)
ROUTED = {
    "decode-f16": (DECODE["mha"][0], "tpp_decode_attn", {17: 2, 18: 2}),
    "decode-f16-int8": (DECODE["f16-q-int8-kv"][0], "tpp_decode_attn",
                        {17: 2, 18: 3}),
    "flash-fwd-f16": (FlashTrainKey(2, 4, 64, 64, "f16"),
                      "tpp_flash_train_fwd", {9: 2, 12: 1}),
    "flash-bwd-f16": (FlashTrainBwdKey(2, 4, 64, 64, "f16"),
                      "tpp_flash_train_bwd", {13: 2, 17: 1}),
}


@pytest.mark.parametrize("name", list(ROUTED))
def test_f16_attention_launch_arguments(name, monkeypatch):
    """Each f16 key's launch passes the f16 operand code (2), decode's K/V
    code 2 for an f16 cache (3 for int8: the one dtype table), the wgmma
    route (1) for B14/B18,
    and B14/B18 allocate bf16 outputs; the library stand-in is bound
    before the kernel is built, as a launcher binds it there."""
    key, entry, want = ROUTED[name]
    rec = _Recorder()
    monkeypatch.setattr(kbuild, "library", lambda: rec)
    monkeypatch.setattr(kernels, "_stream", lambda: None)
    kern = build_kernel(key)
    args, kw = _zeros(key)
    out = kern._launch(*args, **kw)
    (called, cargs), = rec.calls
    assert called == entry
    assert {i: cargs[i] for i in want} == want
    if isinstance(key, FlashTrainKey):
        outs = out if isinstance(key, FlashTrainBwdKey) else out[:1]
        assert all(t.dtype == BF16 for t in outs)
    else:
        assert out.dtype == torch.float32


# ---- the f16 tl.generic ------------------------------------------------

def _generic(ir):
    """exp(a) * b + c over (8, 16) f16 tensors, one elementwise
    tl.generic."""
    m = ir.Module()
    t = ir.TensorType((8, 16), "f16")
    f = m.add(ir.Function("entry", [t, t, t], ["a0", "a1", "a2"]))
    f.returns = [ir.TppBuilder(f).generic(
        [f.args[0], f.args[1]], f.args[2], [(0, 1), (0, 1), (0, 1)],
        ("parallel", "parallel"),
        ("add", ("mul", ("exp", ("arg", 0)), ("arg", 1)), ("arg", 2)))]
    m.verify()
    return m


@pytest.mark.parametrize("l2l", [False, True], ids=["lowered", "l2l"])
def test_f16_generic_runs_to_the_jax_evaluators_bits(l2l):
    """verify-slice admits it, and run_module gives the JAX package's bits
    on the same seeded inputs: both evaluators widen to f32 and round
    once."""
    run_pipeline(_generic(port_ir), "verify-slice")
    got = run_module(_generic(port_ir), linalg_to_loops=l2l, device="cpu",
                     seed=3)["outputs"][0]
    want = jax_run_module(_generic(jax_ir), linalg_to_loops=l2l,
                          seed=3)["outputs"][0]
    assert got.dtype == F16 and tuple(got.shape) == (8, 16)
    assert torch.isfinite(got.float()).all()
    assert np.array_equal(got.numpy().view(np.uint16),
                          np.asarray(want).view(np.uint16))
