"""Keys that mix 16-bit types (ROADMAP A14's last item): f16 products with a
bf16 output, bf16 products with an f16 output, and f32 operands with an f16
output, on every kernel family with an `out_dtype`, and C, D, biases and
LayerNorm's gamma/beta stored in each of f32, bf16 and f16.

On the CPU the port runs the kernels' plain versions; each is held here to
the JAX package's Pallas bodies in interpret mode on the same seeded numpy
inputs. Error measure: max|port - jax| / max|jax|. Tolerances, by the
output's type: 1e-2 for a bf16 output (one bf16 ulp is 7.8e-3), 2e-3 for
an f16 output (tests/xsmm/test_kernels.py:677's f16 rtol), 5e-3 for an f16
chain (its f16-rounded layers between the products). f32 keys run at
precision "highest": the JAX interpret mode keeps exact f32 products, and
so does the port at "highest" (its "default" rounds the operands to bf16,
the compiled TPU kernels' semantics).

The rounding rule (the JAX bodies' own casts): every body but four casts an
f32 value once to `out_dtype`, so a mixed key stores one rounding of f32,
never a rounding through the products' type first; B4, B5, B20 and B11
keep their state in the products' type and cast that. The probes pin it
with exact f32 sums (test_rounding_probe_*).
"""

import dataclasses
import io
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tpp_mlir_tpu.xsmm.flags as ref_flags
from tpp_mlir_tpu import ops as jax_ops
from tpp_mlir_tpu.ir import parse_module as jax_parse_module
from tpp_mlir_tpu.tools.mlir_gen import build_parser as jax_gen_parser
from tpp_mlir_tpu.tools.mlir_gen import config_from_args as jax_gen_config
from tpp_mlir_tpu.tools.mlir_gen import generate_text as jax_generate
from tpp_mlir_tpu.tools.tpp_run import run_module as jax_run_module
from tpp_mlir_tpu.xsmm.kernels import build_kernel as jax_build_kernel
from tpp_mlir_tpu_torch import ops
from tpp_mlir_tpu_torch.runtime.tensor_init import to_torch
from tpp_mlir_tpu_torch.tools.mlir_gen import (build_parser,
                                               config_from_args,
                                               generate_text)
from tpp_mlir_tpu_torch.tools.tpp_run import load_module, run_module
from tpp_mlir_tpu_torch.xsmm import (BatchMatmulKey, BlockedMatmulKey,
                                     BrgemmKey, ChainKey, ConvBrgemmKey,
                                     ConvNhwcKey, FlashMhaKey,
                                     GroupedGemmKey, LayerNormKey,
                                     build_kernel)
from tpp_mlir_tpu_torch.xsmm import kernels, reference

NP = {"f32": np.float32, "bf16": jnp.bfloat16, "f16": np.float16}
TOL = {"bf16": 1e-2, "f16": 2e-3}
TOL_F16_CHAIN = 5e-3
# (products, output): the three mixed pairs
PAIRS = (("bf16", "f16"), ("f16", "bf16"), ("f32", "f16"))
CD = ("f32", "bf16", "f16")


def _arr(rng, shape, dt, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(NP[dt])


def _err(got, want) -> float:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def _ref_key(key):
    return getattr(ref_flags, type(key).__name__)(**dataclasses.asdict(key))


def _jax(key, *args, **kw):
    return jax_build_kernel(_ref_key(key), interpret=True)(
        *(None if a is None else jnp.asarray(a) for a in args),
        **{k: jnp.asarray(v) for k, v in kw.items()})


def _port(key, *args, **kw):
    kern = build_kernel(key)
    out = kern(*(None if a is None else to_torch(a) for a in args),
               **{k: to_torch(np.asarray(v)) for k, v in kw.items()})
    assert kern.launches == 0
    return out


def _prec(dt):
    return "highest" if dt == "f32" else "default"


# ---- each family's keys and seeded operands ------------------------------
# A family: (key from (products, output), operands from (key, C/D type, rng)
# as (args, kwargs), whether it reads a C, D, bias or gamma/beta).

def _b1(dt, ot):
    return BrgemmKey(2, 16, 64, 64, dt, out_dtype=ot, binary_kind="add",
                     binary_bcast="none", unary_kind="relu",
                     precision=_prec(dt))


def _b1_args(key, cd, rng):
    return ((_arr(rng, (2, 16, 64), key.dtype),
             _arr(rng, (2, 64, 64), key.dtype, 0.125),
             _arr(rng, (16, 64), cd), _arr(rng, (16, 64), cd)), {})


def _b2(dt, ot):
    return BrgemmKey(1, 16, 64, 64, dt, out_dtype=ot, beta0=True,
                     binary_kind="add", unary_kind="gelu",
                     prologue="layer_norm", precision=_prec(dt))


def _b2_args(key, cd, rng):
    return ((_arr(rng, (1, 16, 64), key.dtype, 3.0, 0.5),
             _arr(rng, (1, 64, 64), key.dtype, 0.125), None,
             _arr(rng, (64,), cd)),
            dict(gamma=_arr(rng, (64,), cd), beta=_arr(rng, (64,), cd)))


def _chain(dt, ot, **kw):
    return ChainKey(m=16, dims=(64, 64, 64), dtype=dt, out_dtype=ot,
                    precision=_prec(dt), **kw)


def _chain_args(key, cd, rng):
    args = [_arr(rng, (key.m, key.dims[0]), key.dtype)]
    for k, n in zip(key.dims[:-1], key.dims[1:]):
        args += [_arr(rng, (k, n), key.dtype, (2 / k) ** 0.5),
                 _arr(rng, (n,), cd, 0.1)]
    return tuple(args), {}


def _b19(dt, ot):
    return BlockedMatmulKey(2, 2, 2, 16, 32, 32, dt, out_dtype=ot,
                            binary_kind="add", unary_kind="relu",
                            precision=_prec(dt))


def _b20(dt, ot):
    return BlockedMatmulKey(1, 2, 2, 16, 32, 32, dt, out_dtype=ot,
                            repeats=3, beta0=True, binary_kind="add",
                            unary_kind="relu", precision=_prec(dt))


def _blocked_args(key, cd, rng):
    K = key.Kb * key.kb
    return ((_arr(rng, (key.Mb, key.Kb, key.mb, key.kb), key.dtype),
             _arr(rng, (key.Nb, key.Kb, key.kb, key.nb), key.dtype,
                  (2 / K) ** 0.5),
             None if key.beta0 else
             _arr(rng, (key.Mb, key.Nb, key.mb, key.nb), cd),
             _arr(rng, (key.Nb, key.nb), cd, 0.1)), {})


def _conv(strategy):
    def make(dt, ot):
        return ConvNhwcKey(N=2, H=8, W=8, C=32, K=32, R=3, S=3, dtype=dt,
                           out_dtype=ot, pad=(1, 1, 1, 1), binary_kind="add",
                           binary_bcast="none", unary_kind="relu",
                           precision=_prec(dt), strategy=strategy)
    return make


def _conv_args(key, cd, rng):
    out = (key.N, key.P, key.Q, key.K)
    return ((_arr(rng, (key.N, key.H, key.W, key.C), key.dtype),
             _arr(rng, (key.R, key.S, key.C, key.K), key.dtype,
                  (key.R * key.S * key.C) ** -0.5),
             _arr(rng, out, cd), _arr(rng, out, cd)), {})


def _b23(dt, ot):
    return ConvBrgemmKey(N=2, H=8, W=8, Cb=2, c=16, Kb=2, k=16, R=3, S=3,
                         dtype=dt, out_dtype=ot, binary_kind="add",
                         unary_kind="relu", precision=_prec(dt))


def _b23_args(key, cd, rng):
    out = (key.N, key.Kb, key.P, key.Q, key.k)
    return ((_arr(rng, (key.N, key.Cb, key.H, key.W, key.c), key.dtype),
             _arr(rng, (key.Kb, key.Cb, key.R, key.S, key.c, key.k),
                  key.dtype, (key.R * key.S * key.Cb * key.c) ** -0.5),
             _arr(rng, out, cd), _arr(rng, (key.Kb, key.k), cd)), {})


def _b16(dt, ot):
    return GroupedGemmKey(n_groups=2, m=48, n=64, k=64, bm=16, dtype=dt,
                          out_dtype=ot, unary_kind="gelu",
                          precision=_prec(dt))


def _b16_args(key, cd, rng):
    return ((np.asarray([1, 0, 1], np.int32),
             _arr(rng, (key.m, key.k), key.dtype),
             _arr(rng, (key.n_groups, key.k, key.n), key.dtype,
                  key.k ** -0.5)), {})


def _b12(dt, ot):
    return LayerNormKey(16, 128, dt, out_dtype=ot, precision=_prec(dt))


def _b12_args(key, cd, rng):
    return ((_arr(rng, (key.m, key.n), key.dtype, 3.0, 1.0),
             _arr(rng, (key.n,), cd), _arr(rng, (key.n,), cd)), {})


def _flat(**kw):
    def make(dt, ot):
        base = dict(batch=2, seq=128, seq_kv=128, head_dim=64, dtype=dt,
                    out_dtype=ot, scale=0.125, precision=_prec(dt))
        return FlashMhaKey(**{**base, **kw})
    return make


def _tokens(**kw):
    def make(dt, ot):
        return FlashMhaKey(2, 128, 128, 32, dt, out_dtype=ot,
                           scale=32 ** -0.5, heads=2, precision=_prec(dt),
                           **kw)
    return make


def _attention_args(key, cd, rng):
    E = (key.heads or 1) * key.head_dim
    if key.qkv_packed:
        return (_arr(rng, (key.batch, key.seq, 3 * E), key.dtype),) * 3, {}
    return tuple(_arr(rng, (key.batch, s, E), key.dtype)
                 for s in (key.seq, key.seq_kv, key.seq_kv)), {}


def _bmm(**kw):
    def make(dt, ot):
        return BatchMatmulKey(dtype=dt, out_dtype=ot, precision=_prec(dt),
                              **kw)
    return make


def _bmm_args(key, cd, rng):
    return ((_arr(rng, (key.batch, key.m, key.k), key.dtype, 2.0),
             _arr(rng, (key.batch, key.k, key.n), key.dtype),
             None if key.beta0 else
             _arr(rng, (key.batch, key.m, key.n), cd)), {})


FAMILIES = {
    "b1": (_b1, _b1_args, True),
    "b2-ln-prologue": (_b2, _b2_args, True),
    "b3-chain": (_chain, _chain_args, True),
    "b4-chain-bench": (lambda dt, ot: _chain(dt, ot, repeats=3),
                       _chain_args, True),
    "b5-pingpong": (lambda dt, ot: ChainKey(
        m=16, dims=(64, 96), dtype=dt, out_dtype=ot, repeats=3,
        pingpong=True, precision=_prec(dt)), _chain_args, True),
    "b19": (_b19, _blocked_args, True),
    "b20-warm": (_b20, _blocked_args, True),
    "b24-window": (_conv("window"), _conv_args, True),
    "b25-fullrow": (_conv("fullrow"), _conv_args, True),
    "b23-blocked-conv": (_b23, _b23_args, True),
    "b16-grouped": (_b16, _b16_args, False),
    "b12-layer-norm": (_b12, _b12_args, True),
    "b6-blocked": (_flat(bq=64, bk=64), _attention_args, False),
    "b8-qblock": (_flat(strategy="qblock"), _attention_args, False),
    "b9-grouped-causal": (_flat(causal=True, strategy="grouped"),
                          _attention_args, False),
    "b10a-twocall": (_flat(seq=256, seq_kv=256, causal=True,
                           strategy="twocall"),
                     _attention_args, False),
    "b10b-twocall2": (_flat(seq=256, seq_kv=256, causal=True,
                            strategy="twocall2"),
                      _attention_args, False),
    "b11-repeats": (_flat(repeats=2), _attention_args, False),
    "b7-packed-causal": (_tokens(causal=True, qkv_packed=True,
                                 strategy="tokens"),
                         _attention_args, False),
    "b21-c": (_bmm(batch=2, m=96, n=64, k=80), _bmm_args, True),
    "b22-softmax-lhs": (_bmm(batch=8, m=32, n=64, k=32, beta0=True,
                             softmax_lhs=True), _bmm_args, False),
}
CASES = [(f, dt, ot, cd) for f, (_, _, has_cd) in FAMILIES.items()
         for dt, ot in PAIRS for cd in (CD if has_cd else (None,))]


@pytest.mark.parametrize(
    "family,dt,ot,cd", CASES,
    ids=[f"{f}-{dt}-to-{ot}" + (f"-cd-{cd}" if cd else "")
         for f, dt, ot, cd in CASES])
def test_mixed_keys_match_pallas_interpret(family, dt, ot, cd):
    """One family's mixed key, C/D (where it reads them) stored in `cd`:
    the port's plain version against the Pallas body in interpret mode, at
    the tolerance of the output's type."""
    make, operands, _ = FAMILIES[family]
    key = make(dt, ot)
    args, kw = operands(key, cd or "f32", np.random.default_rng(7))
    got = _port(key, *args, **kw)
    want = _jax(key, *args, **kw)
    assert got.dtype == reference.DTYPES[ot]
    assert torch.isfinite(got.float()).all()
    tol = TOL_F16_CHAIN if family == "b3-chain" and dt == "f16" else TOL[ot]
    assert _err(got, want) <= tol


# ---- the rounding rule, on exact f32 sums --------------------------------

PROBES = {label: (key, summands) for label, key, _, summands
          in chip_smoke.mixed_probes()}


def _numpy(t):
    """A probe's torch tensor as the numpy array the JAX side takes."""
    if t.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    return t.numpy()


@pytest.mark.parametrize("label", list(PROBES))
def test_rounding_probe_matches_the_jax_body(label):
    """Each probe (chip_smoke.py mixed_probes) on the plain versions: where
    the JAX body casts an f32 value once, the output is the exact f32 sum
    rounded once (1 + 2^-7 from f16 products to bf16, 1 + 2^-10 from bf16
    or f32 products to f16, 70,144 for the large sum), never the rounding
    through the products' type (1.0, 1.0, inf); at B4, B5, B20 and B11 it
    is the JAX body's own rounding through that type. Either way it is
    bit-equal to the Pallas body in interpret mode."""
    key, summands = PROBES[label]
    args, kw, exact = chip_smoke.mixed_probe(key, summands, device="cpu")
    got = build_kernel(key)(*args, **kw)
    assert got.dtype == reference.DTYPES[key.out_dtype]
    if exact is not None:
        assert torch.equal(got, exact.to(got.dtype))
        assert torch.isfinite(got.float()).all()
        if key.precision != "highest":
            assert not torch.equal(got.float(),
                                   chip_smoke._through_products(key, exact)
                                   .float())
    jkey = key
    if isinstance(key, ConvNhwcKey):    # auto is the JAX package's XLA conv
        jkey = dataclasses.replace(key, strategy="window")
    jargs = [None if a is None else _numpy(a) for a in args]
    want = _jax(jkey, *jargs[:4], gamma=jargs[4], beta=jargs[5]) \
        if getattr(key, "prologue", None) else _jax(jkey, *jargs)
    assert torch.equal(got.float(), torch.from_numpy(
        np.array(jnp.asarray(want, jnp.float32))))


# ---- the flagship at its own depth with a bf16 last layer ----------------

def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


@pytest.mark.parametrize("form", ["flat", "packed"])
def test_mixed_flagship_runs_like_the_jax_package(form):
    """tpp-gen's f16 flagship at its width and depth (256 x 1024x4, bias,
    ReLU; packed: --tiles=256,512,512 --vnni=2) with its last layer retyped
    to bf16 (chip_smoke.py retype_last_layer) through the port's run_module
    on the CPU and the JAX run_module: the same lowered IR (one f16
    fused_chain, or three blocked fused_brgemms, with a bf16 result), a
    finite bf16 output above f16's 65,504, and each package within 1e-2 of
    both packages' --linalg-to-loops."""
    flags = (chip_smoke.F16_MIXED_FLAGSHIP if form == "flat"
             else chip_smoke.F16_MIXED_PACKED).split()
    pipeline = "default-tpp-passes" if form == "flat" \
        else "default-tpp-passes-packed"
    text = chip_smoke.retype_last_layer(
        generate_text(config_from_args(build_parser().parse_args(flags))))
    assert text == chip_smoke.retype_last_layer(
        jax_generate(jax_gen_config(jax_gen_parser().parse_args(flags))))
    port = {l2l: run_module(load_module(text), seed=1, device="cpu",
                            pipeline=pipeline, linalg_to_loops=l2l,
                            out_stream=io.StringIO())
            for l2l in (False, True)}
    ref = {l2l: jax_run_module(jax_parse_module(text), seed=1,
                               pipeline=pipeline, linalg_to_loops=l2l,
                               out_stream=io.StringIO())
           for l2l in (False, True)}
    assert _strip_tiles(str(port[False]["module"])) == \
        _strip_tiles(str(ref[False]["module"]))
    invokes = [op.opname for op in port[False]["module"]["entry"].ops
               if op.opname.startswith("xsmm.")
               and not op.opname.endswith("_dispatch")]
    assert invokes == (["xsmm.fused_chain"] if form == "flat"
                       else ["xsmm.fused_brgemm"] * 3)
    outs = [port[False]["outputs"][0], ref[False]["outputs"][0]]
    l2l = [port[True]["outputs"][0], ref[True]["outputs"][0]]
    assert outs[0].dtype == torch.bfloat16
    assert str(np.asarray(outs[1]).dtype) == "bfloat16"
    for out in map(_f32, outs):
        assert np.isfinite(out).all()
        assert float(np.max(np.abs(out))) > chip_smoke.F16_MAX
        for want in map(_f32, l2l):
            assert float(np.max(np.abs(out - want)) /
                         np.max(np.abs(want))) <= TOL["bf16"]


def _f32(x) -> np.ndarray:
    """A port (torch) or JAX output as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---- the user API ---------------------------------------------------------

OPS = {
    "gemm-f16-to-bf16": ("gemm", "f16", "bf16"),
    "gemm-bf16-to-f16-c": ("gemm", "bf16", "f16"),
    "fused-mlp-layer-f16-to-bf16": ("fused_mlp_layer", "f16", "bf16"),
    "fused-mlp-layer-f32-to-f16": ("fused_mlp_layer", "f32", "f16"),
    "blocked-matmul-f16-to-bf16": ("blocked_matmul", "f16", "bf16"),
    "blocked-matmul-bf16-to-f16-c": ("blocked_matmul", "bf16", "f16"),
    "conv2d-brgemm-f16-to-bf16": ("conv2d_brgemm", "f16", "bf16"),
    "conv2d-brgemm-bf16-to-f16-c": ("conv2d_brgemm", "bf16", "f16"),
}


@pytest.mark.parametrize("name", list(OPS))
def test_ops_take_a_mixed_out_dtype_like_the_jax_ops(name):
    """ops.gemm, fused_mlp_layer, blocked_matmul and conv2d_brgemm with an
    out_dtype of the other 16-bit type (or f16 beside f32 operands: those
    at bf16 values, which the port's "default" products keep and the JAX
    interpret mode multiplies exactly), against the JAX ops in interpret
    mode at the output type's tolerance; a C of the output's type where
    the case names one."""
    fn, dt, ot = OPS[name]
    rng = np.random.default_rng(12)

    def arr(*shape, scale=1.0):
        x = np.asarray(jnp.asarray(rng.standard_normal(shape) * scale,
                                   jnp.bfloat16))
        return x.astype(NP[dt])
    with_c = name.endswith("-c")
    if fn in ("gemm", "fused_mlp_layer"):
        args = [arr(32, 64), arr(64, 48, scale=0.125)]
        kw = dict(bias=arr(48)) if fn == "fused_mlp_layer" else {}
        if with_c:
            args.append(_arr(rng, (32, 48), ot))
    elif fn == "blocked_matmul":
        args = [arr(2, 2, 16, 32), arr(2, 2, 32, 32, scale=0.125)]
        kw = dict(bias=arr(2, 32), activation="relu")
        if with_c:
            args.append(_arr(rng, (2, 2, 16, 32), ot))
    else:
        args = [arr(2, 2, 8, 8, 16), arr(2, 2, 3, 3, 16, 16, scale=0.08)]
        kw = {} if with_c else dict(bias=arr(2, 16), activation="relu")
        if with_c:
            args.append(_arr(rng, (2, 2, 6, 6, 16), ot))
    got = getattr(ops, fn)(*map(to_torch, args), out_dtype=ot,
                           **{k: to_torch(v) if isinstance(v, np.ndarray)
                              else v for k, v in kw.items()})
    want = getattr(jax_ops, fn)(*map(jnp.asarray, args), out_dtype=ot,
                                interpret=True,
                                **{k: jnp.asarray(v)
                                   if isinstance(v, np.ndarray) else v
                                   for k, v in kw.items()})
    assert got.dtype == reference.DTYPES[ot]
    assert _err(got, want) <= TOL[ot]


# ---- one dtype table for every C entry ------------------------------------

def test_every_c_entry_reads_one_dtype_table():
    """xsmm/kernels.py _DT_CODE is csrc/epilogue.cuh's Dtype enum, code for
    code (f32 0, bf16 1, f16 2, int8 3), and no C source numbers a dtype
    any other way: decode_attn.cu reads its K/V code from that enum (an
    f16 cache can never read as int8, as it could while decode_attn.cu had
    a numbering of its own)."""
    src = (Path(kernels.__file__).parents[1] / "csrc")
    enum = re.search(r"enum Dtype : int \{([^}]*)\}",
                     (src / "epilogue.cuh").read_text()).group(1)
    codes = {name.strip(): int(v) for name, v in
             re.findall(r"(k\w+)\s*=\s*(\d+)", enum)}
    assert codes == {"kF32": 0, "kBF16": 1, "kF16": 2, "kI8": 3}
    assert kernels._DT_CODE == {torch.float32: 0, torch.bfloat16: 1,
                                torch.float16: 2, torch.int8: 3}
    assert not hasattr(kernels, "_KV_CODE")
    for cu in sorted(src.glob("*.cu")):
        assert not re.search(r"_dtype == [0-9]", cu.read_text()), cu.name
