"""The MoE slice's kernels and FFN forms against the JAX package, on the CPU.

The plain versions of B16 (grouped GEMM) and B17 (grouped weight gradient)
in `tpp_mlir_tpu_torch/xsmm/reference.py`, the oracles `csrc/grouped_gemm.cu`
is held to on the card, against the Pallas kernels in interpret mode; the
engine's router and FFN forms (`tpp_mlir_tpu_torch/serving/engine.py`)
against the JAX functions of the same names; the grouped form's autograd
Function against `jax.grad` through the JAX custom VJP. Inputs come from
numpy with a seed and go to both sides.

Tolerances, max|port - JAX| / max|JAX| unless an absolute one is named:
- B16/B17 plain versions: 1e-5 at f32 "highest" (sum order only), and at
  f32 "default" against the Pallas kernels on operands rounded to bf16
  (the port's "default" rounds them, as the compiled TPU kernels do; the
  interpret mode keeps f32); 1e-2 for a bf16 output (one rounding).
- The forms without a kernel (gates, scan, gather, slice, sorted): 1e-5.
- The grouped form and its gradients at "highest": the JAX tests' own
  (forward atol 3e-5, grads atol 5e-5 rtol 5e-4; test_moe_forms.py
  :88-207). At "default", DEFAULT_TOL: the two expert GEMMs see
  bf16-rounded operands (2^-9 relative each) where JAX's interpret mode
  keeps f32, and the gelu's input carries that error on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpp_mlir_tpu.serving as J
import tpp_mlir_tpu.serving.engine as JE
import tpp_mlir_tpu_torch.serving as P
import tpp_mlir_tpu_torch.serving.engine as PE
from tpp_mlir_tpu.xsmm import build_kernel as jax_build_kernel
from tpp_mlir_tpu.xsmm import flags as jax_flags
from tpp_mlir_tpu_torch.xsmm import (GroupedGemmKey, GroupedWgradKey,
                                     build_kernel)

DEFAULT_TOL = 1e-2


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(port, ref) -> float:
    p, r = _f32(port), _f32(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))


def _bf16(a):
    """f32 values rounded to bf16 (the port's f32 "default" operands)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rng(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# B16 and B17's plain versions (the shapes of tests/xsmm/test_kernels.py
# :441-612)

GEMM = {
    "basic": (dict(n_groups=4, m=48, n=128, k=64, bm=8), [0, 0, 1, 3, 3, 3]),
    "gelu-split-k": (dict(n_groups=2, m=48, n=128, k=256, bm=16, bk=128,
                          unary_kind="gelu"), [1, 0, 1]),
    "layers-gelu": (dict(n_groups=4, m=48, n=128, k=64, bm=8, layers=3,
                         unary_kind="gelu"), [0, 2, 1, 3, 3, 1]),
    "transpose_b": (dict(n_groups=4, m=48, n=128, k=64, bm=8,
                         transpose_b=True), [0, 0, 1, 3, 3, 2]),
}


def _gemm_operands(kw, seed=0):
    a = _rng(seed, kw["m"], kw["k"])
    wk = (kw["n"], kw["k"]) if kw.get("transpose_b") else (kw["k"], kw["n"])
    lead = (kw["layers"],) if kw.get("layers") else ()
    return a, _rng(seed + 1, *lead, kw["n_groups"], *wk, scale=0.1)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("name", list(GEMM))
def test_grouped_gemm_plain_matches_jax_kernel(name, precision):
    kw, ge = GEMM[name]
    a, w = _gemm_operands(kw)
    if precision == "default":      # the JAX side sees the rounded operands
        ja, jw = _bf16(a), _bf16(w)
    else:
        ja, jw = a, w
    jfn = jax_build_kernel(jax_flags.GroupedGemmKey(**kw), interpret=True)
    kern = build_kernel(GroupedGemmKey(**kw, precision=precision))
    tge = torch.tensor(ge, dtype=torch.int32)
    outs = []
    for li in range(kw.get("layers", 0) or 1):
        lead = (jnp.asarray(li, jnp.int32),) if kw.get("layers") else ()
        want = jfn(*lead, jnp.asarray(ge, jnp.int32), jnp.asarray(ja),
                   jnp.asarray(jw))
        got = kern(*((li,) if lead else ()), tge, torch.from_numpy(a),
                   torch.from_numpy(w))
        assert got.dtype == torch.float32 and kern.launches == 0
        assert _rel(got, want) <= 1e-5, (li, _rel(got, want))
        outs.append(got)
    if kw.get("layers"):     # every layer reads its own table
        assert (outs[0] - outs[2]).abs().max() > 1e-3


def test_grouped_gemm_plain_bf16_and_f32_output():
    """A bf16 key (the serving prefill's) with an f32 output (the training
    forward's z1 and the dgrads): one rounding of the f32 product."""
    kw = dict(n_groups=4, m=48, n=128, k=64, bm=8, transpose_b=True)
    a, w = _gemm_operands(kw, seed=3)
    a16, w16 = _bf16(a), _bf16(w)
    ge = [0, 1, 1, 2, 3, 3]
    for out_dtype in ("f32", "bf16"):
        key = dict(kw, dtype="bf16", out_dtype=out_dtype)
        want = jax_build_kernel(jax_flags.GroupedGemmKey(**key),
                                interpret=True)(
            jnp.asarray(ge, jnp.int32), jnp.asarray(a16, jnp.bfloat16),
            jnp.asarray(w16, jnp.bfloat16))
        got = build_kernel(GroupedGemmKey(**key))(
            torch.tensor(ge, dtype=torch.int32),
            torch.tensor(a16).bfloat16(), torch.tensor(w16).bfloat16())
        assert got.dtype == {"f32": torch.float32,
                             "bf16": torch.bfloat16}[out_dtype]
        assert _rel(got, want) <= (1e-5 if out_dtype == "f32" else 1e-2)


WGRAD = {
    "wgrad": (dict(n_groups=4, m=48, k=64, n=128, bm=8), [0, 0, 1, 2, 3, 3]),
    "wgrad-split-n": (dict(n_groups=2, m=32, k=32, n=256, bm=8, bn=128),
                      [0, 0, 0, 1]),
    # expert 1 owns only its minimum block, whose rows are all padding
    "min-block": (dict(n_groups=4, m=56, k=64, n=128, bm=8),
                  [0, 0, 0, 1, 2, 2, 3]),
}


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("name", list(WGRAD))
def test_grouped_wgrad_plain_matches_jax_kernel(name, precision):
    kw, ge = WGRAD[name]
    bm = kw["bm"]
    x = _rng(5, kw["m"], kw["k"])           # the forward's (m, k) rows
    for i, g in enumerate(ge):
        if name == "min-block" and g == 1:
            x[i * bm:(i + 1) * bm] = 0.0    # padding rows are zero
    dy = _rng(6, kw["m"], kw["n"])
    jx, jdy = (_bf16(x), _bf16(dy)) if precision == "default" else (x, dy)
    want = jax_build_kernel(jax_flags.GroupedWgradKey(**kw), interpret=True)(
        jnp.asarray(ge, jnp.int32), jnp.asarray(jx.T), jnp.asarray(jdy))
    kern = build_kernel(GroupedWgradKey(**kw, precision=precision))
    # xt as the transpose of the contiguous (m, k) rows, as the autograd
    # backward passes it, and as a contiguous (k, m) copy
    tge, tx = torch.tensor(ge, dtype=torch.int32), torch.from_numpy(x)
    got = kern(tge, tx.t(), torch.from_numpy(dy))
    again = kern(tge, tx.t().contiguous(), torch.from_numpy(dy))
    assert got.shape == (kw["n_groups"], kw["k"], kw["n"])
    assert got.dtype == torch.float32 and kern.launches == 0
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, again)
    if name == "min-block":
        assert not got[1].any()


def test_grouped_keys_refuse_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="multiple of bm"):
        build_kernel(GroupedGemmKey(n_groups=2, m=20, n=16, k=16, bm=8))
    with pytest.raises(ValueError, match="unary"):
        build_kernel(GroupedGemmKey(n_groups=2, m=16, n=16, k=16, bm=8,
                                    unary_kind="softplus"))
    # a key mixing f16 operands with a bf16 output, refused until ROADMAP
    # A14's last item, builds and runs: its plain version against the
    # Pallas body in interpret mode at a bf16 output's 1e-2
    key = GroupedGemmKey(n_groups=2, m=16, n=16, k=16, bm=8, dtype="f16",
                         out_dtype="bf16")
    ge = np.asarray([1, 0], np.int32)
    a = _rng(11, 16, 16).astype(np.float16)
    w = (_rng(12, 2, 16, 16) * 0.25).astype(np.float16)
    got = build_kernel(key)(torch.from_numpy(ge), torch.from_numpy(a),
                            torch.from_numpy(w))
    want = jax_build_kernel(jax_flags.GroupedGemmKey(**dataclasses.asdict(
        key)), interpret=True)(jnp.asarray(ge), jnp.asarray(a),
                               jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= 1e-2


# csrc/grouped_gemm.cu's tile for B16, chosen from the key
# (xsmm/reference.py grouped_gemm_route): the TMA + wgmma tile for bf16
# operands with bm a multiple of 64 and k, n multiples of 8; the WMMA tile
# for every other bm that 8 divides, f32 operands and strides TMA cannot
# take; no tile for a bm off the 8-row quantum
ROUTES = {
    "bf16-bm128-slice": (dict(m=9216, n=768, k=3072, bm=128), "wgmma"),
    "bf16-bm64-gelu": (dict(unary_kind="gelu", bm=64), "wgmma"),
    "bf16-bm192": (dict(bm=192, m=384), "wgmma"),
    "bf16-bm128-tb-f32-out": (dict(transpose_b=True, out_dtype="f32"),
                              "wgmma"),
    "bf16-bm128-layers": (dict(layers=3), "wgmma"),
    "bf16-bm16": (dict(bm=16), "wmma"),
    "bf16-bm32": (dict(bm=32), "wmma"),
    "bf16-bm96": (dict(bm=96, m=192), "wmma"),
    "f32-default-bm128": (dict(dtype="f32"), "wmma"),
    "f32-highest-bm128": (dict(dtype="f32", precision="highest"), "wmma"),
    "bf16-k-off-8": (dict(k=100), "wmma"),
    "bf16-n-off-8": (dict(n=36), "wmma"),
    "bm8": (dict(bm=8), "wmma"),
    "bf16-bm24": (dict(bm=24, m=240), "wmma"),
    "bm4": (dict(bm=4), (ValueError, "multiple of 8")),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_grouped_gemm_route_table(name):
    from tpp_mlir_tpu_torch.xsmm.reference import grouped_gemm_route
    fields, want = ROUTES[name]
    key = GroupedGemmKey(**{"n_groups": 8, "m": 256, "n": 128, "k": 64,
                            "dtype": "bf16", **fields})
    if isinstance(want, str):
        assert grouped_gemm_route(key) == want
        return
    err, match = want
    with pytest.raises(err, match=match):
        grouped_gemm_route(key)
    build_kernel(key)       # the CPU's plain version takes any bm


# csrc/grouped_gemm.cu's tile for B17, chosen from the key and xt's strides
# (xsmm/reference.py grouped_wgrad_route): the TMA + wgmma tile for bf16
# operands with bm a multiple of 64, n a multiple of 8 and xt with one unit
# stride and the other a 16-byte multiple (the transpose of a contiguous x
# by default, or a contiguous xt); the WMMA tile for a bm of 16 or 32, f32
# operands and strides TMA cannot take. (key fields, xt strides, route)
WGRAD_ROUTES = {
    "dw1-bm128": (dict(m=9216, k=768, n=3072), None, "wgmma"),
    "dw2-bm128": (dict(m=9216, k=3072, n=768), None, "wgmma"),
    "dw1-bm128-transpose-strides": (dict(m=9216, k=768, n=3072), (1, 768),
                                    "wgmma"),
    "bm64": (dict(bm=64), None, "wgmma"),
    "contiguous-xt": (dict(), (256, 1), "wgmma"),
    "bm16": (dict(bm=16), None, "wmma"),
    "bm32": (dict(bm=32), None, "wmma"),
    "f32-default": (dict(dtype="f32"), None, "wmma"),
    "f32-highest": (dict(dtype="f32", precision="highest"), None, "wmma"),
    "xt-row-stride-off-16-bytes": (dict(k=100), None, "wmma"),
    "xt-no-unit-stride": (dict(), (2, 128), "wmma"),
    "n-off-8": (dict(n=36), None, "wmma"),
}


@pytest.mark.parametrize("name", list(WGRAD_ROUTES))
def test_grouped_wgrad_route_table(name):
    from tpp_mlir_tpu_torch.xsmm.reference import grouped_wgrad_route
    fields, strides, want = WGRAD_ROUTES[name]
    key = GroupedWgradKey(**{"n_groups": 8, "m": 256, "k": 64, "n": 128,
                             "dtype": "bf16", **fields})
    assert grouped_wgrad_route(key, strides) == want
    build_kernel(key)       # the CPU's plain version takes any tile


# ---------------------------------------------------------------------------
# the router and the forms without a kernel

E, F_, N_E = 32, 64, 8


def _blk(seed=0):
    """Expert weights as test_moe_forms.py's _blk scales them, from numpy."""
    return {"wr": _rng(seed, E, N_E, scale=0.3),
            "w1": _rng(seed + 1, N_E, E, F_, scale=0.1),
            "w2": _rng(seed + 2, N_E, F_, E, scale=0.1)}


def _skewed(blk, h):
    """Skewed routing: rows shifted to a positive mean, the router pulled
    toward expert 3 and away from experts 6 and 7, which no token then
    chooses."""
    wr = blk["wr"].copy()
    wr[:, 3] += 1.0
    wr[:, 6:] -= 1.0
    return dict(blk, wr=wr), h + 1.0


def _sides(blk, h):
    """(JAX block, JAX h, port block, port h) from numpy."""
    return ({k: jnp.asarray(v) for k, v in blk.items()}, jnp.asarray(h),
            {k: torch.from_numpy(v) for k, v in blk.items()},
            torch.from_numpy(h))


def _dense_gates(gates, idx, n_e=N_E):
    g, i = _f32(gates), np.asarray(idx)
    out = np.zeros((g.shape[0], n_e), np.float32)
    np.put_along_axis(out, i.astype(np.int64), g, axis=1)
    return out


@pytest.mark.parametrize("T", [16, 64, 256])
def test_moe_gates_select_the_same_experts(T):
    blk = _blk(1)
    h = _rng(T, T, E)
    jb, jh, pb, ph = _sides(blk, h)
    jg, ji = JE._moe_gates(jh, jb["wr"], 2)
    pg, pi = PE._moe_gates(ph, pb["wr"], 2)
    # routing sets, not positions: top-k order and ties may differ
    assert (np.sort(np.asarray(ji), 1) == np.sort(pi.numpy(), 1)).all()
    np.testing.assert_allclose(_dense_gates(pg, pi), _dense_gates(jg, ji),
                               atol=1e-6)
    np.testing.assert_allclose(pg.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("T", [16, 64, 256])
@pytest.mark.parametrize("form", ["scan", "gather", "sorted"])
def test_ffn_form_matches_jax(form, T):
    blk = _blk()
    h = _rng(T + 1, T, E)
    jb, jh, pb, ph = _sides(blk, h)
    fn = "_moe_ffn_" + form
    want = getattr(JE, fn)(jh, jb, 2)
    got = getattr(PE, fn)(ph, pb, 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)


def test_sorted_form_drops_as_jax_does_at_a_small_capacity():
    """capacity_factor 0.5 drops about half the assignments: the same ones
    on both sides (stable sort by expert, token order within)."""
    blk = _blk(2)
    h = _rng(9, 64, E)
    jb, jh, pb, ph = _sides(blk, h)
    want = JE._moe_ffn_sorted(jh, jb, 2, capacity_factor=0.5)
    got = PE._moe_ffn_sorted(ph, pb, 2, capacity_factor=0.5)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)
    assert _rel(got, PE._moe_ffn_scan(ph, pb, 2)) > 1e-2   # it did drop


def test_slice_form_matches_jax():
    blk = _blk(3)
    h = _rng(4, 1, E)
    jb, jh, pb, ph = _sides(blk, h)
    np.testing.assert_allclose(_f32(PE._moe_ffn_slice(ph, pb, 2)),
                               _f32(JE._moe_ffn_slice(jh, jb, 2)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_e,top_k", [(8, 2), (32, 1)])
def test_decode_policy_picks_the_jax_form(n_e, top_k, monkeypatch):
    """The JAX dispatch's choice, read by spying on its three forms, equals
    moe_decode_form at B 1, 4 and 8 (slice, scan once 3*B*k >= n_e,
    gather below)."""
    picked = []
    for form in ("slice", "scan", "gather"):
        monkeypatch.setattr(JE, f"_moe_ffn_{form}",
                            lambda h, blk, k, form=form: picked.append(form))
    kw = dict(embed=E, heads=4, n_experts=n_e, top_k=top_k)
    jcfg, pcfg = J.GptConfig(**kw), P.GptConfig(**kw)
    for B in (1, 4, 8):
        JE._moe_ffn_decode(jnp.zeros((B, E)), {}, jcfg)
        assert picked[-1] == PE.moe_decode_form(pcfg, B), (B, picked)
    assert picked == (["slice", "scan", "scan"] if n_e == 8
                      else ["slice", "gather", "gather"])
    with pytest.raises(ValueError, match="batch 1"):
        PE.moe_decode_form(dataclasses.replace(pcfg, moe_decode_form="slice"),
                           4)


# ---------------------------------------------------------------------------
# the grouped form (B16's plain version here) and its autograd Function
# (B16 + B17)

def _cfgs(bm):
    kw = dict(embed=E, heads=4, n_experts=N_E, top_k=2, moe_group_bm=bm)
    return J.GptConfig(**kw), P.GptConfig(**kw)


GROUPED = {"16-8": (16, 8, False), "64-8": (64, 8, False),
           "64-16": (64, 16, False), "256-32": (256, 32, False),
           "96-8-skewed": (96, 8, True)}


@pytest.mark.parametrize("name", list(GROUPED))
def test_grouped_form_matches_jax(name):
    T, bm, skew = GROUPED[name]
    blk, h = _blk(4), _rng(T + bm, T, E)
    if skew:
        blk, h = _skewed(blk, h)
    jb, jh, pb, ph = _sides(blk, h)
    jcfg, pcfg = _cfgs(bm)
    want = JE._moe_ffn_grouped(jh, jb, jcfg)
    got = PE._moe_ffn_grouped(ph, pb, pcfg, kernels=True,
                              precision="highest")
    np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-5)
    default = PE._moe_ffn_grouped(ph, pb, pcfg, kernels=False)
    assert _rel(default, want) <= DEFAULT_TOL


def test_grouped_dispatch_matches_jax_and_pads_every_expert():
    blk, h = _skewed(_blk(5), _rng(8, 48, E))   # experts 6, 7 get no token
    jb, jh, pb, ph = _sides(blk, h)
    _, ji = JE._moe_gates(jh, jb["wr"], 2)
    ji = np.sort(np.asarray(ji), 1)     # one routing for both sides
    assert not {6, 7} & set(ji.ravel().tolist())
    want = JE._grouped_dispatch(jnp.asarray(ji), 48, N_E, 8, 2)
    got = PE._grouped_dispatch(torch.from_numpy(ji), 48, N_E, 8, 2)
    assert got["A_pad"] == want["A_pad"] == (12 + N_E) * 8
    for name in ("ge", "tt", "aid", "rows"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name
    assert got["ge"].dtype == torch.int32
    assert set(got["ge"].tolist()) == set(range(N_E))    # min one block each


def _jax_grads(ffn, h, blk):
    def loss(h, wr, w1, w2):
        o = ffn(h, {"wr": wr, "w1": w1, "w2": w2})
        return jnp.sum(jnp.sin(o.astype(jnp.float32)))
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(h), *(jnp.asarray(blk[k]) for k in ("wr", "w1", "w2")))


def _port_grads(ffn, h, blk):
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (h, blk["wr"], blk["w1"], blk["w2"])]
    o = ffn(leaves[0], dict(zip(("wr", "w1", "w2"), leaves[1:])))
    torch.sin(o.float()).sum().backward()
    return [t.grad for t in leaves]


GRADS = {"16-8": (16, 8, False), "96-8": (96, 8, False),
         "64-16": (64, 16, False), "48-8-skewed": (48, 8, True)}


@pytest.mark.parametrize("name", list(GRADS))
def test_grouped_function_grads_match_jax_custom_vjp(name):
    """Leaf by leaf (h, router, w1, w2) against jax.grad through the JAX
    grouped core's custom VJP; experts no token chose get exactly zero."""
    T, bm, skew = GRADS[name]
    blk, h = _blk(6), _rng(T + bm + 1, T, E)
    if skew:
        blk, h = _skewed(blk, h)
    jcfg, pcfg = _cfgs(bm)
    want = _jax_grads(lambda h, b: JE._moe_ffn_grouped(h, b, jcfg), h, blk)
    got = _port_grads(lambda h, b: PE._moe_ffn_grouped(
        h, b, pcfg, kernels=True, precision="highest"), h, blk)
    for g, w, leaf in zip(got, want, ("dh", "dwr", "dw1", "dw2")):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=5e-5, rtol=5e-4,
                                   err_msg=leaf)
    touched = np.unique(np.asarray(jax.lax.top_k(
        jnp.asarray(h) @ jnp.asarray(blk["wr"]), 2)[1]))
    if skew:
        assert not {6, 7} & set(touched.tolist())
    for e in set(range(N_E)) - set(touched.tolist()):
        assert not got[2][e].any() and not got[3][e].any(), e


def test_grouped_function_grads_at_default_precision():
    """f32 "default": the same wiring with bf16-rounded GEMM operands."""
    blk = _blk(7)
    h = _rng(3, 64, E)
    jcfg, pcfg = _cfgs(16)
    want = _jax_grads(lambda h, b: JE._moe_ffn_grouped(h, b, jcfg), h, blk)
    got = _port_grads(lambda h, b: PE._moe_ffn_grouped(h, b, pcfg, True),
                      h, blk)
    for g, w, leaf in zip(got, want, ("dh", "dwr", "dw1", "dw2")):
        assert _rel(g, w) <= DEFAULT_TOL, (leaf, _rel(g, w))


def test_grouped_form_takes_the_function_only_under_autograd():
    """No grad (serving): the fused-gelu B16 pair, no autograd node; with a
    leaf that asks for a gradient: the Function, B17 in its backward."""
    blk = {k: torch.from_numpy(v) for k, v in _blk(8).items()}
    h = torch.from_numpy(_rng(2, 16, E))
    _, pcfg = _cfgs(8)
    blk["w1"].requires_grad_(True)
    with torch.no_grad():
        assert PE._moe_ffn_grouped(h, blk, pcfg, kernels=True).grad_fn is None
    out = PE._moe_ffn_grouped(h, blk, pcfg, kernels=True)
    assert type(out.grad_fn).__name__ == "_GroupedFFNBackward"
    out.sum().backward()
    assert blk["w1"].grad.shape == (N_E, E, F_)
