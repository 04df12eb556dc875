"""The warm-panel engine's plan and routes (csrc/warm_panel.cuh), on the CPU.

reference.warm_plan is a pure function of the key and the card's cluster
occupancy; chain_route and warm_route pick csrc/chain.cu's and B20's body
from the key alone. These tests pin them at the main paths' keys and the
`cuda` tests' keys, check every plan's geometry against the kernel's
limits, and show with today's gate formulas copied here that the gates
(chain_fits_smem, blocked_warm_fits_smem) accept every key they accepted
before the engine came, so the lowering does not change.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpp_mlir_tpu_torch.xsmm import BlockedMatmulKey, ChainKey, reference
from tpp_mlir_tpu_torch.xsmm.kernels import (SM90_SMEM_OPTIN,
                                             blocked_warm_fits_smem,
                                             chain_fits_smem)
from tpp_mlir_tpu_torch.xsmm.reference import (WarmPlan, chain_route,
                                               warm_plan, warm_route,
                                               warm_smem_bytes)

FC = dict(beta0=True, binary_kind="add", unary_kind="relu")
FLAG = (1024,) * 4

# (key, its route, its plan): the flagship (B3, B4), fc_128x768x2304's B5,
# base.json's fc rows' B20, and the keys of tests/test_torch_cuda.py
PINNED = {
    "flagship-bf16": (ChainKey(m=256, dims=FLAG, dtype="bf16"), "panel",
                      WarmPlan(40, 16, (1, 1, 1), False, 159176, 7)),
    "flagship-f32-r100": (ChainKey(m=256, dims=FLAG, repeats=100), "panel",
                          WarmPlan(40, 16, (1, 1, 1), False, 159176, 7)),
    "flagship-highest": (ChainKey(m=256, dims=FLAG, precision="highest"),
                         "fma", None),
    "b5-fc-128x768x2304": (ChainKey(m=128, dims=(768, 2304), repeats=100,
                                    pingpong=True), "panel",
                           WarmPlan(24, 12, (3, 1), False, 196040, 6)),
    "b20-fc-f32": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, repeats=200,
                                    **FC), "panel",
                   WarmPlan(40, 16, (1,), True, 224712, 7)),
    "b20-fc-bf16-vnni": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, "bf16",
                                          vnni=2, repeats=200, **FC),
                         "panel", WarmPlan(40, 16, (1,), True, 224712, 7)),
    "b20-fc-highest": (BlockedMatmulKey(1, 2, 2, 256, 512, 512, repeats=3,
                                        precision="highest", **FC), "fma",
                       None),
    "ragged-masked": (ChainKey(m=17, dims=(48, 160, 48), dtype="bf16"),
                      "panel", WarmPlan(16, 3, (1, 1), True, 44488, 2)),
    "pingpong-small": (ChainKey(m=40, dims=(64, 160), repeats=3,
                                pingpong=True), "panel",
                       WarmPlan(16, 3, (1, 1), True, 44488, 3)),
    "b20-vnni-mb24": (BlockedMatmulKey(2, 2, 2, 24, 64, 64, "bf16", vnni=2,
                                       repeats=3, **FC), "panel",
                      WarmPlan(16, 2, (1,), True, 26056, 4)),
}


@pytest.mark.parametrize("name", list(PINNED))
def test_warm_plan_and_route_are_pinned(name):
    key, route, plan = PINNED[name]
    got = chain_route(key) if isinstance(key, ChainKey) else warm_route(key)
    assert got == route
    assert warm_plan(key) == plan


def test_streamed_weights_are_a_chains_only():
    # B20's packed weights are never streamed: a K too wide for a block's
    # resident slices takes the first design
    key = BlockedMatmulKey(1, 4, 4, 256, 512, 512, "bf16", repeats=2, **FC)
    assert warm_plan(key) is None and warm_route(key) == "wmma"
    plan = warm_plan(ChainKey(m=256, dims=(2048, 2048), dtype="bf16"))
    assert plan is not None and not plan.resident


def test_more_streamed_layers_than_tensor_maps_take_the_wmma_body():
    wide = ChainKey(m=256, dims=(1024,) * (reference.WARM_MAPS + 2),
                    dtype="bf16")
    assert chain_fits_smem(wide) and chain_route(wide) == "wmma"
    small = ChainKey(m=256, dims=(128,) * (reference.WARM_MAPS + 2),
                     dtype="bf16")
    assert warm_plan(small).resident and chain_route(small) == "panel"


def test_the_card_s_cluster_count_moves_the_panel():
    # the H100 holds 7 clusters of 16: 256 rows go in 7 panels of 40; a
    # card that held 8 would take 32-row panels, one that held 4 64-row
    # ones
    key = PINNED["flagship-bf16"][0]
    table = dict(reference.H100_WARM_CLUSTERS)
    assert warm_plan(key, clusters=table).rows == 40
    table[16] = 8
    assert warm_plan(key, clusters=table).rows == 32
    table[16] = 4
    assert warm_plan(key, clusters=table).rows == 64


@pytest.mark.parametrize("rows,cluster,resident", [
    (16, 1, True), (24, 2, True), (32, 4, False), (40, 16, False),
    (64, 16, True), (64, 2, False)])
def test_forced_plans_keep_the_cluster_geometry(rows, cluster, resident):
    key = ChainKey(m=70, dims=(96, 128, 96), dtype="bf16", repeats=2)
    plan = warm_plan(key, rows=rows, cluster=cluster, resident=resident)
    assert (plan.rows, plan.cluster, plan.resident) == (rows, cluster,
                                                        resident)
    assert plan.clusters == -(-70 // rows)
    assert plan.tiles == tuple(-(-2 // cluster) for _ in range(2))


def _old_chain_smem_bytes(dmax, mxu_bytes):
    # chain.cu's first design, as the gate sized it before the engine: 16
    # rows of the MXU-dtype input (+ 8 pad) and of the f32 output (+ 4 pad)
    h = 16 * (dmax + 8) * mxu_bytes
    return (h + 127) // 128 * 128 + 16 * (dmax + 4) * 4


def _old_chain_gate(key):
    if len(key.dims) - 1 > 32 or any(d % 16 for d in key.dims):
        return False
    mxu = 4 if key.dtype == "f32" and key.precision == "highest" else \
        (2 if key.dtype == "bf16" or key.precision == "default" else 4)
    return _old_chain_smem_bytes(max(key.dims), mxu) <= 232448


def _old_warm_gate(key):
    # B20's first design, as the gate sized it before the engine: two
    # 16-row panels and, for bf16 products, 34,816 bytes of per-warp
    # staging
    K = key.Kb * key.kb
    if key.Nb != key.Kb or key.nb != key.kb or K % 16 or key.nb % 16:
        return False
    bf16 = not (key.dtype == "f32" and key.precision == "highest")
    h = 2 * 16 * (K + 8) * (2 if bf16 else 4)
    return (h + 127) // 128 * 128 + (34816 if bf16 else 0) <= 232448


def _check_plan(key, plan):
    assert plan.rows in reference.WARM_ROWS
    assert 1 <= plan.cluster <= 16
    steps, groups, m = reference.warm_steps(key)
    assert plan.clusters == groups * -(-m // plan.rows)
    # a block's share of each step: whole 64-column tiles, none wider than
    # the step, the cluster covering every tile
    for (_, N, _), t in zip(steps, plan.tiles):
        assert t * 64 % 16 == 0
        assert t * plan.cluster >= -(-N // 64)
        assert (t - 1) * plan.cluster < -(-N // 64)
    assert plan.smem == warm_smem_bytes(plan.rows, plan.cluster, steps,
                                        plan.resident)
    assert plan.smem <= SM90_SMEM_OPTIN
    assert plan.resident or isinstance(key, ChainKey)


WIDTHS = st.integers(1, 2432 // 16).map(lambda w: 16 * w)
PRECISION = st.sampled_from([("bf16", "default"), ("f32", "default"),
                             ("f32", "highest")])


@settings(max_examples=300, deadline=None, database=None)
@given(dims=st.lists(WIDTHS, min_size=2, max_size=33), m=st.integers(1, 600),
       prec=PRECISION, repeats=st.integers(1, 4))
def test_chain_gate_accepts_every_key_it_accepted(dims, m, prec, repeats):
    if repeats > 1:
        dims[-1] = dims[0]
    key = ChainKey(m=m, dims=tuple(dims), dtype=prec[0], precision=prec[1],
                   repeats=repeats)
    if _old_chain_gate(key):
        assert chain_fits_smem(key)
    route = chain_route(key)
    assert route == ("fma" if prec[1] == "highest" and prec[0] == "f32"
                     else route)
    if route == "panel":
        _check_plan(key, warm_plan(key))


@settings(max_examples=300, deadline=None, database=None)
@given(k=WIDTHS, n=WIDTHS, m=st.integers(1, 600), prec=PRECISION,
       repeats=st.integers(2, 5))
def test_pingpong_gate_accepts_every_key_it_accepted(k, n, m, prec,
                                                     repeats):
    key = ChainKey(m=m, dims=(k, n), dtype=prec[0], precision=prec[1],
                   repeats=repeats, pingpong=True)
    if _old_chain_gate(key):
        assert chain_fits_smem(key)
    if chain_route(key) == "panel":
        _check_plan(key, warm_plan(key))


@settings(max_examples=300, deadline=None, database=None)
@given(Kb=st.integers(1, 8), kb=st.integers(1, 40).map(lambda w: 16 * w),
       Mb=st.integers(1, 4), mb=st.integers(1, 300), prec=PRECISION,
       vnni=st.sampled_from([0, 2]), repeats=st.integers(1, 5))
def test_warm_gate_accepts_every_key_it_accepted(Kb, kb, Mb, mb, prec, vnni,
                                                 repeats):
    key = BlockedMatmulKey(Mb, Kb, Kb, mb, kb, kb, prec[0], vnni=vnni,
                           precision=prec[1], repeats=repeats, **FC)
    if _old_warm_gate(key):
        assert blocked_warm_fits_smem(key)
    if warm_route(key) == "panel":
        _check_plan(key, warm_plan(key))


def test_old_gate_formulas_agree_with_the_gates_at_the_flagship():
    # the copies above are today's formulas: they agree with the gates'
    # own arithmetic at the widths chip_smoke checks against the kernels
    from tpp_mlir_tpu_torch.xsmm.kernels import (blocked_warm_smem_bytes,
                                                 chain_smem_bytes)
    import torch
    for mxu, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
        assert chain_smem_bytes(1024, mxu) == _old_chain_smem_bytes(1024,
                                                                    nbytes)
    key = BlockedMatmulKey(1, 2, 2, 256, 512, 512, repeats=3, **FC)
    assert blocked_warm_smem_bytes(1024, torch.bfloat16) == \
        (2 * 16 * 1032 * 2 + 127) // 128 * 128 + 34816
    assert _old_warm_gate(key) and blocked_warm_fits_smem(key)


@pytest.mark.parametrize("key,route", [
    (ChainKey(m=64, dims=(64, 64), dtype="bf16"), "fma"),
    (ChainKey(m=64, dims=(64, 64), precision="highest"), "wmma"),
    (ChainKey(m=64, dims=(64, 64), precision="highest"), "panel"),
    (BlockedMatmulKey(1, 2, 2, 64, 64, 64, repeats=2, **FC), "tma"),
    (BlockedMatmulKey(1, 2, 2, 64, 64, 64, **FC), "panel"),
])
def test_forcing_a_body_the_key_cannot_take_raises(key, route):
    # the first design's body follows the MXU dtype; the engine takes bf16
    # products only; B19 (no repeats) has no warm body
    from tpp_mlir_tpu_torch.xsmm.kernels import build_warm
    with pytest.raises(ValueError):
        build_warm(key, route)


@pytest.mark.parametrize("route", ["panel", "wmma"])
def test_a_forced_body_runs_the_plain_version_on_the_cpu(route):
    import numpy as np
    import torch
    from tpp_mlir_tpu_torch.xsmm import reference_kernel
    from tpp_mlir_tpu_torch.xsmm.kernels import build_warm
    key = ChainKey(m=17, dims=(48, 160, 48), dtype="bf16")
    rs = np.random.RandomState(0)
    args = [torch.from_numpy(rs.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16) for s in ((17, 48), (48, 160), (160,),
                                          (160, 48), (48,))]
    kern = build_warm(key, route)
    assert torch.equal(kern(*args), reference_kernel(key)(*args))
    assert kern.launches == 0
