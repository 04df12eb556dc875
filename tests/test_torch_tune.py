"""The port's tuning layer (xsmm/tune.py, tools/tpp_tune.py) against the JAX
package's, on the CPU: key_tag's text, the lookup order and trial nesting,
the table's round trip, the card a plan binds on, the GEMM plans' legality
rule (reference.check_gemm_plan, the mirror of csrc/gemm_sm90.cuh
plan_legal) and bk's k split, the plans a built Kernel captures, and
tpp-tune --dry's keys beside the JAX tool's. Mirrors tests/xsmm/test_tune.py.
"""

import dataclasses
import json
import re

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tpp_mlir_tpu.xsmm.flags as jax_flags
from tpp_mlir_tpu.tools import tpp_tune as jax_tpp_tune
from tpp_mlir_tpu.xsmm import tune as jax_tune
from tpp_mlir_tpu_torch.tools import tpp_tune
from tpp_mlir_tpu_torch.xsmm import reference, tune
from tpp_mlir_tpu_torch.xsmm.flags import (BlockedMatmulKey, BrgemmKey,
                                           ChainKey)
from tpp_mlir_tpu_torch.xsmm.kernels import build_kernel, build_warm

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def table(tmp_path, monkeypatch):
    """A fresh tuning table under tmp_path for the test's duration, read
    as on an H100."""
    path = tmp_path / "tuning.json"
    monkeypatch.setenv("TPP_TUNING_PATH", str(path))
    monkeypatch.setattr(tune, "device_kind", lambda: H100)
    tune._load_file.cache_clear()
    yield path
    tune._load_file.cache_clear()


def _brgemm(**kw):
    base = dict(batch=1, m=256, n=1024, k=1024, dtype="f32", beta0=True,
                binary_kind="add", unary_kind="relu")
    base.update(kw)
    return BrgemmKey(**base)


KEYS = [
    ("BrgemmKey", dict(batch=1, m=256, n=1024, k=1024, dtype="bf16",
                       binary_kind="add", unary_kind="relu", beta0=True)),
    ("BrgemmKey", dict(batch=4, m=64, n=136, k=200, prologue="layer_norm",
                       precision="highest")),
    ("ChainKey", dict(m=256, dims=(1024, 1024, 1024, 1024), dtype="bf16")),
    ("ChainKey", dict(m=128, dims=(768, 2304), pingpong=True, repeats=7)),
    ("BlockedMatmulKey", dict(Mb=8, Nb=32, Kb=32, mb=32, nb=32, kb=32,
                              dtype="bf16", vnni=2, repeats=0)),
]


@pytest.mark.parametrize("name,kw", KEYS)
def test_key_tag_is_the_jax_key_tag(name, kw):
    port = getattr(__import__("tpp_mlir_tpu_torch.xsmm.flags",
                              fromlist=[name]), name)(**kw)
    ref = getattr(jax_flags, name)(**kw)
    assert tune.key_tag(port) == jax_tune.key_tag(ref)


@pytest.mark.parametrize("name,kw", KEYS)
def test_key_tag_ignores_plans_and_repeats(name, kw):
    key = getattr(__import__("tpp_mlir_tpu_torch.xsmm.flags",
                             fromlist=[name]), name)(**kw)
    over = {f: v for f, v in (("bm", 64), ("bn", 128), ("bk", 256),
                              ("repeats", 100), ("pingpong", True))
            if f in {x.name for x in dataclasses.fields(key)}}
    assert tune.key_tag(key) == tune.key_tag(dataclasses.replace(key, **over))
    assert tune.key_tag(key) != tune.key_tag(dataclasses.replace(
        key, dtype="f32" if key.dtype == "bf16" else "bf16"))


def test_lookup_order_overlay_then_table(table):
    key = _brgemm()
    tag = tune.key_tag(key)
    table.write_text(json.dumps({"entries": {tag: {
        "cfg": {"bm": 64, "bn": 128}, "device_kind": H100}}}))
    assert tune.tuned(key) == {"bm": 64, "bn": 128}
    with tune.trial(key, {"bm": 128, "bn": 128}):
        assert tune.tuned(key) == {"bm": 128, "bn": 128}
        with tune.trial(key, {"bm": 64, "bn": 64}):
            assert tune.tuned(key) == {"bm": 64, "bn": 64}
        assert tune.tuned(key) == {"bm": 128, "bn": 128}
    assert tune.tuned(key) == {"bm": 64, "bn": 128}


def test_record_round_trip(table):
    key = _brgemm()
    rows = [{"cfg": {}, "ms": 0.02}, {"cfg": {"bm": 64, "bn": 128,
                                              "split": 4}, "ms": 0.015}]
    tag = tune.record(key, rows[1]["cfg"], 0.015, 0.02, H100, rows)
    assert tune.tuned(key) == {"bm": 64, "bn": 128, "split": 4}
    entry = json.loads(table.read_text())["entries"][tag]
    assert entry["heuristic_ms"] == 0.02 and entry["sweep"] == rows
    assert entry["device_kind"] == H100


def test_an_entry_of_another_card_does_not_bind(table):
    """A TPU entry (the JAX table's device_kind) or another card's never
    binds; on a machine with no card nothing binds."""
    key = _brgemm()
    tag = tune.key_tag(key)
    for kind in ("TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        table.write_text(json.dumps({"entries": {tag: {
            "cfg": {"bm": 64, "bn": 128}, "device_kind": kind}}}))
        tune._load_file.cache_clear()
        assert tune.tuned(key) == {}
    assert build_kernel(key).plan == reference.gemm_plan(key, (0, 0, 0))


def test_nothing_binds_without_a_card(table, monkeypatch):
    key = _brgemm()
    table.write_text(json.dumps({"entries": {tune.key_tag(key): {
        "cfg": {"bm": 64, "bn": 128}, "device_kind": H100}}}))
    assert tune.tuned(key) == {"bm": 64, "bn": 128}
    monkeypatch.setattr(tune, "device_kind", lambda: None)
    assert tune.tuned(key) == {}


def test_the_jax_table_binds_no_hopper_plan(monkeypatch):
    """The JAX package's tuning.json, read as the port's table, binds none
    of its keys on an H100."""
    import os

    import tpp_mlir_tpu.xsmm.tune as jt
    path = os.path.join(os.path.dirname(jt.__file__), "..", "utils",
                        "tuning.json")
    monkeypatch.setenv("TPP_TUNING_PATH", path)
    monkeypatch.setattr(tune, "device_kind", lambda: H100)
    tune._load_file.cache_clear()
    try:
        entries = tune._load_file()
        assert entries
        keys = [k for k in entries if k.startswith("BrgemmKey(")]
        assert all(entries[k]["device_kind"] != H100 for k in entries)
        for tag in keys:
            fields = dict(f.split("=", 1) for f in re.findall(
                r"(\w+=[^,()]+)", tag[len("BrgemmKey("):-1]))
            key = BrgemmKey(batch=int(fields["batch"]), m=int(fields["m"]),
                            n=int(fields["n"]), k=int(fields["k"]),
                            dtype=fields["dtype"])
            assert tune.tuned(key) == {}
    finally:
        tune._load_file.cache_clear()


# ---- the GEMM plans: the legality rule and bk's split ---------------------

def _legal(key, bm, bn, split) -> bool:
    """The rule, written out: the f32-FMA body (f32 "highest") takes 64 x 64
    and no split; the wgmma mainloop 128 x 128, 64 x 128 or 64 x 64 and
    1 <= split <= the key's 64-deep k stages (batch x ceil(k / 64)), no
    split under ln_stats_out."""
    fma = key.dtype == "f32" and key.precision == "highest"
    tiles = {(64, 64)} if fma else {(128, 128), (64, 128), (64, 64)}
    most = 1 if fma or key.ln_stats_out else key.batch * -(-key.k // 64)
    return (bm, bn) in tiles and 1 <= split <= most


@settings(max_examples=150, deadline=None)
@given(m=st.integers(1, 4096), n=st.integers(1, 4096), k=st.integers(1, 4096),
       batch=st.integers(1, 4), form=st.sampled_from(
           ["bf16", "f32", "highest", "stats"]),
       bm=st.sampled_from([0, 32, 64, 96, 128, 256]),
       bn=st.sampled_from([0, 32, 64, 128, 256]),
       split=st.integers(0, 80))
def test_legality_mirror_accepts_exactly_the_legal_plans(m, n, k, batch, form,
                                                        bm, bn, split):
    kw = dict(dtype="bf16" if form == "bf16" else "f32",
              precision="highest" if form == "highest" else "default")
    if form == "stats":
        kw.update(ln_stats_out=True)
        batch = 1
    key = BrgemmKey(batch=batch, m=m, n=n, k=k, **kw)
    if split and bm and bn:
        if _legal(key, bm, bn, split):
            reference.check_gemm_plan(key, (bm, bn, split))
        else:
            with pytest.raises(ValueError, match="the tile is one of"):
                reference.check_gemm_plan(key, (bm, bn, split))
    # zeros take the heuristic's; what resolves is legal or raises
    if (bm == 0) != (bn == 0):
        return
    h = reference.gemm_heuristic(key)
    assert _legal(key, *h)
    want = (bm or h.bm, bn or h.bn,
            split or (h.split if (bm or h.bm, bn or h.bn) == (h.bm, h.bn)
                      else 1))
    if _legal(key, *want):
        assert reference.gemm_plan(key, (bm, bn, split)) == want
    else:
        with pytest.raises(ValueError):
            reference.gemm_plan(key, (bm, bn, split))


@pytest.mark.parametrize("batch,k,bk,split", [
    (1, 1024, 256, 4), (1, 1024, 1024, 1), (1, 1024, 4096, 1),
    (1, 1000, 256, 4), (4, 200, 128, 7), (1, 768, 64, 12)])
def test_bk_is_the_depth_of_one_k_slice(batch, k, bk, split):
    assert reference.bk_split(_brgemm(batch=batch, k=k), bk) == split


@pytest.mark.parametrize("bk", [0, 32, 100, -64])
def test_bk_off_the_stage_raises(bk):
    with pytest.raises(ValueError, match="64-deep k stage"):
        reference.bk_split(_brgemm(), bk)


def test_the_fc_heuristic_splits_k():
    """fc 256 x 1024 x 1024 fills under half the H100's wave at any tile:
    64 x 64 tiles (64 of them) with k split in 2 (132 // 64)."""
    assert reference.gemm_heuristic(_brgemm(dtype="bf16")) == (64, 64, 2)
    assert reference.gemm_heuristic(_brgemm(m=2048, n=2304, k=768,
                                            dtype="bf16")) == (128, 128, 1)


# ---- what a built Kernel captures -----------------------------------------

def test_the_key_then_the_trial_then_the_heuristic():
    key = _brgemm(dtype="bf16")
    assert build_kernel(key).plan == (64, 64, 2)
    with tune.trial(key, {"bm": 128, "bn": 128, "split": 4}):
        assert build_kernel(key).plan == (128, 128, 4)
        # the key's own fields (--register-blocking) always win: bk 256
        # is ceil(1024 / 256) k slices, bk >= K none
        forced = dataclasses.replace(key, bm=64, bn=128, bk=256)
        assert build_kernel(forced).plan == (64, 128, 4)
        forced = dataclasses.replace(key, bm=64, bn=64, bk=1024)
        assert build_kernel(forced).plan == (64, 64, 1)


def test_an_illegal_tuned_plan_raises_rather_than_falling_back():
    key = _brgemm(precision="highest")
    with tune.trial(key, {"bm": 64, "bn": 64, "split": 2}):
        with pytest.raises(ValueError, match="f32-FMA body"):
            build_kernel(key)


def test_warm_plans_bind_the_panel_and_the_cluster():
    key = ChainKey(m=256, dims=(1024,) * 4, dtype="bf16")
    heur = reference.warm_plan(key)
    assert build_kernel(key).plan == heur
    with tune.trial(key, {"bm": 24, "cluster": 8}):
        plan = build_kernel(key).plan
        assert (plan.rows, plan.cluster) == (24, 8)
        # B4 (repeats) shares B3's tag
        plan = build_kernel(dataclasses.replace(key, repeats=5)).plan
        assert (plan.rows, plan.cluster) == (24, 8)
        # the key's bm wins over the table
        assert build_kernel(dataclasses.replace(key, bm=64)).plan.rows == 64
    with tune.trial(key, {"bm": 48}):
        with pytest.raises(ValueError, match="rows in"):
            build_kernel(key)
    with tune.trial(key, {"cluster": 17}):
        with pytest.raises(ValueError, match="1..16"):
            build_kernel(key)
    # the first design has no panel to force; a table entry is not read
    # there, so the first design stays forcible
    highest = ChainKey(m=256, dims=(256, 256), dtype="f32",
                       precision="highest", bm=24)
    with pytest.raises(ValueError, match="first design"):
        build_kernel(highest)
    with tune.trial(key, {"bm": 24, "cluster": 8}):
        assert build_warm(key, "wmma").plan is None


def test_b19_and_b20_share_a_tag_but_not_a_plan():
    b19 = BlockedMatmulKey(Mb=8, Nb=32, Kb=32, mb=32, nb=32, kb=32,
                           dtype="bf16", beta0=True)
    b20 = dataclasses.replace(b19, repeats=4)
    assert tune.key_tag(b19) == tune.key_tag(b20)
    with tune.trial(b19, {"bm": 64, "bn": 128, "split": 2}):
        assert build_kernel(b19).plan == (64, 128, 2)
        assert build_warm(b20, "panel").plan == reference.warm_plan(b20)
    with tune.trial(b19, {"bm": 16, "cluster": 16}):
        assert build_kernel(b19).plan == reference.gemm_heuristic(b19)
        plan = build_warm(b20, "panel").plan
        assert (plan.rows, plan.cluster) == (16, 16) != (
            reference.warm_plan(b20).rows, 16)


# ---- tpp-tune --dry against the JAX tool ----------------------------------

def _tags(text: str) -> list[str]:
    return re.findall(r"^ (\w+Key\(.*\))$", text, re.M)


@pytest.mark.parametrize("gen", [
    "--batch=256 --layers=1024,1024 --bias --relu",
    "--batch=256 --layers=1024,1024,1024,1024 --bias --relu --float-type=bf16",
    "--batch=64 --layers=128,256 --bias --relu",
    "--batch=64 --layers=128,128 --bias --relu --softmax",
])
def test_dry_lists_the_jax_tools_keys(gen, capsys):
    assert jax_tpp_tune.main(["--dry", "--platform", "cpu", "--gen",
                              gen]) == 0
    want = _tags(capsys.readouterr().err)
    assert tpp_tune.main(["--dry", "--device", "cpu", "--gen", gen]) == 0
    cap = capsys.readouterr()
    assert _tags(cap.err) == want and want
    assert json.loads(cap.out.strip().splitlines()[-1])["tuned"] == 0
    assert "candidate: {" in cap.err


def test_dry_lists_legal_candidates_for_the_sms_it_is_given(capsys):
    gen = "--batch=256 --layers=1024,1024 --bias --relu"
    assert tpp_tune.main(["--dry", "--device", "cpu", "--gen", gen, "--key",
                          "BrgemmKey", "--sms", "64"]) == 0
    err = capsys.readouterr().err
    # 64 SMs: 64 x 128's 32 tiles fill half the wave, no split
    assert "heuristic: {'bm': 64, 'bn': 128, 'split': 1}" in err
    cands = [eval(c) for c in re.findall(r"candidate: (\{.*\})", err)]
    key = _brgemm()
    for c in cands:
        reference.check_gemm_plan(key, (c["bm"], c["bn"], c["split"]))
    assert {"bm": 64, "bn": 128, "split": 1} not in cands
    assert {"bm": 128, "bn": 128, "split": 8} in cands
