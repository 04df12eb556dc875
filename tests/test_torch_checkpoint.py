"""Checkpoints in the port (tpp_mlir_tpu_torch.parallel.checkpoint): the
JAX package's round trips (tests/parallel/test_parallel.py
test_checkpoint_roundtrip, tests/parallel/test_optim.py
test_zero1_checkpoint_resume_matches_uninterrupted at one device,
tests/serving/test_quant.py test_quantized_checkpoint_roundtrip) on the
port's trees, the `step_<n>` layout both packages write, and a LoRA run
(adapters and optimizer state) resumed from a checkpoint. Every comparison
is exact: a checkpoint stores the bits, and a resumed run repeats the
uninterrupted run's arithmetic."""

import os

import jax
import numpy as np
import pytest
import torch

import tpp_mlir_tpu_torch.serving as P
from tpp_mlir_tpu.parallel.checkpoint import \
    latest_step as jax_latest_step
from tpp_mlir_tpu.parallel.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from tpp_mlir_tpu.parallel import mlp_init as jax_mlp_init
from tpp_mlir_tpu_torch.parallel import (adamw, latest_step,
                                         make_optim_train_step, mlp_init,
                                         restore_checkpoint, save_checkpoint,
                                         tree_leaves)

LAYERS = (32, 64, 64, 32)
CFG = dict(vocab=89, embed=32, heads=4, layers=2, mlp_ratio=2, max_seq=24,
           dtype="f32")


def _equal_trees(a, b):
    la = [t for t in tree_leaves(a) if isinstance(t, torch.Tensor)]
    lb = [t for t in tree_leaves(b) if isinstance(t, torch.Tensor)]
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    params = mlp_init((32, 64, 32), seed=7, device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), params, step=3)
    assert latest_step(str(tmp_path / "ckpt")) == 3
    like = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    restored, step = restore_checkpoint(str(tmp_path / "ckpt"), like, step=3)
    assert step == 3
    for (w1, b1), (w2, b2) in zip(params, restored):
        assert torch.equal(w1, w2) and torch.equal(b1, b2)


def test_the_step_layout_is_the_jax_packages(tmp_path):
    """Both packages write step_<n> directories, so latest_step reads
    either's; a path with none gives None."""
    jax_save_checkpoint(str(tmp_path / "j"), jax_mlp_init((8, 8), seed=0),
                        step=5)
    save_checkpoint(str(tmp_path / "p"), mlp_init((8, 8), device="cpu"),
                    step=5)
    assert sorted(os.listdir(tmp_path / "j")) == \
        sorted(os.listdir(tmp_path / "p")) == ["step_5"]
    assert latest_step(str(tmp_path / "j")) == jax_latest_step(
        str(tmp_path / "p")) == 5
    assert latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quantized_checkpoint_roundtrip(tmp_path, bits):
    """QTensor leaves (int8, and int4's packed payload with its bits and
    shape) come back as QTensors, and the file loads with
    torch.load(weights_only=True)."""
    cfg = P.GptConfig(**CFG)
    params = P.quantize_params(P.init_params(cfg, seed=13, device="cpu"),
                               bits=bits)
    save_checkpoint(str(tmp_path / "q"), params, step=1)
    torch.load(tmp_path / "q" / "step_1" / "state.pt", weights_only=True)
    like = P.quantize_params(P.init_params(cfg, seed=99, device="cpu"),
                             bits=bits)
    got, step = restore_checkpoint(str(tmp_path / "q"), like, step=1)
    assert step == 1
    _equal_trees(got, params)
    blk = got["blocks"][0]["wq"]
    assert isinstance(blk, P.QTensor) and blk.bits == bits
    assert blk.dims == (CFG["embed"], CFG["embed"])


def test_a_tree_of_another_shape_is_refused(tmp_path):
    save_checkpoint(str(tmp_path), mlp_init((8, 16), device="cpu"), step=0)
    with pytest.raises(ValueError, match="does not fit"):
        restore_checkpoint(str(tmp_path), mlp_init((8, 8), device="cpu"))


def test_optimizer_resume_matches_uninterrupted(tmp_path):
    """train, checkpoint {params, opt_state}, restore into a fresh run,
    continue: the resumed run equals the uninterrupted one bit for bit."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    step, init = make_optim_train_step(LAYERS, adamw(1e-2), device="cpu")

    p = mlp_init(LAYERS, seed=9, device="cpu")
    s = init(p)
    for _ in range(4):
        p, s, _ = step(p, s, x, y)

    q = mlp_init(LAYERS, seed=9, device="cpu")
    t = init(q)
    for _ in range(2):
        q, t, _ = step(q, t, x, y)
    save_checkpoint(str(tmp_path), {"params": q, "opt": t}, step=2)
    fresh = mlp_init(LAYERS, seed=1, device="cpu")
    restored, at = restore_checkpoint(
        str(tmp_path), {"params": fresh, "opt": init(fresh)}, step=2)
    q, t = restored["params"], restored["opt"]
    assert at == 2
    for _ in range(2):
        q, t, _ = step(q, t, x, y)
    _equal_trees(q, p)


@pytest.mark.parametrize("bits", [0, 4], ids=["lora", "qlora-int4"])
def test_lora_resume_matches_uninterrupted(tmp_path, bits):
    """Adapters and AdamW state checkpointed after two LoRA steps and
    restored into fresh adapters: two more steps give the uninterrupted
    run's adapters and losses, bit for bit."""
    cfg = P.GptConfig(**CFG)
    base = P.init_params(cfg, seed=2, device="cpu")
    if bits:
        base = P.quantize_params(base, bits=bits)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG["vocab"], (2, 12)).astype(np.int32))
    step, init = P.make_lora_train_step(cfg, adamw(3e-2))

    def fresh(seed):
        ad = P.lora_init(base, rank=4, targets=("wq", "wv"), seed=seed,
                         device="cpu")
        return ad, init(ad)

    ad, st = fresh(0)
    losses = [step(base, ad, st, ids)[2] for _ in range(4)]

    ad2, st2 = fresh(0)
    for _ in range(2):
        step(base, ad2, st2, ids)
    save_checkpoint(str(tmp_path), {"adapters": ad2, "opt": st2}, step=2)
    ad3, st3 = fresh(5)
    got, _ = restore_checkpoint(str(tmp_path),
                                {"adapters": ad3, "opt": st3}, step=2)
    ad3, st3 = got["adapters"], got["opt"]
    resumed = [step(base, ad3, st3, ids)[2] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(resumed, losses[2:]))
    _equal_trees(ad3, ad)


def test_jax_params_saved_by_the_port_restore_exactly(tmp_path):
    """A JAX params tree carried into the port (params_from_numpy), saved
    and restored, keeps the JAX bits."""
    import tpp_mlir_tpu.serving as J
    jcfg = J.GptConfig(**CFG)
    jp = J.quantize_params(J.init_params(jcfg, seed=4), bits=4)
    pcfg = P.GptConfig(**CFG)
    pp = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                             device="cpu")
    save_checkpoint(str(tmp_path), pp, step=7)
    like = P.params_from_numpy(jax.tree.map(np.asarray, jp), pcfg,
                               device="cpu")
    for t in tree_leaves(like):
        if isinstance(t, torch.Tensor):
            t.zero_()
    got, _ = restore_checkpoint(str(tmp_path), like, step=7)
    assert np.array_equal(got["lm_head"].values().numpy(),
                          np.asarray(jp["lm_head"].q, np.int8))
    assert np.array_equal(got["blocks"][1]["w1"].scale.numpy(),
                          np.asarray(jp["blocks"][1]["w1"].scale))
