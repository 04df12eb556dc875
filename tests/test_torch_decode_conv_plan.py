"""The launch plans and routes of csrc/decode_attn.cu (B13) and
csrc/conv.cu (B23-B25), pinned as pure functions of the key for every key
form chip_smoke.py holds on the card (and the `cuda` tests' keys), and a
PyTorch emulation of decode_attn.cu's split-then-merge order held to the
JAX package's build_decode_attn in interpret mode.

Tolerance of the emulation 1e-5 (max |emulation - JAX|, relative to max
|JAX|): both compute in f32 from the same values; only the order of the
sums differs (per chunk, then the chunks merged by their maxima).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpp_mlir_tpu.serving.quant import quantize_tokens as jax_quantize_tokens
from tpp_mlir_tpu.xsmm.decode_attn import (DecodeAttnKey as JaxDecodeKey,
                                           build_decode_attn)
from tpp_mlir_tpu_torch.xsmm import (ConvBrgemmKey, ConvNhwcKey,
                                     DecodeAttnKey, reference_kernel)
from tpp_mlir_tpu_torch.xsmm.reference import (DECODE_CHUNK_BYTES,
                                               DECODE_TILE, conv_gemm_shape,
                                               conv_kernel_route, conv_plan,
                                               decode_attn_plan)

SERVE = dict(batch=8, seq=1024, head_dim=64, stacked=12)

DECODE_PLANS = {
    # chip_smoke.py's serving keys (phase 3, phase 5's walk): 5 of 8
    # splits live at pos 639 (480 blocks; GQA kv4 160)
    "mha-serve": (DecodeAttnKey(heads=12, **SERVE), (128, 8)),
    "slotted-serve": (DecodeAttnKey(heads=12, slotted=True, **SERVE),
                      (128, 8)),
    "gqa-kv4-g3": (DecodeAttnKey(heads=4, groups=3, **SERVE), (128, 8)),
    "int8-kv": (DecodeAttnKey(heads=12, kv_quant=True, **SERVE), (128, 8)),
    "pack2": (DecodeAttnKey(heads=12, pack2=True, **SERVE), (128, 8)),
    # f32 rows are 512 bytes of K and V: the 48 KB cap holds 96, so 64
    "mha-f32": (DecodeAttnKey(heads=12, dtype="f32", **SERVE), (64, 16)),
    # the MoE serving decode at max_seq 640
    "moe-serve-640": (DecodeAttnKey(8, 12, 640, 64, stacked=12), (128, 5)),
    # tests/test_torch_cuda.py's keys
    "cuda-mha": (DecodeAttnKey(4, 6, 256, 64, "bf16", stacked=3), (64, 4)),
    "cuda-d128-g8-int8": (DecodeAttnKey(2, 2, 128, 128, "f32", groups=8,
                                        kv_quant=True, stacked=3), (64, 2)),
    "cuda-d32-f32": (DecodeAttnKey(2, 4, 64, 32, "f32", stacked=3), (64, 1)),
    "cuda-split-edges": (DecodeAttnKey(5, 2, 512, 64, "bf16", slotted=True,
                                       stacked=2), (64, 8)),
    # a short cache is one split of one partial tile
    "s32": (DecodeAttnKey(2, 4, 32, 16, "f32"), (64, 1)),
    # one head: 64-row chunks, as many blocks as the cache has tiles
    "b1-h1": (DecodeAttnKey(1, 1, 4096, 64, "bf16", kv_quant=True),
              (64, 64)),
    # a long cache meets the two-tile cap
    "int8-long": (DecodeAttnKey(8, 12, 8192, 64, "bf16", kv_quant=True),
                  (128, 64)),
}


@pytest.mark.parametrize("name", list(DECODE_PLANS))
def test_decode_attn_plan(name):
    key, want = DECODE_PLANS[name]
    chunk, splits = decode_attn_plan(key)
    assert (chunk, splits) == want
    # what decode_attn.cu checks: whole 64-row tiles, at most two, every
    # row in exactly one chunk; the cap holds above one tile
    assert chunk % DECODE_TILE == 0 and DECODE_TILE <= chunk <= 128
    assert (splits - 1) * chunk < key.seq <= splits * chunk
    es = 1 if key.kv_quant else (4 if key.dtype == "f32" else 2)
    assert chunk == DECODE_TILE or 2 * chunk * key.head_dim * es <= \
        DECODE_CHUNK_BYTES


FC = dict(beta0=True, binary_kind="add", unary_kind="relu")
C128 = ConvNhwcKey(N=8, H=30, W=30, C=128, K=128, R=3, S=3,
                   out_dtype="f32", binary_bcast="none", unary_kind="relu")
PACKED = dict(N=8, H=30, W=30, Cb=1, c=128, Kb=1, k=128, R=3, S=3, **FC)
RESNET = dict(N=8, H=18, W=18, Cb=1, c=128, Kb=1, k=128, R=3, S=3)

CONV_ROUTES = {
    # chip_smoke.py's conv kernel cases (phase 4g's keys, phase 5's)
    # convert: one block an SM, so one wave of the largest tiles, k split
    "c128-30-f32": (C128, "convert", (128, 128, 2)),
    "c128-30-highest": (dataclasses.replace(C128, precision="highest"),
                        "fma", None),
    "c128-30-bf16": (dataclasses.replace(C128, dtype="bf16",
                                         out_dtype="bf16"),
                     "tma", (64, 128, 2)),
    "c256-16-f32": (dataclasses.replace(C128, H=16, W=16, C=256, K=256),
                    "convert", (64, 128, 2)),
    # four 64-channel slices: no split
    "1x1-w14-c256": (ConvNhwcKey(N=8, H=14, W=14, C=256, K=256,
                                 out_dtype="f32", **FC),
                     "convert", (64, 128, 1)),
    # 2048 pixels x 128: 64 tiles of 64 x 64 fill under a third of the
    # tma route's 264 slots (two blocks an SM)
    "resnet-nhwc-bf16-residual": (
        ConvNhwcKey(N=8, H=16, W=16, C=128, K=128, R=3, S=3, dtype="bf16",
                    out_dtype="bf16", binary_kind="add", binary_bcast="none",
                    unary_kind="relu", pad=(1, 1, 1, 1)),
        "tma", (64, 64, 2)),
    "c128-30-fullrow": (dataclasses.replace(C128, strategy="fullrow"),
                        "convert", (128, 128, 2)),
    "c128-30-window": (dataclasses.replace(C128, strategy="window"),
                       "convert", (128, 128, 2)),
    "vit-patch-xla": (ConvNhwcKey(N=8, H=128, W=128, C=3, K=512, R=16,
                                  S=16, stride_h=16, stride_w=16,
                                  precision="highest"), "xla", None),
    # packed parity mode's keys (B23)
    "packed-c128-30-f32": (ConvBrgemmKey(**PACKED), "convert",
                           (128, 128, 2)),
    "packed-c128-30-bf16": (ConvBrgemmKey(**PACKED, dtype="bf16"), "tma",
                            (64, 128, 2)),
    # Kb 2: tiles per image (196 pixels): 64 x 128 makes 64, split 2
    "packed-c256-16-cb2": (ConvBrgemmKey(**dict(PACKED, H=16, W=16, Cb=2,
                                                Kb=2)),
                           "convert", (64, 128, 2)),
    "packed-resnet-conv1": (ConvBrgemmKey(**RESNET, unary_kind="relu"),
                            "convert", (64, 64, 2)),
    "packed-resnet-bf16": (ConvBrgemmKey(**RESNET, dtype="bf16"), "tma",
                           (64, 64, 2)),
    "packed-2layer-conv2": (ConvBrgemmKey(**dict(PACKED, H=28, W=28)),
                            "convert", (64, 128, 1)),
    # channel counts the loaders cannot take go to the WMMA tile body
    "bf16-c12": (ConvNhwcKey(N=2, H=8, W=8, C=12, K=64, R=3, S=3,
                             dtype="bf16"), "wmma", None),
    "bf16-k20": (ConvNhwcKey(N=2, H=8, W=8, C=64, K=20, dtype="bf16"),
                 "wmma", None),
    "f32-c6": (ConvNhwcKey(N=2, H=8, W=8, C=6, K=64, R=3, S=3), "wmma",
               None),
    "blocked-bf16-c12": (ConvBrgemmKey(N=2, H=6, W=6, Cb=2, c=12, Kb=1,
                                       k=16, R=3, S=3, dtype="bf16"),
                         "wmma", None),
    # tests/test_torch_cuda.py's wgmma edge keys
    "cuda-c8-k72-bf16-asym": (
        ConvNhwcKey(N=3, H=9, W=7, C=8, K=72, R=3, S=3, dtype="bf16",
                    pad=(1, 0, 2, 1), **FC), "tma", (64, 64, 1)),
    "cuda-c24-k72-f32-asym": (
        ConvNhwcKey(N=2, H=11, W=10, C=24, K=72, R=3, S=2, pad=(0, 2, 1, 0),
                    binary_kind="add", binary_bcast="none",
                    unary_kind="gelu"), "convert", (64, 64, 1)),
    "cuda-1x1-c24-bf16": (ConvNhwcKey(N=2, H=7, W=9, C=24, K=72,
                                      dtype="bf16", out_dtype="f32"),
                          "tma", (64, 64, 1)),
    "cuda-blocked-cb2-f32": (ConvBrgemmKey(N=2, H=9, W=8, Cb=2, c=24, Kb=2,
                                           k=72, R=3, S=3, **FC),
                             "convert", (64, 64, 2)),
    "cuda-blocked-cb2-bf16-c": (ConvBrgemmKey(N=2, H=6, W=7, Cb=2, c=64,
                                              Kb=3, k=40, R=2, S=3,
                                              dtype="bf16"),
                                "tma", (64, 64, 1)),
    "cuda-64x128-bf16": (ConvNhwcKey(N=8, H=36, W=36, C=64, K=128, R=3,
                                     S=3, dtype="bf16", **FC),
                         "tma", (64, 128, 1)),
    "cuda-tma-split-bf16": (ConvNhwcKey(N=2, H=18, W=18, C=128, K=128,
                                        R=3, S=3, dtype="bf16"),
                            "tma", (64, 64, 2)),
    "cuda-128x128-f32": (ConvNhwcKey(N=8, H=36, W=36, C=64, K=128, R=3,
                                     S=3, **FC), "convert", (128, 128, 1)),
}


@pytest.mark.parametrize("name", list(CONV_ROUTES))
def test_conv_kernel_route_and_plan(name):
    key, route, plan = CONV_ROUTES[name]
    assert conv_kernel_route(key) == route
    if plan is None:
        return
    assert conv_plan(key) == plan
    # a split leaves each slice at least eight 64-deep stages; the tma
    # route's tiles are 64 rows (two blocks an SM)
    Mb, Nb, KT, mb, nb = conv_gemm_shape(key)
    assert KT // plan[2] >= 8 or plan[2] == 1
    assert route == "convert" or plan[0] == 64


def test_conv_gemm_shape_keeps_a_tile_in_one_output_block():
    """Kb > 1: rows per image, so a tile's rows share one [N, Kb, P, Q, k]
    block; Kb 1 (and NHWC): one block of all N P Q pixels."""
    cb2 = ConvBrgemmKey(**dict(PACKED, H=16, W=16, Cb=2, Kb=2))
    assert conv_gemm_shape(cb2) == (8, 2, 2 * 9 * 2, 14 * 14, 128)
    assert conv_gemm_shape(C128) == (1, 1, 9 * 2, 8 * 28 * 28, 128)
    assert conv_gemm_shape(ConvBrgemmKey(**PACKED)) == \
        (1, 1, 9 * 2, 8 * 28 * 28, 128)


# -- decode_attn.cu's split-then-merge order, against the JAX package ------

def split_merge(key, q, k, v, pos, li, k_s=None, v_s=None):
    """decode_attn.cu's arithmetic order in f32 on CPU tensors: for each
    (batch row, KV head), the live rows min(pos + 1, S) in chunks of
    decode_attn_plan's size; per chunk the scores (dot * D^-0.5 [* ks]),
    one max, exp(s - max), their sum l and the exp-weighted [x vs] sum of
    V's rows; a head with one live chunk divides directly, else its chunks
    merge in split order, each scaled by exp(m - max over chunks)."""
    chunk, splits = decode_attn_plan(key)
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    kf, vf = k[li].float(), v[li].float()
    if key.pack2:       # head h at slot h // 2, columns (h % 2) * D
        kf, vf = (t.reshape(B, H // 2, S, 2, D).transpose(2, 3)
                  .reshape(B, H, S, D) for t in (kf, vf))
    qf = q.float().reshape(B, H, G, D)
    out = torch.empty(B, H, G, D)
    for b in range(B):
        p = int(pos[b] if key.slotted else pos.reshape(-1)[0])
        live = min(p + 1, S)
        for h in range(H):
            parts = []
            for s in range(splits):
                lo = s * chunk
                if lo >= live:
                    continue        # a split with no live row exits
                rows = slice(lo, min(lo + chunk, live))
                sc = (kf[b, h, rows][None] * qf[b, h, :, None]).sum(-1) \
                    * D ** -0.5                             # (G, n)
                if key.kv_quant:
                    sc = sc * k_s[li][b, h, rows]
                m = sc.amax(-1)
                e = torch.exp(sc - m[:, None])
                w = e * v_s[li][b, h, rows] if key.kv_quant else e
                parts.append((m, e.sum(-1), w @ vf[b, h, rows]))
            if len(parts) == 1:
                m, l, acc = parts[0]
                out[b, h] = acc / l[:, None]
                continue
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            L, A = torch.zeros(G), torch.zeros(G, D)
            for m, l, acc in parts:
                f = torch.exp(m - M)
                L = L + l * f
                A = A + acc * f[:, None]
            out[b, h] = A / L[:, None]
    if key.pack2:
        return out.reshape(B, H // 2, 2 * D)
    return out[:, :, 0] if G == 1 else out


LI = 1

# chunks of 64 rows (decode_attn_plan at these keys): pos 0 (one live row,
# three splits with none), 63 and 64 (the chunk edge: one whole chunk; a
# second of one row), S - 1, and S (a free slot: every row)
SPLIT_CASES = {
    "slotted-edges-f32": (DecodeAttnKey(5, 2, 256, 32, "f32", slotted=True,
                                        stacked=2), [0, 63, 64, 255, 256]),
    "gqa-g3-pos128-f32": (DecodeAttnKey(2, 2, 256, 32, "f32", groups=3,
                                        stacked=2), [128]),
    "int8-slotted": (DecodeAttnKey(3, 2, 192, 32, "f32", slotted=True,
                                   kv_quant=True, stacked=2), [191, 64, 0]),
    "pack2-pos191": (DecodeAttnKey(2, 4, 256, 32, "f32", pack2=True,
                                   stacked=2), [191]),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_merge_order_matches_jax(name):
    key, pos = SPLIT_CASES[name]
    assert decode_attn_plan(key)[1] > 1       # the merge is exercised
    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    rng = np.random.default_rng(7)
    if key.pack2:
        q_shape, slab = (B, H // 2, 2 * D), (2, B, H // 2, S, 2 * D)
    else:
        q_shape = (B, H, D) if G == 1 else (B, H, G, D)
        slab = (2, B, H, S, D)
    q = rng.standard_normal(q_shape, np.float32)
    k = rng.standard_normal(slab, np.float32) * 2
    v = rng.standard_normal(slab, np.float32)
    jk, jv, scales = jnp.asarray(k), jnp.asarray(v), {}
    if key.kv_quant:
        jk, ks = jax_quantize_tokens(jk)
        jv, vs = jax_quantize_tokens(jv)
        k, v = np.array(jk), np.array(jv)
        scales = {"k_s": np.array(ks), "v_s": np.array(vs)}
    pos = np.asarray(pos, np.int32)
    want = np.asarray(build_decode_attn(
        JaxDecodeKey(**dataclasses.asdict(key)), interpret=True)(
        jnp.asarray(q), jk, jv, jnp.asarray(pos), LI,
        **{n: jnp.asarray(s) for n, s in scales.items()}))
    targs = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(pos), LI)
    tscales = {n: torch.from_numpy(s) for n, s in scales.items()}
    got = split_merge(key, *targs, **tscales).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5
    # and the plain version the card's kernel is held to agrees
    plain = reference_kernel(key)(*targs, **tscales).numpy()
    assert np.abs(plain - got).max() / np.abs(want).max() <= 1e-5
