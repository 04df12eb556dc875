"""MHA kernel benchmarks — Q·Kt, softmax·V, projection.

The reference ships these as hand-written benchmark kernels
(benchmarks/mlir/fp32-{query-times-key,out-softmax-times-value,projection}.mlir
with BENCH_TOTAL_FLOPS headers) plus an MHA tile-and-fuse test
(test/Passes/pass-tile-and-fuse-mha.mlir). Here each piece is an IR builder;
FLOP accounting follows the reference's headers (e.g. QK 67108864 for
batch=64, heads=8(?), seq=32 shapes scaled accordingly).

A copy of `tpp_mlir_tpu/models/mha.py`; tests/test_torch_ir.py holds every
builder to the original's printed IR.
"""

from __future__ import annotations

from ..ir import Function, Module, TensorType, TppBuilder


def build_qk(batch: int = 64, heads: int = 16, seq: int = 32,
             head_dim: int = 64, dtype: str = "f32") -> Module:
    """scores[b,h,s,s] = Q[b,h,s,d] @ K[b,h,s,d]^T, flattened to a batched
    matmul over (batch*heads)."""
    B = batch * heads
    m = Module()
    f = m.add(Function("entry", [
        TensorType((B, seq, head_dim), dtype),
        TensorType((B, seq, head_dim), dtype),
    ], ["q", "k"]))
    b = TppBuilder(f)
    kt = b.transpose(f.args[1], (0, 2, 1))
    acc = b.constant(TensorType((B, seq, seq), dtype), init="zero")
    out = b.batch_matmul(f.args[0], kt, acc)
    b.ret(out)
    m.attrs["flops"] = 2 * B * seq * seq * head_dim
    m.verify()
    return m


def build_softmax_v(batch: int = 64, heads: int = 16, seq: int = 32,
                    head_dim: int = 64, dtype: str = "f32") -> Module:
    """out[b,h,s,d] = softmax(scores) @ V."""
    B = batch * heads
    m = Module()
    f = m.add(Function("entry", [
        TensorType((B, seq, seq), dtype),
        TensorType((B, seq, head_dim), dtype),
    ], ["scores", "v"]))
    b = TppBuilder(f)
    p = b.softmax(f.args[0], axis=2)
    acc = b.constant(TensorType((B, seq, head_dim), dtype), init="zero")
    out = b.batch_matmul(p, f.args[1], acc)
    b.ret(out)
    m.attrs["flops"] = 4 * B * seq * seq + 2 * B * seq * seq * head_dim
    m.verify()
    return m


def build_projection(batch: int = 64, seq: int = 32, model_dim: int = 1024,
                     dtype: str = "f32") -> Module:
    """out[b*s, D] = X @ Wproj."""
    M = batch * seq
    m = Module()
    f = m.add(Function("entry", [
        TensorType((M, model_dim), dtype),
        TensorType((model_dim, model_dim), dtype),
    ], ["x", "w"]))
    b = TppBuilder(f)
    acc = b.constant(TensorType((M, model_dim), dtype), init="zero")
    out = b.matmul(f.args[0], f.args[1], acc)
    b.ret(out)
    m.attrs["flops"] = 2 * M * model_dim * model_dim
    m.verify()
    return m


def build_mha_block(batch: int = 8, heads: int = 16, seq: int = 32,
                    head_dim: int = 64, dtype: str = "f32") -> Module:
    """FULL multi-head attention block: Q/K/V projections + fused attention
    core + output projection, one IR function — the role of the reference's
    imported full-graph benchmark
    (benchmarks/mlir/fp32-mha-tensorflow-seq-len-32.mlir, the
    fp32_mha_tensorflow_seq_len_32 row of config/base/mha.json). Tokens
    enter flattened (batch*seq, E); head split/merge are tl.reshape +
    tl.transpose the layout passes sink."""
    E = heads * head_dim
    M = batch * seq
    m = Module()
    f = m.add(Function("entry", [TensorType((M, E), dtype)], ["x"]))
    b = TppBuilder(f)
    x = f.args[0]

    def proj(seed):
        w = b.constant(TensorType((E, E), dtype), init="normal", seed=seed)
        acc = b.constant(TensorType((M, E), dtype), init="zero")
        return b.matmul(x, w, acc)

    # token layout: heads are column slices selected inside the attention
    # kernel (heads attr) — no head-split transposes anywhere
    q, k, v = (b.reshape(proj(s), (batch, seq, E)) for s in (1, 2, 3))
    att = b.create("tl.attention", [q, k, v],
                   [TensorType((batch, seq, E), dtype)],
                   {"scale": head_dim ** -0.5, "heads": heads}).result
    ctx = b.reshape(att, (M, E))
    wo = b.constant(TensorType((E, E), dtype), init="normal", seed=4)
    acco = b.constant(TensorType((M, E), dtype), init="zero")
    out = b.matmul(ctx, wo, acco)
    b.ret(out)
    BH = batch * heads
    m.attrs["flops"] = (4 * 2 * M * E * E
                        + 4 * BH * seq * seq * head_dim
                        + 4 * BH * seq * seq)
    m.verify()
    return m


def build_mha(batch: int = 16, heads: int = 16, seq: int = 256,
              head_dim: int = 64, dtype: str = "f32",
              causal: bool = False, scale: float | None = None,
              fused: bool = False, strategy: str | None = None,
              bq: int = 0, bk: int = 0) -> Module:
    """Full attention core: softmax(Q Kt * scale) V as one IR function (the
    tile-and-fuse MHA test case shape). With fused=True (or causal, which
    has no unfused IR spelling) the builder emits tl.attention directly,
    the way a frontend would; otherwise the Q.Kt/softmax/V chain is left for
    attention-fusion to recognize."""
    B = batch * heads
    m = Module()
    f = m.add(Function("entry", [
        TensorType((B, seq, head_dim), dtype),
        TensorType((B, seq, head_dim), dtype),
        TensorType((B, seq, head_dim), dtype),
    ], ["q", "k", "v"]))
    b = TppBuilder(f)
    if fused or causal:
        attrs = {"scale": scale if scale is not None else 1.0}
        if causal:
            attrs["causal"] = True
        if strategy:
            attrs["strategy"] = strategy
        if bq:
            attrs["bq"] = bq
        if bk:
            attrs["bk"] = bk
        out = b.create("tl.attention", list(f.args),
                       [TensorType((B, seq, head_dim), dtype)], attrs).result
    else:
        kt = b.transpose(f.args[1], (0, 2, 1))
        acc = b.constant(TensorType((B, seq, seq), dtype), init="zero")
        scores = b.batch_matmul(f.args[0], kt, acc)
        if scale is not None:
            sc = b.constant(TensorType((1,), dtype), init="const",
                            value=scale)
            scores = b.mul(scores, sc)
        p = b.softmax(scores, axis=2)
        acc2 = b.constant(TensorType((B, seq, head_dim), dtype), init="zero")
        out = b.batch_matmul(p, f.args[2], acc2)
    b.ret(out)
    flops = (2 * B * seq * seq * head_dim) * 2 + 4 * B * seq * seq
    if causal:
        # only the lower triangle is useful work — count it honestly
        # (FlashAttention convention). The kernel itself does FULL-square
        # masked work on v5e (every work-skipping schedule measured slower,
        # see PERF.md); halving counts useful flops, not kernel flops.
        flops //= 2
    m.attrs["flops"] = flops
    m.verify()
    return m
