"""Op set: `tl` (tensor-language, the linalg-subset), `xsmm`, `perf`, `check`.

Each op has a verifier; `verify_op` dispatches on opname. Semantics are
destination-passing SSA: contraction ops take the accumulator C as an operand
and return the updated tensor (the functional analogue of the reference's
linalg ops on tensors; ops are never in-place because JAX is functional —
the reference's ConvertLinalgToInplace pass has no TPU equivalent, XLA's
buffer assignment performs that role).

Reference op surface being mirrored:
  - linalg subset: matmul/batch_reduce_matmul/fill/transpose/eltwise/pack/
    unpack/conv (SURVEY.md 2.1, 2.3)
  - xsmm dialect: dispatch/invoke split with flags
    (reference include/TPP/Dialect/Xsmm/XsmmOps.td:30-318, XsmmEnum.td:13-84)
  - perf/check dialects (reference include/TPP/Dialect/{Perf,Check})
"""

from __future__ import annotations

from typing import Any, Callable

from .core import Builder, Operation, Value
from .types import TensorType

# ---------------------------------------------------------------------------
# Enums (mirroring reference include/TPP/Dialect/Xsmm/XsmmEnum.td:13-84)
# ---------------------------------------------------------------------------

UNARY_KINDS = ("none", "identity", "zero", "relu", "vnni2", "transpose",
               "exp", "square", "sqrt", "negate", "rsqrt", "tanh", "gelu", "gelu_tanh")
BINARY_KINDS = ("none", "add", "mul", "sub", "div", "max")
# GemmFlags: beta_0 folds away the zero-fill of the accumulator; vnni_b means
# the B operand is in VNNI layout (on TPU: native bf16 packed operand).
GEMM_FLAGS = ("none", "beta_0", "vnni_a", "vnni_b", "vnni_c", "transpose_b")
# Broadcast flags for unary/binary (XsmmEnum.td UnaryFlags/BinaryFlags):
#   none / bcast_row (operand broadcasts along rows) / bcast_col / bcast_scalar
BCAST_FLAGS = ("none", "bcast_row", "bcast_col", "bcast_scalar")

I64 = TensorType((), "i64")
F64 = TensorType((), "f32")

_VERIFIERS: dict[str, Callable[[Operation], None]] = {}


def _op(name: str):
    def deco(fn):
        _VERIFIERS[name] = fn
        return fn
    return deco


def verify_op(op: Operation) -> None:
    v = _VERIFIERS.get(op.opname)
    if v is None:
        raise ValueError(f"unknown op '{op.opname}'")
    v(op)


def _fail(op: Operation, msg: str):
    raise ValueError(f"'{op.opname}' verifier: {msg}")


def _t(v: Value) -> TensorType:
    return v.type


def _same_dtype(op, *vals):
    dts = {v.type.dtype for v in vals}
    if len(dts) > 1:
        _fail(op, f"mixed dtypes {sorted(dts)}")


def broadcast_shapes(a: tuple[int, ...], b: tuple[int, ...]) -> tuple[int, ...]:
    """NumPy-style broadcast (the reference infers BCAST flags from affine
    maps, ConvertLinalgToXsmm.cpp:181-427; we use shape broadcasting)."""
    ra, rb = len(a), len(b)
    r = max(ra, rb)
    a = (1,) * (r - ra) + a
    b = (1,) * (r - rb) + b
    out = []
    for x, y in zip(a, b):
        if x == y or x == 1 or y == 1:
            out.append(max(x, y))
        else:
            raise ValueError(f"cannot broadcast {a} with {b}")
    return tuple(out)


# ---------------------------------------------------------------------------
# tl dialect verifiers
# ---------------------------------------------------------------------------

@_op("tl.constant")
def _v_constant(op):
    if op.operands:
        _fail(op, "takes no operands")
    init = op.attrs.get("init", "zero")
    if not isinstance(init, str):
        _fail(op, "init attr must be a string kind")


@_op("tl.fill")
def _v_fill(op):
    if len(op.operands) != 1:
        _fail(op, "expects (dest)")
    if op.result.type != op.operands[0].type:
        _fail(op, "result type must match dest")
    if "value" not in op.attrs:
        _fail(op, "needs 'value' attr")


@_op("tl.matmul")
def _v_matmul(op):
    if len(op.operands) != 3:
        _fail(op, "expects (A, B, C)")
    a, b, c = (_t(x) for x in op.operands)
    if a.rank != 2 or b.rank != 2 or c.rank != 2:
        _fail(op, "operands must be rank-2")
    m, k = a.shape
    k2, n = b.shape
    if op.attrs.get("transpose_b"):
        n, k2 = k2, n
    if k != k2 or c.shape != (m, n):
        _fail(op, f"shape mismatch {a.shape} x {b.shape} -> {c.shape}")
    if op.result.type != c:
        _fail(op, "result must match C")


@_op("tl.generic")
def _v_generic(op):
    """Affine-map-lite structured op — the linalg.generic equivalent
    (reference ConvertLinalgToXsmm.cpp:181-640 classifies these; our maps
    are projected permutations, the only class the reference matches)."""
    from .affine import is_projected_permutation, verify_body

    for a in ("indexing_maps", "iterator_types", "body"):
        if a not in op.attrs:
            _fail(op, f"missing attr '{a}'")
    maps = [tuple(m) for m in op.attrs["indexing_maps"]]
    iters = tuple(op.attrs["iterator_types"])
    if len(op.operands) < 1:
        _fail(op, "needs at least the init operand")
    if len(maps) != len(op.operands):
        _fail(op, f"{len(maps)} maps for {len(op.operands)} operands")
    for it in iters:
        if it not in ("parallel", "reduction"):
            _fail(op, f"bad iterator type {it!r}")
    sizes: dict[int, int] = {}
    for v, mp in zip(op.operands, maps):
        if len(mp) != v.type.rank:
            _fail(op, f"map {mp} rank != operand rank {v.type.rank}")
        if not is_projected_permutation(mp):
            _fail(op, f"map {mp} is not a projected permutation")
        for d, s in zip(mp, v.type.shape):
            if not (0 <= d < len(iters)):
                _fail(op, f"map dim {d} out of range")
            if sizes.setdefault(d, s) != s:
                _fail(op, f"dim {d} sized both {sizes[d]} and {s}")
    for d in maps[-1]:
        if iters[d] != "parallel":
            _fail(op, "output map must use only parallel dims")
    if op.result.type != op.operands[-1].type:
        _fail(op, "result type must match the init operand")
    try:
        verify_body(op.attrs["body"], len(op.operands))
    except ValueError as e:
        _fail(op, str(e))


@_op("tl.batch_matmul")
def _v_batch_matmul(op):
    if len(op.operands) != 3:
        _fail(op, "expects (A, B, C)")
    a, b, c = (_t(x) for x in op.operands)
    if op.attrs.get("lhs_shared"):
        # rank-2 A shared across the batch: C[b] = A @ B[b] (the
        # 1x1-NCHW-conv-as-GEMM form, reference RewriteConvToMatmulImpl.cpp)
        if a.rank != 2 or b.rank != 3 or c.rank != 3:
            _fail(op, "lhs_shared expects A rank-2, B/C rank-3")
        m, k = a.shape
        B2, k2, n = b.shape
        if k != k2 or c.shape != (B2, m, n):
            _fail(op, f"shape mismatch {a.shape} x {b.shape} -> {c.shape}")
        return
    if not (a.rank == b.rank == c.rank == 3):
        _fail(op, "operands must be rank-3")
    B, m, k = a.shape
    B2, k2, n = b.shape
    if B != B2 or k != k2 or c.shape != (B, m, n):
        _fail(op, f"shape mismatch {a.shape} x {b.shape} -> {c.shape}")


@_op("tl.brgemm")
def _v_brgemm(op):
    # batch-reduce GEMM: C[m,n] += sum_b A[b,m,k] @ B[b,k,n]
    # (reference linalg.batch_reduce_matmul, RewriteToBatchReduceGemm.cpp)
    if len(op.operands) != 3:
        _fail(op, "expects (A, B, C)")
    a, b, c = (_t(x) for x in op.operands)
    if a.rank != 3 or b.rank != 3 or c.rank != 2:
        _fail(op, "A,B rank-3; C rank-2")
    B, m, k = a.shape
    B2, k2, n = b.shape
    if B != B2 or k != k2 or c.shape != (m, n):
        _fail(op, f"shape mismatch {a.shape} x {b.shape} -> {c.shape}")


@_op("tl.vnni_brgemm")
def _v_vnni_brgemm(op):
    # bf16 batch-reduce GEMM with B in VNNI layout [b, k/vf, n, vf]
    # (reference PackVNNI, ToBlockLayoutAndBack.cpp:642-680). On TPU the
    # layout exists for capability parity; the kernel consumes native bf16.
    if len(op.operands) != 3:
        _fail(op, "expects (A, B, C)")
    a, b, c = (_t(x) for x in op.operands)
    vf = op.attrs.get("vnni", 2)
    if a.rank != 3 or b.rank != 4 or c.rank != 2:
        _fail(op, "A rank-3, B rank-4 (VNNI), C rank-2")
    B, m, k = a.shape
    B2, kv, n, vf2 = b.shape
    if B != B2 or kv * vf2 != k or vf2 != vf or c.shape != (m, n):
        _fail(op, f"VNNI shape mismatch {a.shape} x {b.shape} -> {c.shape}")


@_op("tl.blocked_matmul")
def _v_blocked_matmul(op):
    # C[Mb,Nb,mb,nb] += A[Mb,Kb,mb,kb] * B[Nb,Kb,kb,nb]
    # (the reference's PackMatmul target layout, ToBlockLayoutAndBack.cpp:484)
    # With a 'vnni' attr, B is additionally VNNI-packed: [Nb,Kb,kb/vf,nb,vf].
    if len(op.operands) != 3:
        _fail(op, "expects (A, B, C)")
    a, b, c = (_t(x) for x in op.operands)
    vf = op.attrs.get("vnni", 0)
    if a.rank != 4 or c.rank != 4 or b.rank != (5 if vf else 4):
        _fail(op, "operands must be rank-4 blocked"
                  + (" (B rank-5 VNNI)" if vf else ""))
    Mb, Kb, mb, kb = a.shape
    if vf:
        Nb, Kb2, kv, nb, vf2 = b.shape
        if vf2 != vf or kv * vf != kb:
            _fail(op, f"bad VNNI B {b.shape} for kb={kb}, vnni={vf}")
    else:
        Nb, Kb2, kb2, nb = b.shape
        if kb != kb2:
            _fail(op, f"blocked shape mismatch {a.shape} x {b.shape}")
    if Kb != Kb2 or c.shape != (Mb, Nb, mb, nb):
        _fail(op, f"blocked shape mismatch {a.shape} x {b.shape} -> {c.shape}")


def _unary(name):
    @_op(name)
    def _v(op):
        if len(op.operands) != 1:
            _fail(op, "expects one operand")
        if op.result.type != op.operands[0].type:
            _fail(op, "result type must match input")
    return _v


for _n in ("tl.relu", "tl.identity", "tl.exp", "tl.negate", "tl.square",
           "tl.sqrt", "tl.rsqrt", "tl.tanh", "tl.gelu", "tl.gelu_tanh"):
    _unary(_n)


@_op("tl.zero")
def _v_zero(op):
    if len(op.operands) != 1:
        _fail(op, "expects (dest)")
    if op.result.type != op.operands[0].type:
        _fail(op, "result type must match dest")


@_op("tl.pad")
def _v_pad(op):
    # zero padding: lo/hi per dim (torch Conv2d padding support; padded
    # convs then lower through the VALID-padding conv path)
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    lo = tuple(op.attrs.get("lo", ()))
    hi = tuple(op.attrs.get("hi", ()))
    src = op.operands[0].type
    if len(lo) != src.rank or len(hi) != src.rank:
        _fail(op, "lo/hi must have one entry per dim")
    want = tuple(d + l + h for d, l, h in zip(src.shape, lo, hi))
    if op.result.type.shape != want:
        _fail(op, f"result shape {op.result.type.shape} != {want}")


@_op("tl.broadcast")
def _v_broadcast(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    try:
        shape = broadcast_shapes(op.operands[0].type.shape,
                                 op.result.type.shape)
    except ValueError as e:
        _fail(op, str(e))
    if shape != op.result.type.shape:
        _fail(op, f"operand does not broadcast to {op.result.type.shape}")


@_op("tl.cast")
def _v_cast(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    if op.result.type.shape != op.operands[0].type.shape:
        _fail(op, "cast cannot change shape")


@_op("tl.transpose")
def _v_transpose(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    perm = op.attrs.get("perm")
    src = op.operands[0].type
    if perm is None or sorted(perm) != list(range(src.rank)):
        _fail(op, f"bad perm {perm} for rank {src.rank}")
    want = tuple(src.shape[p] for p in perm)
    if op.result.type.shape != want:
        _fail(op, f"result shape {op.result.type.shape} != {want}")


@_op("tl.vnni_pack")
def _v_vnni_pack(op):
    # [..., K, N] -> [..., K/vf, N, vf] relayout for bf16
    # (reference xsmm unary VNNI2; applied to brgemm/blocked operands too)
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    vf = op.attrs.get("vnni", 2)
    src = op.operands[0].type
    if src.rank < 2 or src.shape[-2] % vf:
        _fail(op, f"source {src} not VNNI-packable by {vf}")
    want = src.shape[:-2] + (src.shape[-2] // vf, src.shape[-1], vf)
    if op.result.type.shape != want:
        _fail(op, f"result shape {op.result.type.shape} != {want}")


@_op("tl.gather")
def _v_gather(op):
    # embedding lookup: (table (V, E), indices (...)) -> (..., E).
    # Stays tl-level through the pipeline (no xsmm mapping): gathers are
    # XLA's job on TPU — a dynamic-slice DMA pattern, not an MXU op.
    if len(op.operands) != 2:
        _fail(op, "expects (table, indices)")
    table, idx = (_t(x) for x in op.operands)
    if table.rank != 2:
        _fail(op, f"table must be rank-2 (V, E), got {table}")
    if idx.dtype not in ("i32", "i8"):
        _fail(op, f"indices must be integer typed, got {idx.dtype}")
    want = idx.shape + (table.shape[1],)
    if op.result.type.shape != want:
        _fail(op, f"result shape {op.result.type.shape} != {want}")
    if op.result.type.dtype != table.dtype:
        _fail(op, "result dtype must match table dtype")


def _binary(name):
    @_op(name)
    def _v(op):
        if len(op.operands) != 2:
            _fail(op, "expects two operands")
        a, b = (_t(x) for x in op.operands)
        _same_dtype(op, *op.operands)
        try:
            shape = broadcast_shapes(a.shape, b.shape)
        except ValueError as e:
            _fail(op, str(e))
        if op.result.type.shape != shape:
            _fail(op, f"result shape {op.result.type.shape} != broadcast {shape}")
    return _v


for _n in ("tl.add", "tl.sub", "tl.mul", "tl.div", "tl.max"):
    _binary(_n)


@_op("tl.reduce")
def _v_reduce(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    kind = op.attrs.get("kind")
    if kind not in ("sum", "max"):
        _fail(op, f"bad reduce kind {kind}")
    axes = tuple(op.attrs.get("axes", ()))
    src = op.operands[0].type
    keep = op.attrs.get("keepdims", True)
    want = tuple((1 if i in axes else d) if keep else d
                 for i, d in enumerate(src.shape) if keep or i not in axes)
    if op.result.type.shape != want:
        _fail(op, f"result shape {op.result.type.shape} != {want}")


@_op("tl.softmax")
def _v_softmax(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    if op.result.type != op.operands[0].type:
        _fail(op, "result type must match input")


@_op("tl.layer_norm")
def _v_layer_norm(op):
    # Fused LayerNorm over the LAST dim: x [+ gamma, beta] -> y, shape-
    # preserving (the transformer normal form; decomposed reduce/eltwise
    # spellings stay legal but cost ~6 HBM passes instead of one kernel).
    if len(op.operands) not in (1, 3):
        _fail(op, "expects (x) or (x, gamma, beta)")
    x = op.operands[0].type
    if x.rank != 2:
        _fail(op, "expects rank-2 (tokens, features)")
    for g in op.operands[1:]:
        if g.type.shape != (x.shape[-1],):
            _fail(op, f"gamma/beta must be ({x.shape[-1]},), "
                      f"got {g.type.shape}")
    if op.result.type != x:
        _fail(op, "result type must match input")


@_op("xsmm.layer_norm_dispatch")
def _v_layer_norm_dispatch(op):
    if op.operands:
        _fail(op, "dispatch is pure, takes no operands")
    for a in ("m", "n"):
        if a not in op.attrs:
            _fail(op, f"missing attr '{a}'")
    if op.result.type != I64:
        _fail(op, "dispatch returns an i64 kernel handle")


@_op("xsmm.layer_norm")
def _v_xsmm_layer_norm(op):
    if len(op.operands) not in (2, 4):
        _fail(op, "expects (dispatch, x[, gamma, beta])")
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.layer_norm_dispatch":
        _fail(op, "first operand must be a layer_norm_dispatch result")
    x = op.operands[1].type
    if x.shape != (d.attrs["m"], d.attrs["n"]):
        _fail(op, f"dispatch inconsistent with x {x.shape}")
    if bool(d.attrs.get("affine", True)) != (len(op.operands) == 4):
        _fail(op, "affine flag inconsistent with operand count")
    if op.result.type != x:
        _fail(op, "result must match x")


@_op("tl.reshape")
def _v_reshape(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    if op.result.type.num_elements != op.operands[0].type.num_elements:
        _fail(op, "element count must be preserved")


@_op("tl.attention")
def _v_attention(op):
    # Fused attention core: softmax(Q Kt * scale) V over [B, S, D] operands
    # (formed by the attention-fusion pass from the MHA benchmark pattern;
    # reference ships the pieces separately, benchmarks/mlir/fp32-*.mlir).
    # With a `heads` attr the operands stay in TOKEN layout [B, S, H*D]
    # (per-head columns; the kernel splits heads in BlockSpec index space —
    # zero relayout between the QKV projections and the core).
    if len(op.operands) != 3:
        _fail(op, "expects (Q, K, V)")
    q, k, v = (_t(x) for x in op.operands)
    if not (q.rank == k.rank == v.rank == 3):
        _fail(op, "operands must be rank-3 [batch, seq, head_dim]")
    B, S, D = q.shape
    B2, Skv, D2 = k.shape
    if B != B2 or D != D2 or v.shape != (B2, Skv, D):
        _fail(op, f"shape mismatch q{q.shape} k{k.shape} v{v.shape}")
    if op.result.type.shape != (B, S, D):
        _fail(op, f"result {op.result.type.shape} != {(B, S, D)}")
    H = op.attrs.get("heads")
    if H is not None and D % int(H) != 0:
        _fail(op, f"heads={H} must divide the embedding width {D}")


@_op("tl.pack")
def _v_pack(op):
    # pack(src) {inner_dims, inner_tiles, outer_perm?} -> blocked tensor
    # Semantics of tensor.pack: split each inner_dims[i] by inner_tiles[i];
    # tiled outer dims stay in place (optionally permuted), tile dims appended
    # in inner_dims order.
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    src = op.operands[0].type
    dims = tuple(op.attrs.get("inner_dims", ()))
    tiles = tuple(op.attrs.get("inner_tiles", ()))
    if len(dims) != len(tiles) or not dims:
        _fail(op, "inner_dims/inner_tiles mismatch")
    outer = list(src.shape)
    for d, t in zip(dims, tiles):
        if outer[d] % t:
            _fail(op, f"dim {d} ({outer[d]}) not divisible by tile {t}")
        outer[d] //= t
    perm = op.attrs.get("outer_perm")
    if perm is not None:
        outer = [outer[p] for p in perm]
    want = tuple(outer) + tiles
    if op.result.type.shape != want:
        _fail(op, f"result shape {op.result.type.shape} != {want}")


@_op("tl.unpack")
def _v_unpack(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")
    dst = op.result.type
    dims = tuple(op.attrs.get("inner_dims", ()))
    tiles = tuple(op.attrs.get("inner_tiles", ()))
    outer = list(dst.shape)
    for d, t in zip(dims, tiles):
        if outer[d] % t:
            _fail(op, f"dim {d} not divisible by tile {t}")
        outer[d] //= t
    perm = op.attrs.get("outer_perm")
    if perm is not None:
        outer = [outer[p] for p in perm]
    want = tuple(outer) + tiles
    if op.operands[0].type.shape != want:
        _fail(op, f"operand shape {op.operands[0].type.shape} != {want}")


def _pool_verifier(name):
    @_op(name)
    def _v(op):
        if len(op.operands) != 1:
            _fail(op, "expects one operand")
        src = op.operands[0].type
        if src.rank != 4:
            _fail(op, "expects NCHW rank-4 input")
        kh, kw = op.attrs.get("window", (2, 2))
        sh, sw = op.attrs.get("strides", (kh, kw))
        N, C, H, W = src.shape
        P = (H - kh) // sh + 1
        Q = (W - kw) // sw + 1
        if op.result.type.shape != (N, C, P, Q):
            _fail(op, f"result {op.result.type.shape} != {(N, C, P, Q)}")
    return _v


for _n in ("tl.max_pool2d", "tl.avg_pool2d"):
    _pool_verifier(_n)


@_op("tl.conv2d_nchw_fchw")
def _v_conv_nchw(op):
    if len(op.operands) != 3:
        _fail(op, "expects (I, W, O)")
    i, w, o = (_t(x) for x in op.operands)
    sh, sw = op.attrs.get("strides", (1, 1))
    N, C, H, W_ = i.shape
    K, C2, R, S = w.shape
    P = (H - R) // sh + 1
    Q = (W_ - S) // sw + 1
    if C != C2 or o.shape != (N, K, P, Q):
        _fail(op, f"conv shape mismatch {i.shape}*{w.shape}->{o.shape}")


@_op("tl.conv2d_nhwc_hwcf")
def _v_conv_nhwc(op):
    if len(op.operands) != 3:
        _fail(op, "expects (I, W, O)")
    i, w, o = (_t(x) for x in op.operands)
    sh, sw = op.attrs.get("strides", (1, 1))
    N, H, W_, C = i.shape
    R, S, C2, K = w.shape
    P = (H - R) // sh + 1
    Q = (W_ - S) // sw + 1
    if C != C2 or o.shape != (N, P, Q, K):
        _fail(op, f"conv shape mismatch {i.shape}*{w.shape}->{o.shape}")


@_op("tl.blocked_conv2d")
def _v_blocked_conv(op):
    # Channel-blocked conv (reference PackConv2DNchwFchw target layout,
    # docs/ConvMapping.md): O[N,Kb,P,Q,k] += I[N,Cb,H,W,c] * W[Kb,Cb,R,S,c,k]
    if len(op.operands) != 3:
        _fail(op, "expects (I, W, O)")
    i, w, o = (_t(x) for x in op.operands)
    sh, sw = op.attrs.get("strides", (1, 1))
    N, Cb, H, W_, c = i.shape
    Kb, Cb2, R, S, c2, k = w.shape
    P = (H - R) // sh + 1
    Q = (W_ - S) // sw + 1
    if Cb != Cb2 or c != c2 or o.shape != (N, Kb, P, Q, k):
        _fail(op, f"blocked conv shape mismatch {i.shape}*{w.shape}->{o.shape}")


# ---------------------------------------------------------------------------
# xsmm dialect: dispatch/invoke split
# (reference XsmmOps.td; dispatch JITs and returns a kernel handle, invoke
# calls it — on TPU, dispatch is a Pallas kernel-cache key, SURVEY.md 2.5)
# ---------------------------------------------------------------------------

_DISPATCH_ATTRS = {
    "xsmm.gemm_dispatch": ("m", "n", "k"),
    "xsmm.batch_gemm_dispatch": ("batch", "m", "n", "k"),
    "xsmm.brgemm_dispatch": ("m", "n", "k", "batch"),
    "xsmm.fused_brgemm_dispatch": ("m", "n", "k", "batch",
                                   "binary_kind", "unary_kind"),
    "xsmm.unary_dispatch": ("kind", "m", "n"),
    "xsmm.binary_dispatch": ("kind", "m", "n"),
}


def _v_dispatch(op):
    needed = _DISPATCH_ATTRS[op.opname]
    for a in needed:
        if a not in op.attrs:
            _fail(op, f"missing attr '{a}'")
    if op.operands:
        _fail(op, "dispatch is pure, takes no operands")
    if op.result.type != I64:
        _fail(op, "dispatch returns an i64 kernel handle")
    flags = op.attrs.get("flags", ())
    ok = GEMM_FLAGS if "gemm" in op.opname else BCAST_FLAGS
    for f in flags:
        if f not in ok:
            _fail(op, f"bad flag {f}")
    if op.opname == "xsmm.unary_dispatch" and op.attrs["kind"] not in UNARY_KINDS:
        _fail(op, f"bad unary kind {op.attrs['kind']}")
    if op.opname == "xsmm.binary_dispatch" and op.attrs["kind"] not in BINARY_KINDS:
        _fail(op, f"bad binary kind {op.attrs['kind']}")


for _n in _DISPATCH_ATTRS:
    _VERIFIERS[_n] = _v_dispatch


def _dispatch_of(op: Operation) -> Operation | None:
    d = op.operands[0].owner
    return d if d is not None and d.opname.endswith("_dispatch") else None


@_op("xsmm.gemm")
def _v_xsmm_gemm(op):
    if len(op.operands) != 4:
        _fail(op, "expects (dispatch, A, B, C)")
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.gemm_dispatch":
        _fail(op, "first operand must be a gemm_dispatch result")
    a, b, c = (_t(x) for x in op.operands[1:])
    m, n, k = d.attrs["m"], d.attrs["n"], d.attrs["k"]
    tb = "transpose_b" in d.attrs.get("flags", ())
    bshape = (n, k) if tb else (k, n)
    if a.shape != (m, k) or b.shape != bshape or c.shape != (m, n):
        _fail(op, f"dispatch({m},{n},{k}) inconsistent with operands "
                  f"{a.shape},{b.shape},{c.shape}")
    if op.result.type != c:
        _fail(op, "result must match C")


def _brgemm_shapes(d):
    """Expected (A, B, C) shapes for a brgemm-family dispatch.

    layout "flat" (default): A[B,m,k] B[B,k,n] C[m,n] — k is the reduction.
    layout "blocked": the packed normal form of PackMatmul
    (reference ToBlockLayoutAndBack.cpp:484): A[Mb,Kb,mb,kb], B[Nb,Kb,kb,nb],
    C[Mb,Nb,mb,nb], with batch == Kb. The same dispatch surface covers both,
    the way libxsmm brgemm takes stride hints (XsmmRunnerUtils.cpp:288-361).
    """
    m, n, k, B = (d.attrs[x] for x in ("m", "n", "k", "batch"))
    vnni = d.attrs.get("vnni", 0)
    if d.attrs.get("layout", "flat") == "conv":
        # Conv-as-BRGEMM (docs/ConvMapping.md): A = blocked input
        # [N,Cb,H,W,c], B = blocked filter [Kb,Cb,R,S,c,k], C = blocked
        # output [N,Kb,P,Q,k]; reduction batch = Cb*R*S.
        N, H, W = d.attrs["N"], d.attrs["H"], d.attrs["W"]
        Cb, Kb = d.attrs["Cb"], d.attrs["Kb"]
        R, S = d.attrs["R"], d.attrs["S"]
        sh, sw = d.attrs.get("strides", (1, 1))
        P = (H - R) // sh + 1
        Q = (W - S) // sw + 1
        c, kblk = d.attrs["c"], d.attrs["kblk"]
        return ((N, Cb, H, W, c), (Kb, Cb, R, S, c, kblk),
                (N, Kb, P, Q, kblk))
    if d.attrs.get("layout", "flat") == "conv_nhwc":
        # NHWC-native conv-as-BRGEMM: A = input [N,H,W,C], B = filter
        # [R,S,C,K], C = output [N,P,Q,K]; channel blocking is BlockSpec
        # index math only (no packed layout exists in the IR).
        N, H, W = d.attrs["N"], d.attrs["H"], d.attrs["W"]
        C, K = d.attrs["C"], d.attrs["K"]
        R, S = d.attrs["R"], d.attrs["S"]
        sh, sw = d.attrs.get("strides", (1, 1))
        pl_, ph, pwl, pwh = d.attrs.get("padding", (0, 0, 0, 0))
        P = (H + pl_ + ph - R) // sh + 1
        Q = (W + pwl + pwh - S) // sw + 1
        return ((N, H, W, C), (R, S, C, K), (N, P, Q, K))
    if d.attrs.get("layout", "flat") == "blocked":
        Mb, Nb = d.attrs["Mb"], d.attrs["Nb"]
        a = (Mb, B, m, k)
        b = (Nb, B, k // vnni, n, vnni) if vnni else (Nb, B, k, n)
        c = (Mb, Nb, m, n)
    else:
        a = (B, m, k)
        b = (B, k // vnni, n, vnni) if vnni else (B, k, n)
        c = (m, n)
    return a, b, c


@_op("xsmm.brgemm")
def _v_xsmm_brgemm(op):
    if len(op.operands) != 4:
        _fail(op, "expects (dispatch, A, B, C)")
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.brgemm_dispatch":
        _fail(op, "first operand must be a brgemm_dispatch result")
    a, b, c = (_t(x) for x in op.operands[1:])
    ea, eb, ec = _brgemm_shapes(d)
    if a.shape != ea or b.shape != eb or c.shape != ec:
        _fail(op, f"dispatch expects A{ea} B{eb} C{ec}, got "
                  f"{a.shape},{b.shape},{c.shape}")


@_op("xsmm.fused_brgemm")
def _v_xsmm_fused_brgemm(op):
    # (dispatch, A, B, C, D[, gamma, beta]) where D is the binary rhs
    # (e.g. bias) and gamma/beta trail when the dispatch carries an affine
    # layer_norm prologue
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.fused_brgemm_dispatch":
        _fail(op, "first operand must be a fused_brgemm_dispatch result")
    want = 5
    if d.attrs.get("prologue") == "layer_norm" \
            and d.attrs.get("prologue_affine", True):
        want = 7
    if len(op.operands) != want:
        _fail(op, f"expects {want} operands (dispatch, A, B, C, D"
                  f"{', gamma, beta' if want == 7 else ''})")
    if want == 7:
        g, be = (_t(x) for x in op.operands[5:7])
        if g.num_elements != d.attrs["k"] or be.num_elements != d.attrs["k"]:
            _fail(op, "layer_norm gamma/beta must have k elements")
    a, b, c, bias = (_t(x) for x in op.operands[1:5])
    ea, eb, ec = _brgemm_shapes(d)
    if a.shape != ea or b.shape != eb:
        _fail(op, f"dispatch expects A{ea} B{eb}, got {a.shape},{b.shape}")
    if "beta_0" not in d.attrs.get("flags", ()):
        # C is read only without beta_0; its shape is unconstrained else
        if c.shape != ec:
            _fail(op, f"dispatch expects C{ec}, got {c.shape}")
    if d.attrs["binary_kind"] not in BINARY_KINDS:
        _fail(op, "bad binary_kind")
    if d.attrs["unary_kind"] not in UNARY_KINDS:
        _fail(op, "bad unary_kind")


@_op("xsmm.batch_gemm")
def _v_xsmm_batch_gemm(op):
    # Parallel-batch matmul invoke. The reference has no batched libxsmm
    # GEMM and loops matmuls instead (RewriteBatchMatmulToMatmul.cpp); on
    # TPU the batch is a parallel grid dimension of the same kernel.
    if len(op.operands) != 4:
        _fail(op, "expects (dispatch, A, B, C)")
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.batch_gemm_dispatch":
        _fail(op, "first operand must be a batch_gemm_dispatch result")
    a, b, c = (_t(x) for x in op.operands[1:])
    m, n, k, B = (d.attrs[x] for x in ("m", "n", "k", "batch"))
    ea = (m, k) if d.attrs.get("lhs_shared") else (B, m, k)
    if a.shape != ea or b.shape != (B, k, n) or c.shape != (B, m, n):
        _fail(op, f"dispatch({B},{m},{n},{k}) inconsistent with operands "
                  f"{a.shape},{b.shape},{c.shape}")


@_op("xsmm.attention_dispatch")
def _v_attention_dispatch(op):
    if op.operands:
        _fail(op, "dispatch is pure, takes no operands")
    for a in ("batch", "seq", "seq_kv", "head_dim"):
        if a not in op.attrs:
            _fail(op, f"missing attr '{a}'")
    if op.result.type != I64:
        _fail(op, "dispatch returns an i64 kernel handle")


@_op("xsmm.attention")
def _v_xsmm_attention(op):
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.attention_dispatch":
        _fail(op, "first operand must be an attention_dispatch result")
    B, S, D = d.attrs["batch"], d.attrs["seq"], d.attrs["head_dim"]
    H = int(d.attrs.get("heads", 0) or 0)
    width = D * H if H else D       # token layout carries heads*head_dim
    Skv = d.attrs["seq_kv"]
    if d.attrs.get("qkv_packed"):
        # merged-projection form: ONE [Q|K|V] column-group operand
        if len(op.operands) != 2:
            _fail(op, "qkv_packed expects (dispatch, QKV)")
        if not H:
            _fail(op, "qkv_packed requires token layout (heads attr)")
        if S != Skv:
            _fail(op, "qkv_packed requires seq == seq_kv (self-attention)")
        q = op.operands[1].type
        if q.shape != (B, S, 3 * width):
            _fail(op, f"dispatch inconsistent with packed QKV {q.shape}")
        return
    if len(op.operands) != 4:
        _fail(op, "expects (dispatch, Q, K, V)")
    q = op.operands[1].type
    if q.shape != (B, S, width):
        _fail(op, f"dispatch inconsistent with Q {q.shape}")
    k, v = op.operands[2].type, op.operands[3].type
    if k.shape != (B, Skv, width) or v.shape != (B, Skv, width):
        _fail(op, f"dispatch seq_kv={Skv} inconsistent with K {k.shape} / "
                  f"V {v.shape}")


@_op("xsmm.fused_chain_dispatch")
def _v_chain_dispatch(op):
    # Whole-chain fusion: one kernel for x -> L layers of act(x@W+b).
    # No reference analogue — the reference fuses within a layer
    # (CombineXsmmPass); on TPU, VMEM (16MB+) holds several layers of
    # weights, so the chain fuses across contractions and intermediate
    # activations never touch HBM.
    if op.operands:
        _fail(op, "dispatch is pure, takes no operands")
    for a in ("m", "dims"):
        if a not in op.attrs:
            _fail(op, f"missing attr '{a}'")
    if len(op.attrs["dims"]) < 2:
        _fail(op, "dims must be (k0, n1, ..., nL)")
    if op.result.type != I64:
        _fail(op, "dispatch returns an i64 kernel handle")


@_op("xsmm.fused_chain")
def _v_chain(op):
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.fused_chain_dispatch":
        _fail(op, "first operand must be a fused_chain_dispatch result")
    m = d.attrs["m"]
    dims = tuple(d.attrs["dims"])
    has_bias = bool(d.attrs.get("has_bias", True))
    L = len(dims) - 1
    want_n = 1 + 1 + L * (2 if has_bias else 1)
    if len(op.operands) != want_n:
        _fail(op, f"expects {want_n} operands for {L} layers")
    x = op.operands[1].type
    if x.shape != (m, dims[0]):
        _fail(op, f"x shape {x.shape} != ({m}, {dims[0]})")
    idx = 2
    for i in range(L):
        w = op.operands[idx].type
        if w.shape != (dims[i], dims[i + 1]):
            _fail(op, f"layer {i} weight {w.shape} != "
                      f"({dims[i]}, {dims[i + 1]})")
        idx += 1
        if has_bias:
            b = op.operands[idx].type
            if b.num_elements != dims[i + 1]:
                _fail(op, f"layer {i} bias {b.shape} != ({dims[i + 1]},)")
            idx += 1
    if op.result.type.shape != (m, dims[-1]):
        _fail(op, f"result {op.result.type.shape} != ({m}, {dims[-1]})")


@_op("xsmm.unary")
def _v_xsmm_unary(op):
    if len(op.operands) != 2:
        _fail(op, "expects (dispatch, input)")
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.unary_dispatch":
        _fail(op, "first operand must be a unary_dispatch result")


@_op("xsmm.binary")
def _v_xsmm_binary(op):
    if len(op.operands) != 3:
        _fail(op, "expects (dispatch, a, b)")
    d = _dispatch_of(op)
    if d is None or d.opname != "xsmm.binary_dispatch":
        _fail(op, "first operand must be a binary_dispatch result")


# ---------------------------------------------------------------------------
# perf / check dialects (reference PerfOps.td, CheckOps.td)
# ---------------------------------------------------------------------------

@_op("perf.timer_start")
def _v_timer_start(op):
    if op.operands or op.result.type != I64:
        _fail(op, "-> i64 timestamp")


@_op("perf.timer_stop")
def _v_timer_stop(op):
    if len(op.operands) != 1 or op.operands[0].type != I64:
        _fail(op, "expects (i64 start) -> f32 seconds")


@_op("perf.sink")
def _v_sink(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")


@_op("perf.bench")
def _v_perf_bench(op):
    """Timed-loop region op (reference PerfOps.td:99-188 perf.bench): run
    `callee` `n` times with the operands as iter_args — each iteration's
    results feed the next call — and yield (mean seconds/iter, final
    iter_args). The reference expresses the body as an inlined region; in
    this functional SSA IR the region is a function reference, which
    round-trips textually and keeps the op verifiable against the callee's
    signature (the same information, no nested-region parser)."""
    callee = op.attrs.get("callee")
    if not isinstance(callee, str):
        _fail(op, "needs a 'callee' string attr")
    n = op.attrs.get("n")
    if not isinstance(n, int) or n < 1:
        _fail(op, "needs an int attr n >= 1")
    if len(op.results) < 1 or len(op.results) > 1 + len(op.operands):
        _fail(op, "results must be (mean_seconds, *final_iter_args)")
    if op.results[0].type != F64:
        _fail(op, "first result is the scalar mean time")
    # chaining convention: the callee's results feed back into its LEADING
    # args each iteration (the perf.bench iter_args); trailing operands are
    # loop-invariant (the reference's region closure values)
    for v, r in zip(op.operands, op.results[1:]):
        if v.type != r.type:
            _fail(op, f"iter_arg {v.type} != result {r.type}")
    mod = op.parent.module if op.parent is not None else None
    if mod is not None and callee in mod.funcs:
        f = mod.funcs[callee]
        if [a.type for a in f.args] != [v.type for v in op.operands]:
            _fail(op, f"callee @{callee} args do not match operands")
        rets = [v.type for v in f.returns]
        if rets != [a.type for a in f.args][:len(rets)]:
            _fail(op, f"callee @{callee} results must match its leading "
                      "args so iterations chain")
        if len(op.results) - 1 != len(rets):
            _fail(op, "value results must mirror the callee's results")


@_op("check.expect_true")
def _v_expect_true(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")


@_op("check.expect_almost_eq")
def _v_expect_almost_eq(op):
    if len(op.operands) != 2:
        _fail(op, "expects (lhs, rhs)")
    if op.operands[0].type.shape != op.operands[1].type.shape:
        _fail(op, "shape mismatch")


@_op("check.expect_sane")
def _v_expect_sane(op):
    if len(op.operands) != 1:
        _fail(op, "expects one operand")


ALL_OPS = tuple(sorted(_VERIFIERS))


# ---------------------------------------------------------------------------
# High-level builder with type inference
# ---------------------------------------------------------------------------

class TppBuilder(Builder):
    """Builder with result-type inference for every op."""

    def constant(self, type: TensorType, init: str = "zero", seed: int = 0,
                 value=None) -> Value:
        attrs: dict[str, Any] = {"init": init, "seed": seed}
        if value is not None:
            attrs["value"] = value
        return self.create("tl.constant", [], [type], attrs).result

    def fill(self, dest: Value, value: float) -> Value:
        return self.create("tl.fill", [dest], [dest.type], {"value": value}).result

    def zero(self, dest: Value) -> Value:
        return self.create("tl.zero", [dest], [dest.type]).result

    def matmul(self, a: Value, b: Value, c: Value, **attrs) -> Value:
        return self.create("tl.matmul", [a, b, c], [c.type], attrs).result

    def batch_matmul(self, a: Value, b: Value, c: Value, **attrs) -> Value:
        return self.create("tl.batch_matmul", [a, b, c], [c.type],
                           attrs).result

    def generic(self, inputs, init: Value, indexing_maps, iterator_types,
                body) -> Value:
        return self.create(
            "tl.generic", list(inputs) + [init], [init.type],
            {"indexing_maps": tuple(tuple(m) for m in indexing_maps),
             "iterator_types": tuple(iterator_types),
             "body": body}).result

    def brgemm(self, a: Value, b: Value, c: Value) -> Value:
        return self.create("tl.brgemm", [a, b, c], [c.type]).result

    def vnni_brgemm(self, a: Value, b: Value, c: Value, vnni: int = 2) -> Value:
        return self.create("tl.vnni_brgemm", [a, b, c], [c.type],
                           {"vnni": vnni}).result

    def blocked_matmul(self, a: Value, b: Value, c: Value) -> Value:
        return self.create("tl.blocked_matmul", [a, b, c], [c.type]).result

    def unary(self, opname: str, x: Value) -> Value:
        return self.create(opname, [x], [x.type]).result

    def relu(self, x: Value) -> Value:
        return self.unary("tl.relu", x)

    def exp(self, x: Value) -> Value:
        return self.unary("tl.exp", x)

    def identity(self, x: Value) -> Value:
        return self.unary("tl.identity", x)

    def pad(self, x: Value, lo, hi) -> Value:
        lo, hi = tuple(lo), tuple(hi)
        shape = tuple(d + l + h for d, l, h in zip(x.type.shape, lo, hi))
        return self.create("tl.pad", [x], [x.type.with_shape(shape)],
                           {"lo": lo, "hi": hi}).result

    def broadcast(self, x: Value, shape) -> Value:
        return self.create("tl.broadcast", [x],
                           [x.type.with_shape(shape)]).result

    def cast(self, x: Value, dtype: str) -> Value:
        return self.create("tl.cast", [x], [TensorType(x.type.shape, dtype)]).result

    def transpose(self, x: Value, perm) -> Value:
        shape = tuple(x.type.shape[p] for p in perm)
        return self.create("tl.transpose", [x],
                           [x.type.with_shape(shape)], {"perm": tuple(perm)}).result

    def vnni_pack(self, x: Value, vnni: int = 2) -> Value:
        k, n = x.type.shape
        t = x.type.with_shape((k // vnni, n, vnni))
        return self.create("tl.vnni_pack", [x], [t], {"vnni": vnni}).result

    def binary(self, opname: str, a: Value, b: Value) -> Value:
        shape = broadcast_shapes(a.type.shape, b.type.shape)
        return self.create(opname, [a, b], [a.type.with_shape(shape)]).result

    def add(self, a, b):
        return self.binary("tl.add", a, b)

    def sub(self, a, b):
        return self.binary("tl.sub", a, b)

    def mul(self, a, b):
        return self.binary("tl.mul", a, b)

    def div(self, a, b):
        return self.binary("tl.div", a, b)

    def maximum(self, a, b):
        return self.binary("tl.max", a, b)

    def reduce(self, x: Value, kind: str, axes, keepdims: bool = True) -> Value:
        axes = tuple(axes)
        shape = tuple((1 if i in axes else d)
                      for i, d in enumerate(x.type.shape)) if keepdims else \
            tuple(d for i, d in enumerate(x.type.shape) if i not in axes)
        return self.create("tl.reduce", [x], [x.type.with_shape(shape)],
                           {"kind": kind, "axes": axes, "keepdims": keepdims}).result

    def softmax(self, x: Value, axis: int = -1) -> Value:
        return self.create("tl.softmax", [x], [x.type], {"axis": axis}).result

    def layer_norm(self, x: Value, gamma: Value | None = None,
                   beta: Value | None = None, eps: float = 1e-5) -> Value:
        ops = [x] + ([gamma, beta] if gamma is not None else [])
        return self.create("tl.layer_norm", ops, [x.type],
                           {"eps": eps}).result

    def reshape(self, x: Value, shape) -> Value:
        return self.create("tl.reshape", [x], [x.type.with_shape(shape)]).result

    def gather(self, table: Value, indices: Value) -> Value:
        t = TensorType(indices.type.shape + (table.type.shape[1],),
                       table.type.dtype)
        return self.create("tl.gather", [table, indices], [t]).result

    def pack(self, x: Value, inner_dims, inner_tiles, outer_perm=None) -> Value:
        inner_dims = tuple(inner_dims)
        inner_tiles = tuple(inner_tiles)
        outer = list(x.type.shape)
        for d, t in zip(inner_dims, inner_tiles):
            outer[d] //= t
        if outer_perm is not None:
            outer_perm = tuple(outer_perm)
            outer = [outer[p] for p in outer_perm]
        t = x.type.with_shape(tuple(outer) + inner_tiles)
        attrs = {"inner_dims": inner_dims, "inner_tiles": inner_tiles}
        if outer_perm is not None:
            attrs["outer_perm"] = outer_perm
        return self.create("tl.pack", [x], [t], attrs).result

    def unpack(self, x: Value, inner_dims, inner_tiles, out_shape,
               outer_perm=None) -> Value:
        attrs = {"inner_dims": tuple(inner_dims), "inner_tiles": tuple(inner_tiles)}
        if outer_perm is not None:
            attrs["outer_perm"] = tuple(outer_perm)
        return self.create("tl.unpack", [x], [x.type.with_shape(out_shape)],
                           attrs).result

    def pool2d(self, opname: str, x: Value, window=(2, 2),
               strides=None) -> Value:
        kh, kw = window
        sh, sw = strides or window
        N, C, H, W = x.type.shape
        P, Q = (H - kh) // sh + 1, (W - kw) // sw + 1
        return self.create(opname, [x], [x.type.with_shape((N, C, P, Q))],
                           {"window": (kh, kw), "strides": (sh, sw)}).result

    def conv2d_nchw_fchw(self, i: Value, w: Value, o: Value,
                         strides=(1, 1)) -> Value:
        return self.create("tl.conv2d_nchw_fchw", [i, w, o], [o.type],
                           {"strides": tuple(strides)}).result

    def conv2d_nhwc_hwcf(self, i: Value, w: Value, o: Value,
                         strides=(1, 1)) -> Value:
        return self.create("tl.conv2d_nhwc_hwcf", [i, w, o], [o.type],
                           {"strides": tuple(strides)}).result

    def blocked_conv2d(self, i: Value, w: Value, o: Value,
                       strides=(1, 1)) -> Value:
        return self.create("tl.blocked_conv2d", [i, w, o], [o.type],
                           {"strides": tuple(strides)}).result

    def perf_bench(self, callee: str, operands, n: int,
                   num_chained: int = 1):
        """perf.bench: time `n` chained applications of @callee — results
        feed the leading `num_chained` args each iteration; returns
        (mean_seconds, *final_results) (reference PerfOps.td:99-188)."""
        operands = list(operands)
        op = self.create("perf.bench", operands,
                         [F64] + [v.type for v in operands[:num_chained]],
                         {"callee": callee, "n": int(n)})
        return op.results
