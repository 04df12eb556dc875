"""Affine-map-lite analysis for `tl.generic`.

The reference's primary ingress is `linalg.generic`: affine indexing maps +
iterator types + a scalar body region. Its conversion core classifies
generics into unary/binary/contraction and infers broadcast flags from the
maps (reference lib/TPP/Conversion/ConvertLinalgToXsmm.cpp:181-640,
`checkStructure`/`checkAccess` at 497-640). This module is the TPU-native
counterpart:

  * an indexing map is a tuple of loop-dim indices — a *projected
    permutation* (the only map class the reference's matchers accept:
    StructuredOpMatcher.h `BroadcastableProjectedPermutation`);
  * iterator types are "parallel" | "reduction";
  * the body is a pure expression tree over ("arg", i) leaves, e.g.
    ("add", ("mul", ("arg", 0), ("arg", 1)), ("arg", 2)) — the functional
    rendering of the reference's single-block region with a yield.

`classify_generic` maps a generic onto the named-op normal form (the same
taxonomy the reference's ConvertLinalgToXsmm patterns use), and
`eval_generic` gives reference semantics for the executor's
--linalg-to-loops path, on torch tensors.

A copy of `tpp_mlir_tpu/ir/affine.py` whose evaluator computes with torch
where the original's computes with jnp.
"""

from __future__ import annotations

from typing import Any

# body node -> arity
BODY_OPS = {
    "add": 2, "sub": 2, "mul": 2, "div": 2, "max": 2, "min": 2,
    "maximumf": 2, "exp": 1, "negate": 1, "sqrt": 1, "rsqrt": 1,
    "square": 1, "tanh": 1, "gelu": 1, "relu": 1, "identity": 1,
}

# body unary-pattern -> named tl op kind (reference MatcherUtils
# isReluOp/isZeroOp etc., include/TPP/IR/MatcherUtils.h:22-42)
_UNARY_KIND_BY_HEAD = {
    "exp": "exp", "negate": "negate", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "square": "square", "tanh": "tanh", "gelu": "gelu", "relu": "relu",
}

_BINARY_KINDS = ("add", "sub", "mul", "div", "max")


def is_arg(e, i=None):
    return (isinstance(e, (tuple, list)) and len(e) == 2 and e[0] == "arg"
            and (i is None or e[1] == i))


def body_args(expr) -> set[int]:
    if is_arg(expr):
        return {expr[1]}
    if isinstance(expr, (tuple, list)):
        out: set[int] = set()
        for e in expr[1:]:
            out |= body_args(e)
        return out
    return set()


def eval_body(expr, args):
    """Evaluate a body expression over f32 torch tensors (reference
    `ir/affine.py:84`). A number leaf is a scalar; "gelu" is the tanh
    approximation, jax.nn.gelu's default, as the reference evaluates it."""
    import torch
    import torch.nn.functional as F

    if is_arg(expr):
        return args[expr[1]]
    if isinstance(expr, (int, float)):
        return torch.tensor(float(expr), dtype=torch.float32,
                            device=args[0].device)
    vals = [eval_body(e, args) for e in expr[1:]]
    fns = {
        "add": torch.add, "sub": torch.sub, "mul": torch.mul,
        "div": torch.div, "max": torch.maximum, "min": torch.minimum,
        "maximumf": torch.maximum, "exp": torch.exp,
        "negate": torch.neg, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
        "square": lambda x: x * x, "tanh": torch.tanh,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": torch.relu, "identity": lambda x: x,
    }
    return fns[expr[0]](*vals)


def verify_body(expr, n_args: int):
    if is_arg(expr):
        if not (0 <= expr[1] < n_args):
            raise ValueError(f"body references arg {expr[1]} "
                             f"of {n_args} operands")
        return
    if isinstance(expr, (int, float)):
        return
    if not isinstance(expr, (tuple, list)) or not expr:
        raise ValueError(f"malformed body node {expr!r}")
    head = expr[0]
    if head not in BODY_OPS:
        raise ValueError(f"unknown body op {head!r}")
    if len(expr) - 1 != BODY_OPS[head]:
        raise ValueError(f"body op {head} expects {BODY_OPS[head]} operands")
    for e in expr[1:]:
        verify_body(e, n_args)


def is_projected_permutation(mp) -> bool:
    return len(set(mp)) == len(mp)


def _match_contraction_body(body, n_in: int):
    """body == add(mul(arg_i, arg_j), arg_acc) in any association order ->
    (i, j) or None. The accumulator must be the init operand (index n_in)."""
    if not (isinstance(body, (tuple, list)) and body[0] == "add"):
        return None
    lhs, rhs = body[1], body[2]
    for mul, acc in ((lhs, rhs), (rhs, lhs)):
        if (isinstance(mul, (tuple, list)) and mul[0] == "mul"
                and is_arg(acc, n_in)
                and is_arg(mul[1]) and is_arg(mul[2])):
            return (mul[1][1], mul[2][1])
    return None


def classify_generic(op) -> tuple | None:
    """Classify a tl.generic into the named-op taxonomy.

    Returns one of (mirroring the reference's pattern set,
    ConvertLinalgToXsmm.cpp:181-640):
      ("contraction", kind, swap)    kind in matmul/batch_matmul/brgemm,
                                     swap=True when args arrive (B, A)
      ("binary", kind)               eltwise binary over 2 inputs
      ("unary", kind)                eltwise unary over 1 input
      None                           unrecognized (stays generic)
    """
    maps = [tuple(m) for m in op.attrs["indexing_maps"]]
    iters = tuple(op.attrs["iterator_types"])
    body = op.attrs["body"]
    n_in = len(op.operands) - 1
    red = {d for d, it in enumerate(iters) if it == "reduction"}
    out_map = maps[-1]

    if not red:
        # eltwise: all maps must be broadcastable projections of the output
        if any(not set(m) <= set(out_map) for m in maps[:-1]):
            return None
        if n_in == 1:
            if is_arg(body, 0):
                return ("unary", "identity")
            head = body[0] if isinstance(body, (tuple, list)) else None
            if head in ("maximumf", "max") and is_arg(body[1], 0) \
                    and body[2] in (0, 0.0):
                return ("unary", "relu")  # cmp+select/maximumf normal form
            if head in _UNARY_KIND_BY_HEAD and is_arg(body[1], 0):
                return ("unary", _UNARY_KIND_BY_HEAD[head])
            return None
        if n_in == 2:
            head = body[0] if isinstance(body, (tuple, list)) else None
            if head in _BINARY_KINDS and is_arg(body[1]) and is_arg(body[2]):
                if body[1][1] == 0 and body[2][1] == 1:
                    return ("binary", head)
            return None
        return None

    # contraction (reference checkStructure: 1 m, 1 n, 1-3 k dims)
    if n_in != 2 or len(red) > 3:
        return None
    pair = _match_contraction_body(body, n_in)
    if pair is None:
        return None
    swap = pair == (1, 0)
    if pair not in ((0, 1), (1, 0)):
        return None
    ma, mb = (maps[1], maps[0]) if swap else (maps[0], maps[1])
    if not (is_projected_permutation(ma) and is_projected_permutation(mb)
            and is_projected_permutation(out_map)):
        return None
    if len(out_map) == 2:
        m_d, n_d = out_map
        if len(ma) == 2 and len(mb) == 2 and len(red) == 1:
            k_d = next(iter(red))
            if ma == (m_d, k_d) and mb in ((k_d, n_d), (n_d, k_d)):
                return ("contraction",
                        "matmul_tb" if mb == (n_d, k_d) else "matmul",
                        swap)
        if len(ma) == 3 and len(mb) == 3 and len(red) == 2:
            # batch-reduce GEMM: A (r,m,k), B (r,k,n), both r,k reduction
            r_d, k_d = ma[0], ma[2]
            if {r_d, k_d} == red and ma == (r_d, m_d, k_d) \
                    and mb == (r_d, k_d, n_d):
                return ("contraction", "brgemm", swap)
    elif len(out_map) == 3:
        b_d, m_d, n_d = out_map
        k_d = next(iter(red)) if len(red) == 1 else None
        if k_d is not None and ma == (b_d, m_d, k_d) \
                and mb == (b_d, k_d, n_d):
            return ("contraction", "batch_matmul", swap)
    return None


def infer_bcast_from_map(out_map, operand_map) -> str:
    """Broadcast flag of an eltwise operand from its indexing map — the
    unambiguous form of shape-based inference (reference getBinaryFlags,
    XsmmUtils.h:33-127, works off maps for exactly this reason: a square
    (N,) operand is ambiguous by shape, never by map)."""
    om, mp = tuple(out_map), tuple(operand_map)
    if mp == om:
        return "none"
    if len(mp) == 0:
        return "bcast_scalar"
    if mp == om[-1:]:
        return "bcast_col"   # operand indexed by the minor dim: a row vector
    if len(om) >= 2 and mp == (om[-2],):
        return "bcast_row"   # operand indexed by the major dim: a column
    if mp == om[len(om) - len(mp):]:
        return "bcast_col"   # trailing projection
    return "none"


def eval_generic(op, vals):
    """Reference semantics of a tl.generic on torch tensors (reference
    `ir/affine.py:216`, the role of -linalg-to-loops). A contraction
    computes in f32 with TF32 off, through the same product as the
    executor's tl.matmul/tl.brgemm/tl.batch_matmul oracles, so a generic
    and its named form give the same bits; an elementwise generic
    broadcasts every operand into the output's dims by its map, evaluates
    the body in f32 and rounds once. A reduction outside the contraction
    normal form raises NotImplementedError, as the reference's does."""
    from ..runtime.tensor_init import TORCH_DTYPES
    from ..xsmm.reference import contraction

    maps = [tuple(m) for m in op.attrs["indexing_maps"]]
    iters = tuple(op.attrs["iterator_types"])
    out_dt = TORCH_DTYPES[op.results[0].type.dtype]
    cls = classify_generic(op)
    if cls and cls[0] == "contraction":
        _, kind, swap = cls
        a, b = (vals[1], vals[0]) if swap else (vals[0], vals[1])
        return (contraction(kind, a, b) + vals[-1].float()).to(out_dt)
    if "reduction" in iters:
        raise NotImplementedError(
            "tl.generic with reduction dims must match the contraction "
            "normal form (add(mul(a,b), acc))")
    sizes: dict[int, int] = {}
    for v, mp in zip(vals, maps):
        for d, s in zip(mp, v.shape):
            sizes[d] = s
    out_map = maps[-1]
    out_shape = tuple(sizes[d] for d in out_map)
    exp = []
    for v, mp in zip(vals, maps):
        present = [d for d in out_map if d in mp]
        x = v.permute([mp.index(d) for d in present])
        x = x.reshape([sizes[d] if d in mp else 1 for d in out_map])
        exp.append(x.broadcast_to(out_shape).float())
    return eval_body(op.attrs["body"], exp).to(out_dt)
