"""Declarative op-matching DSL.

The TPU-native analogue of the reference's StructuredOpMatcher
(reference include/TPP/IR/StructuredOpMatcher.h:23-461): chained predicates
over operations used by the lowering passes, e.g.

    m = (Matcher("tl.matmul")
         .operand(0, has_rank(2))
         .output(has_static_shape())
         .dtype_in("f32", "bf16"))
    if m(op): ...

plus MatcherUtils-style helpers (is_zero_op, is_relu_op, ...)
(reference include/TPP/IR/MatcherUtils.h:22-42).
"""

from __future__ import annotations

from typing import Callable

from .core import Operation, Value

Pred = Callable[[Operation], bool]


class Matcher:
    def __init__(self, *opnames: str):
        self.opnames = opnames
        self.preds: list[Pred] = []

    def _add(self, p: Pred) -> "Matcher":
        self.preds.append(p)
        return self

    def __call__(self, op: Operation | None) -> bool:
        if op is None:
            return False
        if self.opnames and op.opname not in self.opnames:
            return False
        return all(p(op) for p in self.preds)

    # -- chainable predicates ---------------------------------------------
    def operand(self, i: int, pred: Callable[[Value], bool]) -> "Matcher":
        return self._add(lambda op: i < len(op.operands) and pred(op.operands[i]))

    def all_operands(self, pred: Callable[[Value], bool]) -> "Matcher":
        return self._add(lambda op: all(pred(v) for v in op.operands))

    def output(self, pred: Callable[[Value], bool]) -> "Matcher":
        return self._add(lambda op: all(pred(r) for r in op.results))

    def num_operands(self, n: int) -> "Matcher":
        return self._add(lambda op: len(op.operands) == n)

    def attr(self, key: str, value=...) -> "Matcher":
        if value is ...:
            return self._add(lambda op: key in op.attrs)
        return self._add(lambda op: op.attrs.get(key) == value)

    def dtype_in(self, *dtypes: str) -> "Matcher":
        return self._add(
            lambda op: all(r.type.dtype in dtypes for r in op.results))

    def where(self, pred: Pred) -> "Matcher":
        return self._add(pred)

    def producer(self, i: int, sub: "Matcher") -> "Matcher":
        """Operand i is produced by an op matching `sub`."""
        return self._add(
            lambda op: i < len(op.operands) and sub(op.operands[i].owner))

    # -- tl.generic structure predicates (the reference's region matchers,
    # StructuredOpMatcher.h WithSingleOp / NumOfLoops / HasMap) -------------
    def num_loops(self, n: int) -> "Matcher":
        return self._add(
            lambda op: len(op.attrs.get("iterator_types", ())) == n)

    def dim(self, i: int, kind: str) -> "Matcher":
        return self._add(
            lambda op: i < len(op.attrs.get("iterator_types", ()))
            and op.attrs["iterator_types"][i] == kind)

    def indexing_map(self, i: int, pred: Callable) -> "Matcher":
        return self._add(
            lambda op: i < len(op.attrs.get("indexing_maps", ()))
            and pred(tuple(op.attrs["indexing_maps"][i])))

    def body_head(self, name: str) -> "Matcher":
        """The body expression's outermost op is `name` — the analogue of
        the reference's WithSingleOp<KindAdd> region matcher."""
        def p(op):
            body = op.attrs.get("body")
            return isinstance(body, (tuple, list)) and body \
                and body[0] == name
        return self._add(p)

    def body(self, pred: Callable) -> "Matcher":
        return self._add(lambda op: "body" in op.attrs
                         and pred(op.attrs["body"]))

    def single_use(self, i: int) -> "Matcher":
        """Operand i's value has exactly one use AND is not returned
        (func.returns escape .uses — the 39cdbae bug class)."""
        def pred(op):
            if i >= len(op.operands):
                return False
            v = op.operands[i]
            if len(v.uses) != 1:
                return False
            func = op.parent
            return func is None or not any(r is v for r in func.returns)
        return self._add(pred)


# -- value predicates --------------------------------------------------------

def has_rank(r: int):
    return lambda v: v.type.rank == r


def has_static_shape():
    return lambda v: all(d > 0 for d in v.type.shape)


def has_dtype(*dts: str):
    return lambda v: v.type.dtype in dts


# -- MatcherUtils-style helpers ----------------------------------------------

CONTRACTIONS = ("tl.matmul", "tl.batch_matmul", "tl.brgemm", "tl.vnni_brgemm",
                "tl.blocked_matmul")
CONVS = ("tl.conv2d_nchw_fchw", "tl.conv2d_nhwc_hwcf", "tl.blocked_conv2d")
ELTWISE_UNARY = ("tl.relu", "tl.identity", "tl.exp", "tl.negate", "tl.square",
                 "tl.sqrt", "tl.rsqrt", "tl.tanh", "tl.gelu")
ELTWISE_BINARY = ("tl.add", "tl.sub", "tl.mul", "tl.div", "tl.max")


def is_contraction(op: Operation | None) -> bool:
    return op is not None and op.opname in CONTRACTIONS


def is_conv(op: Operation | None) -> bool:
    return op is not None and op.opname in CONVS


def is_eltwise(op: Operation | None) -> bool:
    return op is not None and (op.opname in ELTWISE_UNARY
                               or op.opname in ELTWISE_BINARY)


def is_zero_op(op: Operation | None) -> bool:
    """Zero-producing op: tl.zero, tl.fill {value=0}, tl.constant zero, or a
    reshape/broadcast of one (reshaping zeros yields zeros)."""
    if op is None:
        return False
    if op.opname == "tl.zero":
        return True
    if op.opname == "tl.fill":
        return op.attrs.get("value") in (0, 0.0)
    if op.opname == "tl.constant":
        return op.attrs.get("init") == "zero"
    if op.opname in ("tl.reshape", "tl.broadcast", "tl.transpose"):
        return is_zero_op(op.operands[0].owner)
    return False


def is_pure_zero(op: Operation | None) -> bool:
    """Zero value with no destination operand to rewire (constant zero or a
    reshape/broadcast/transpose chain over one, including an already-lowered
    xsmm.unary transpose) — safe to leave in place when a BETA_0 fold makes
    it unread."""
    if op is None:
        return False
    if op.opname == "tl.constant":
        return op.attrs.get("init") == "zero"
    if op.opname in ("tl.reshape", "tl.broadcast", "tl.transpose"):
        return is_pure_zero(op.operands[0].owner)
    if op.opname == "xsmm.unary":
        d = op.operands[0].owner
        if d is not None and d.attrs.get("kind") in ("transpose", "identity"):
            return is_pure_zero(op.operands[1].owner)
        if d is not None and d.attrs.get("kind") == "zero":
            return True
    return False


def is_relu_op(op: Operation | None) -> bool:
    return op is not None and op.opname == "tl.relu"


def is_bias_add(op: Operation | None) -> bool:
    """tl.add where one operand broadcasts (a bias) — the reference infers
    this from affine maps (ConvertLinalgToXsmm.cpp:320-427)."""
    if op is None or op.opname != "tl.add":
        return False
    a, b = (v.type.shape for v in op.operands)
    return a != b
