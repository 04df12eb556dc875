"""Textual IR parser (inverse of printer.py).

Accepts the format produced by print_module / print_function, plus bare
functions without a module wrapper. Comment lines start with '//' and may
carry metadata headers the tools understand (e.g. '// BENCH_TOTAL_FLOPS: N',
mirroring reference tools/mlir-gen/MLIRGen.cpp:300-306).
"""

from __future__ import annotations

import re

from .core import Function, Module, Operation, Value
from .types import parse_type


class ParseError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*)
  | (?P<type>tensor<[^>]*>)
  | (?P<string>"[^"]*")
  | (?P<number>-?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)
  | (?P<ident>[@%]?[A-Za-z_][A-Za-z0-9_.\-]*|%\d+)
  | (?P<punct>->|[(){}\[\]=:,])
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> list[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ParseError(f"unexpected character {text[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup in ("ws", "comment"):
            continue
        toks.append(m.group())
    return toks


class _Cursor:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k] if self.i + k < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of input")
        self.i += 1
        return t

    def expect(self, tok):
        t = self.next()
        if t != tok:
            raise ParseError(f"expected {tok!r}, got {t!r} (pos {self.i - 1})")
        return t

    def accept(self, tok) -> bool:
        if self.peek() == tok:
            self.i += 1
            return True
        return False


def _parse_attr_value(c: _Cursor):
    t = c.peek()
    if t == "[":
        c.next()
        items = []
        while not c.accept("]"):
            items.append(_parse_attr_value(c))
            c.accept(",")
        return tuple(items)
    t = c.next()
    if t.startswith('"'):
        return t[1:-1]
    if t == "true":
        return True
    if t == "false":
        return False
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        raise ParseError(f"bad attr value {t!r}")


def _parse_attrs(c: _Cursor) -> dict:
    attrs = {}
    c.expect("{")
    while not c.accept("}"):
        key = c.next()
        c.expect("=")
        attrs[key] = _parse_attr_value(c)
        c.accept(",")
    return attrs


def _parse_function(c: _Cursor) -> Function:
    c.expect("func")
    name = c.next()
    if not name.startswith("@"):
        raise ParseError(f"expected @name, got {name!r}")
    c.expect("(")
    arg_names, arg_types = [], []
    while not c.accept(")"):
        n = c.next()
        if not n.startswith("%"):
            raise ParseError(f"expected %arg, got {n!r}")
        c.expect(":")
        arg_names.append(n[1:])
        arg_types.append(parse_type(c.next()))
        c.accept(",")
    if c.accept("->"):
        if c.accept("("):
            while not c.accept(")"):
                c.next()
                c.accept(",")
        else:
            c.next()  # single result type; recomputed from return
    if c.peek() == "attributes":
        c.next()
        fattrs = _parse_attrs(c)
    else:
        fattrs = {}
    func = Function(name[1:], arg_types, arg_names)
    func.attrs = fattrs
    env: dict[str, Value] = {a.name: a for a in func.args}
    c.expect("{")
    while not c.accept("}"):
        if c.peek() == "return":
            c.next()
            rets = []
            while c.peek() is not None and c.peek().startswith("%"):
                rets.append(c.next()[1:])
                c.accept(",")
            if c.accept(":"):
                for _ in rets:
                    c.next()
                    c.accept(",")
            try:
                func.returns = [env[r] for r in rets]
            except KeyError as e:
                raise ParseError(f"return of undefined value %{e.args[0]}")
            continue
        # results = opname operands {attrs} : types
        if c.peek() is None:
            raise ParseError("unexpected end of input inside a function "
                             "body (missing '}'?)")
        result_names = []
        if c.peek().startswith("%"):
            result_names.append(c.next()[1:])
            while c.accept(","):
                result_names.append(c.next()[1:])
            c.expect("=")
        opname = c.next()
        operands = []
        while c.peek() is not None and c.peek().startswith("%"):
            nm = c.next()[1:]
            if nm not in env:
                raise ParseError(f"use of undefined value %{nm}")
            operands.append(env[nm])
            if not c.accept(","):
                break
        attrs = _parse_attrs(c) if c.peek() == "{" else {}
        result_types = []
        if result_names:
            c.expect(":")
            for _ in result_names:
                result_types.append(parse_type(c.next()))
                c.accept(",")
        op = Operation(opname, operands, result_types, attrs)
        for nm, r in zip(result_names, op.results):
            r.name = nm
            env[nm] = r
        func.append(op)
    return func


def parse_module(text: str) -> Module:
    c = _Cursor(_tokenize(text))
    m = Module()
    if c.peek() == "module":
        c.next()
        if c.peek() == "attributes":
            c.next()
            m.attrs = _parse_attrs(c)
        c.expect("{")
        while not c.accept("}"):
            m.add(_parse_function(c))
    else:
        while c.peek() is not None:
            m.add(_parse_function(c))
    # Preserve metadata comments the tokenizer dropped.
    flops = re.search(r"//\s*BENCH_TOTAL_FLOPS:\s*(\d+)", text)
    if flops and "flops" not in m.attrs:
        m.attrs["flops"] = int(flops.group(1))
    return m


def parse_function(text: str) -> Function:
    mod = parse_module(text)
    if len(mod.funcs) != 1:
        raise ParseError("expected exactly one function")
    return next(iter(mod.funcs.values()))
