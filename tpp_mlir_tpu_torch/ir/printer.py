"""Textual IR printer.

Format is MLIR-flavored so golden tests read like the reference's FileCheck
tests (reference test/Passes/*.mlir):

    module attributes {flops = 123} {
      func @entry(%arg0: tensor<4x4xf32>) -> tensor<4x4xf32> {
        %0 = tl.relu %arg0 : tensor<4x4xf32>
        return %0 : tensor<4x4xf32>
      }
    }
"""

from __future__ import annotations

from .core import Function, Module, Operation


def _attr_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (tuple, list)):
        return "[" + ", ".join(_attr_value(x) for x in v) + "]"
    raise TypeError(f"unprintable attr {v!r}")


def print_attrs(attrs: dict) -> str:
    if not attrs:
        return ""
    inner = ", ".join(f"{k} = {_attr_value(v)}" for k, v in sorted(attrs.items()))
    return "{" + inner + "}"


def print_op(op: Operation) -> str:
    parts = []
    if op.results:
        parts.append(", ".join(f"%{r.name}" for r in op.results) + " =")
    parts.append(op.opname)
    if op.operands:
        parts.append(", ".join(f"%{v.name}" for v in op.operands))
    a = print_attrs(op.attrs)
    if a:
        parts.append(a)
    if op.results:
        parts.append(": " + ", ".join(str(r.type) for r in op.results))
    return " ".join(parts)


def print_function(f: Function, indent: str = "") -> str:
    args = ", ".join(f"%{a.name}: {a.type}" for a in f.args)
    rets = ", ".join(str(v.type) for v in f.returns)
    head = f"{indent}func @{f.name}({args})"
    if rets:
        head += f" -> {rets}" if len(f.returns) == 1 else f" -> ({rets})"
    if f.attrs:
        head += " attributes " + print_attrs(f.attrs)
    lines = [head + " {"]
    for op in f.ops:
        lines.append(indent + "  " + print_op(op))
    if f.returns:
        vals = ", ".join(f"%{v.name}" for v in f.returns)
        types = ", ".join(str(v.type) for v in f.returns)
        lines.append(f"{indent}  return {vals} : {types}")
    else:
        lines.append(f"{indent}  return")
    lines.append(indent + "}")
    return "\n".join(lines)


def print_module(m: Module) -> str:
    head = "module"
    if m.attrs:
        head += " attributes " + print_attrs(m.attrs)
    lines = [head + " {"]
    for f in m.funcs.values():
        lines.append(print_function(f, "  "))
    lines.append("}")
    return "\n".join(lines) + "\n"
