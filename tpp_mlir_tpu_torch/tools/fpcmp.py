"""tpp-fpcmp on the port: a tolerance-based numeric diff of printed tensor
files (a copy of `tpp_mlir_tpu/tools/fpcmp.py`'s pure-Python comparison;
the reference's tools/fpcmp/fpcmp.c). Every float token of the two files is
compared under -a (absolute) and -r (relative) tolerances; equal values,
equal infinities included, and two NaNs match. Exit 0 on a match, 1 on a
mismatch (the first offending pair is reported), 2 on a usage error.

  python -m tpp_mlir_tpu_torch.tools.fpcmp low.txt ref.txt -r 1e-4
"""

from __future__ import annotations

import argparse
import re
import sys

_FLOAT_RE = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
                       r"|nan|inf|-inf", re.IGNORECASE)


def extract_floats(text: str) -> list[float]:
    return [float(t) for t in _FLOAT_RE.findall(text)]


def compare_values(a: list[float], b: list[float], abs_tol: float,
                   rel_tol: float) -> tuple[bool, str]:
    if len(a) != len(b):
        return False, f"token count mismatch: {len(a)} vs {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if x == y:             # exact match, incl. equal infinities
            continue           # (inf - inf = NaN fails both tolerances)
        if x != x and y != y:  # both NaN
            continue
        d = abs(x - y)
        if d <= abs_tol:
            continue
        denom = max(abs(x), abs(y))
        if denom > 0 and d / denom <= rel_tol:
            continue
        return False, (f"value {i}: {x} vs {y} exceeds tolerances "
                       f"(abs={abs_tol}, rel={rel_tol})")
    return True, ""


def compare_files(f1: str, f2: str, abs_tol: float = 1e-6,
                  rel_tol: float = 1e-4) -> tuple[bool, str]:
    with open(f1) as fa, open(f2) as fb:
        a, b = extract_floats(fa.read()), extract_floats(fb.read())
    return compare_values(a, b, abs_tol, rel_tol)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpp-fpcmp (torch)",
                                description=__doc__)
    p.add_argument("file1")
    p.add_argument("file2")
    p.add_argument("-a", "--abs-tolerance", type=float, default=1e-6)
    p.add_argument("-r", "--rel-tolerance", type=float, default=1e-4)
    args = p.parse_args(argv)
    ok, msg = compare_files(args.file1, args.file2, args.abs_tolerance,
                            args.rel_tolerance)
    if not ok:
        print(f"fpcmp: {msg}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
