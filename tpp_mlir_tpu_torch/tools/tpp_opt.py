"""tpp-opt on the port: run passes and pipelines on textual IR and print
the result (a copy of `tpp_mlir_tpu/tools/tpp_opt.py`, the reference's
tools/tpp-opt). Reads a file or stdin; no device is touched.

  python -m tpp_mlir_tpu_torch.tools.tpp_opt model.ir --default-tpp-passes
  python -m tpp_mlir_tpu_torch.tools.tpp_opt model.ir \\
      -p degeneralize,cleanup --print-after
  python -m tpp_mlir_tpu_torch.tools.tpp_opt --list
"""

from __future__ import annotations

import argparse
import sys

from ..ir import parse_module, print_module
from ..passes import PassManager, available_passes, available_pipelines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpp-opt (torch)", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("input", nargs="?", default="-")
    p.add_argument("-p", "--passes", default="",
                   help="comma-separated pass/pipeline names")
    p.add_argument("--print-after", action="store_true",
                   help="print the IR after each pass, to stderr")
    p.add_argument("--no-verify", action="store_true",
                   help="do not verify the module after each pass")
    p.add_argument("--list", action="store_true",
                   help="list the registered passes and pipelines")
    p.add_argument("-o", "--output", default="-")
    # the reference's direct flags: tpp-opt --default-tpp-passes
    args, extra = p.parse_known_args(argv)

    if args.list:
        print("passes:", ", ".join(available_passes()))
        print("pipelines:", ", ".join(available_pipelines()))
        return 0

    names = [x for x in args.passes.split(",") if x]
    for e in extra:
        if not e.startswith("--"):
            print(f"unknown argument {e}", file=sys.stderr)
            return 2
        names.append(e[2:])

    text = sys.stdin.read() if args.input == "-" else open(args.input).read()
    module = parse_module(text)
    module.verify()
    PassManager(names, print_after=args.print_after,
                verify_each=not args.no_verify).run(module)
    out = print_module(module)
    if args.output == "-":
        sys.stdout.write(out)
    else:
        with open(args.output, "w") as f:
            f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
