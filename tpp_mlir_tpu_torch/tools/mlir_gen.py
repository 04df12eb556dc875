"""tpp-gen: parameterized model generator (the mlir-gen equivalent).

CLI mirrors reference tools/mlir-gen/mlir-gen.cpp:35-102:
  tpp-gen --batch=256 --layers=1024,1024 --tiles=32,32,32 --bias --relu \
          --float-type=bf16 --vnni=2 --kernel=const --seed=7
Prints the IR module with a '// BENCH_TOTAL_FLOPS: N' header (consumed by the
benchmark harness, reference MLIRGen.cpp:300-306).
"""

from __future__ import annotations

import argparse
import sys

from ..ir import print_module
from ..models.mlp import MlpConfig, build_mlp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpp-gen", description=__doc__)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--layers", type=str, default="1024,1024",
                   help="comma list: input size then each layer's output")
    p.add_argument("--tiles", type=str, default="",
                   help="mb,nb,kb pack block sizes (empty = target default)")
    p.add_argument("--float-type", choices=["f32", "bf16", "f16"],
                   default="f32")
    p.add_argument("--bias", action="store_true")
    p.add_argument("--relu", action="store_true")
    p.add_argument("--softmax", action="store_true")
    p.add_argument("--kernel", choices=["args", "const"], default="const")
    p.add_argument("--vnni", type=int, choices=[0, 2, 4], default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init-type", default="normal",
                   help="const-weight init kind")
    p.add_argument("--output", choices=["named", "generic"], default="named",
                   help="generic emits tl.generic forms with indexing maps "
                        "(reference MLIRGen.cpp:148-230)")
    return p


def config_from_args(args) -> MlpConfig:
    layers = tuple(int(x) for x in args.layers.split(",") if x)
    tiles = tuple(int(x) for x in args.tiles.split(",") if x) or None
    return MlpConfig(batch=args.batch, layers=layers, tiles=tiles,
                     float_type=args.float_type, bias=args.bias,
                     relu=args.relu, softmax=args.softmax, kernel=args.kernel,
                     vnni=args.vnni, seed=args.seed, init_type=args.init_type,
                     output=args.output)


def generate_text(cfg: MlpConfig) -> str:
    m = build_mlp(cfg)
    return f"// BENCH_TOTAL_FLOPS: {m.attrs['flops']}\n" + print_module(m)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sys.stdout.write(generate_text(config_from_args(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
