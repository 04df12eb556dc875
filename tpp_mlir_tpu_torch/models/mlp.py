"""Parameterized MLP/GEMM model builder — the mlir-gen model core.

Mirrors reference tools/mlir-gen (MLIRGen.cpp:148-230, MLIRGen.h:143-219):
a chain of layers `out = relu(x @ W + bias)` with options for bias/relu/
softmax, constant-vs-argument weights, fp32/bf16, and FLOP accounting
(computeMatmulFlops/computeBiasOrReluFlops, MLIRGen.cpp:315-333).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ir import Function, Module, TensorType, TppBuilder


@dataclass
class MlpConfig:
    batch: int = 256
    # layer sizes: first is the input width, rest are outputs of each layer
    layers: tuple = (1024, 1024)
    tiles: tuple | None = None       # (mb, nb, kb) pack blocks; None = auto
    float_type: str = "f32"
    bias: bool = False
    relu: bool = False
    softmax: bool = False
    kernel: str = "const"            # weights as constants (reference default); "args"
    vnni: int = 0                    # 0/2/4; recorded for the pipeline
    seed: int = 0
    init_type: str = "normal"        # for const weights
    name: str = "entry"
    # "named" emits tl.matmul/tl.add/tl.relu; "generic" emits tl.generic
    # forms with indexing maps (reference mlir-gen --output=generic,
    # MLIRGen.cpp:148-230)
    output: str = "named"


def mlp_flops(cfg: MlpConfig) -> int:
    """BENCH_TOTAL_FLOPS accounting (reference MLIRGen.cpp:315-333,551-555):
    matmul 2*M*N*K; bias M*N; relu M*N; softmax 4*M*N."""
    total = 0
    M = cfg.batch
    for i in range(len(cfg.layers) - 1):
        K, N = cfg.layers[i], cfg.layers[i + 1]
        total += 2 * M * N * K
        if cfg.bias:
            total += M * N
        if cfg.relu:
            total += M * N
    if cfg.softmax:
        total += 4 * M * cfg.layers[-1]
    return total


def _blocked_ok(cfg: MlpConfig) -> bool:
    if not cfg.tiles or cfg.output == "generic":
        return False
    mb, nb, kb = cfg.tiles
    if cfg.batch % mb:
        return False
    if any(cfg.layers[i] % kb or cfg.layers[i + 1] % nb
           for i in range(len(cfg.layers) - 1)):
        return False
    if cfg.vnni and kb % cfg.vnni:
        return False
    return True


def _build_mlp_blocked(cfg: MlpConfig) -> Module:
    """--tiles emits PRE-BLOCKED IR (reference MLIRGen.cpp:384-417 emits
    packed/VNNI tensor types directly): args/consts carry blocked layouts,
    layers are tl.blocked_matmul, bias adds ride the (1,Nb,1,nb) reshape —
    the blocked-ingress pipeline path can be driven and golden-tested from
    the generator alone, no pack-matmul pass needed."""
    mb, nb, kb = cfg.tiles
    dt = cfg.float_type
    M = cfg.batch
    m = Module()
    arg_types = [TensorType((M // mb, cfg.layers[0] // kb, mb, kb), dt)]
    arg_names = ["x"]
    if cfg.kernel != "const":
        for i in range(len(cfg.layers) - 1):
            K, N = cfg.layers[i], cfg.layers[i + 1]
            arg_types.append(TensorType((N // nb, K // kb, kb, nb), dt))
            arg_names.append(f"w{i}")
            if cfg.bias:
                arg_types.append(TensorType((N // nb, nb), dt))
                arg_names.append(f"b{i}")
    f = m.add(Function(cfg.name, arg_types, arg_names))
    b = TppBuilder(f)

    x = f.args[0]
    argi = 1
    for i in range(len(cfg.layers) - 1):
        K, N = cfg.layers[i], cfg.layers[i + 1]
        if i > 0 and nb != kb:
            # relayout between layers when the output tile is not the next
            # contraction tile
            flat = b.unpack(x, (0, 1), (mb, nb), (M, K))
            x = b.pack(flat, (0, 1), (mb, kb))
        if cfg.kernel == "const":
            w = b.create("tl.constant", [],
                         [TensorType((N // nb, K // kb, kb, nb), dt)],
                         {"init": cfg.init_type, "seed": cfg.seed + 2 * i + 1,
                          "orig_shape": (K, N), "pack_inner_dims": (0, 1),
                          "pack_inner_tiles": (kb, nb),
                          "pack_outer_perm": (1, 0)}).result
            bias = b.create("tl.constant", [],
                            [TensorType((N // nb, nb), dt)],
                            {"init": cfg.init_type,
                             "seed": cfg.seed + 2 * i + 2,
                             "orig_shape": (N,), "pack_inner_dims": (0,),
                             "pack_inner_tiles": (nb,)}).result \
                if cfg.bias else None
        else:
            w = f.args[argi]
            argi += 1
            bias = None
            if cfg.bias:
                bias = f.args[argi]
                argi += 1
        acc = b.create("tl.constant", [],
                       [TensorType((M // mb, N // nb, mb, nb), dt)],
                       {"init": "zero", "seed": 0, "orig_shape": (M, N),
                        "pack_inner_dims": (0, 1),
                        "pack_inner_tiles": (mb, nb)}).result
        mm_attrs = {}
        if cfg.vnni and dt in ("bf16", "f16"):
            # reference VNNIUtils blocks BOTH 16-bit float types at
            # factor 2 (include/TPP/.../VNNIUtils.h via DLTI); f16 was
            # previously silently un-packed (r5 verdict #6)
            w = b.create("tl.vnni_pack", [w],
                         [w.type.with_shape((N // nb, K // kb,
                                             kb // cfg.vnni, nb, cfg.vnni))],
                         {"vnni": cfg.vnni}).result
            mm_attrs["vnni"] = cfg.vnni
        x = b.create("tl.blocked_matmul", [x, w, acc],
                     [acc.type], mm_attrs).result
        if bias is not None:
            x = b.add(x, b.reshape(bias, (1, N // nb, 1, nb)))
        if cfg.relu:
            x = b.relu(x)
    out_flat = b.unpack(x, (0, 1), (mb, nb), (M, cfg.layers[-1]))
    if cfg.softmax:
        out_flat = b.softmax(out_flat, axis=1)
    b.ret(out_flat)
    m.attrs["flops"] = mlp_flops(cfg)
    m.attrs["tiles"] = tuple(cfg.tiles)
    if cfg.vnni:
        m.attrs["vnni"] = cfg.vnni
    m.verify()
    return m


def build_mlp(cfg: MlpConfig) -> Module:
    if _blocked_ok(cfg):
        return _build_mlp_blocked(cfg)
    dt = cfg.float_type
    m = Module()
    arg_types = [TensorType((cfg.batch, cfg.layers[0]), dt)]
    arg_names = ["x"]
    if cfg.kernel != "const":
        for i in range(len(cfg.layers) - 1):
            K, N = cfg.layers[i], cfg.layers[i + 1]
            arg_types.append(TensorType((K, N), dt))
            arg_names.append(f"w{i}")
            if cfg.bias:
                arg_types.append(TensorType((N,), dt))
                arg_names.append(f"b{i}")
    f = m.add(Function(cfg.name, arg_types, arg_names))
    b = TppBuilder(f)

    x = f.args[0]
    argi = 1
    for i in range(len(cfg.layers) - 1):
        K, N = cfg.layers[i], cfg.layers[i + 1]
        if cfg.kernel == "const":
            w = b.constant(TensorType((K, N), dt), init=cfg.init_type,
                           seed=cfg.seed + 2 * i + 1)
            bias = b.constant(TensorType((N,), dt), init=cfg.init_type,
                              seed=cfg.seed + 2 * i + 2) if cfg.bias else None
        else:
            w = f.args[argi]
            argi += 1
            bias = None
            if cfg.bias:
                bias = f.args[argi]
                argi += 1
        acc = b.constant(TensorType((cfg.batch, N), dt), init="zero")
        if cfg.output == "generic":
            # generic-form layer (reference MLIRGen lowerMatmul/lowerBiasAdd/
            # lowerRelu in generic mode): maps carry the broadcast semantics
            mac = ("add", ("mul", ("arg", 0), ("arg", 1)), ("arg", 2))
            x = b.generic([x, w], acc, [(0, 2), (2, 1), (0, 1)],
                          ("parallel", "parallel", "reduction"), mac)
            if cfg.bias:
                x = b.generic([x, bias], x, [(0, 1), (1,), (0, 1)],
                              ("parallel", "parallel"),
                              ("add", ("arg", 0), ("arg", 1)))
            if cfg.relu:
                x = b.generic([x], x, [(0, 1), (0, 1)],
                              ("parallel", "parallel"),
                              ("maximumf", ("arg", 0), 0.0))
        else:
            x = b.matmul(x, w, acc)
            if cfg.bias:
                x = b.add(x, bias)
            if cfg.relu:
                x = b.relu(x)
    if cfg.softmax:
        x = b.softmax(x, axis=1)
    b.ret(x)

    m.attrs["flops"] = mlp_flops(cfg)
    if cfg.tiles:
        m.attrs["tiles"] = tuple(cfg.tiles)
    if cfg.vnni:
        m.attrs["vnni"] = cfg.vnni
    m.verify()
    return m


def build_gemm(batch: int, n: int, k: int, float_type: str = "f32",
               bias: bool = False, relu: bool = False) -> Module:
    """Single GEMM / FC layer (the matmul & fc benchmark sweeps,
    reference benchmarks/config/{matmul,fc})."""
    cfg = MlpConfig(batch=batch, layers=(k, n), float_type=float_type,
                    bias=bias, relu=relu)
    return build_mlp(cfg)
