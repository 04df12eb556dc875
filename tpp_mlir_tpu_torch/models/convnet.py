"""Conv model builders — the ResNet-style conv->BRGEMM benchmark family
(BASELINE.md config 5: 3x3 stride-1 Conv2d -> BRGEMM per docs/ConvMapping.md
with fused bias+ReLU epilogue)."""

from __future__ import annotations

from dataclasses import dataclass

from ..ir import Function, Module, TensorType, TppBuilder


@dataclass
class ConvConfig:
    batch: int = 8
    channels: int = 128          # input channels C
    filters: int = 128           # output channels K
    height: int = 30             # input H (output H-R+1)
    width: int = 30
    kernel: int = 3              # R = S
    layers: int = 1              # stacked conv+bias+relu blocks
    float_type: str = "f32"
    bias: bool = True
    relu: bool = True
    const_weights: bool = True
    layout: str = "nchw"         # "nhwc": zero activation relayout on TPU
    padding: str = "valid"       # "same": pad (k-1)//2, spatial preserved
    residual: bool = False       # add block input before the final relu
    seed: int = 0


def conv_flops(cfg: ConvConfig) -> int:
    total = 0
    H, W = cfg.height, cfg.width
    C = cfg.channels
    same = cfg.padding == "same"
    for _ in range(cfg.layers):
        P, Q = (H, W) if same else (H - cfg.kernel + 1, W - cfg.kernel + 1)
        total += 2 * cfg.batch * cfg.filters * P * Q * C * cfg.kernel ** 2
        if cfg.bias:
            total += cfg.batch * cfg.filters * P * Q
        if cfg.relu:
            total += cfg.batch * cfg.filters * P * Q
        H, W, C = P, Q, cfg.filters
    if cfg.residual:
        total += cfg.batch * cfg.filters * H * W
    return total


def build_convnet(cfg: ConvConfig) -> Module:
    dt = cfg.float_type
    nhwc = cfg.layout == "nhwc"
    m = Module()
    in_shape = ((cfg.batch, cfg.height, cfg.width, cfg.channels) if nhwc
                else (cfg.batch, cfg.channels, cfg.height, cfg.width))
    arg_types = [TensorType(in_shape, dt)]
    arg_names = ["x"]
    if not cfg.const_weights:
        C = cfg.channels
        for i in range(cfg.layers):
            wshape = ((cfg.kernel, cfg.kernel, C, cfg.filters) if nhwc
                      else (cfg.filters, C, cfg.kernel, cfg.kernel))
            arg_types.append(TensorType(wshape, dt))
            arg_names.append(f"w{i}")
            if cfg.bias:
                arg_types.append(TensorType((cfg.filters,), dt))
                arg_names.append(f"b{i}")
            C = cfg.filters
    f = m.add(Function("entry", arg_types, arg_names))
    b = TppBuilder(f)

    x = f.args[0]
    block_in = x if cfg.residual else None
    if cfg.residual:
        assert cfg.padding == "same" and cfg.channels == cfg.filters, \
            "residual needs shape-preserving layers (same padding, C == K)"
    argi = 1
    same = cfg.padding == "same"
    p = (cfg.kernel - 1) // 2
    C, H, W = cfg.channels, cfg.height, cfg.width
    for i in range(cfg.layers):
        P, Q = (H, W) if same else (H - cfg.kernel + 1, W - cfg.kernel + 1)
        wshape = ((cfg.kernel, cfg.kernel, C, cfg.filters) if nhwc
                  else (cfg.filters, C, cfg.kernel, cfg.kernel))
        if cfg.const_weights:
            w = b.constant(TensorType(wshape, dt),
                           init="normal", seed=cfg.seed + 2 * i + 1)
            bias = b.constant(TensorType((cfg.filters,), dt), init="normal",
                              seed=cfg.seed + 2 * i + 2) if cfg.bias else None
        else:
            w = f.args[argi]
            argi += 1
            bias = None
            if cfg.bias:
                bias = f.args[argi]
                argi += 1
        oshape = ((cfg.batch, P, Q, cfg.filters) if nhwc
                  else (cfg.batch, cfg.filters, P, Q))
        acc = b.constant(TensorType(oshape, dt), init="zero")
        last = i == cfg.layers - 1
        if nhwc:
            if same and p:
                x = b.pad(x, (0, p, p, 0), (0, p, p, 0))
            x = b.conv2d_nhwc_hwcf(x, w, acc, strides=(1, 1))
            if cfg.bias:
                x = b.add(x, bias)
        else:
            if same and p:
                x = b.pad(x, (0, 0, p, p), (0, 0, p, p))
            x = b.conv2d_nchw_fchw(x, w, acc, strides=(1, 1))
            if cfg.bias:
                bias3 = b.reshape(bias, (cfg.filters, 1, 1))
                x = b.add(x, bias3)
        if last and block_in is not None:
            x = b.add(x, block_in)
        if cfg.relu:
            x = b.relu(x)
        C, H, W = cfg.filters, P, Q
    b.ret(x)
    m.attrs["flops"] = conv_flops(cfg)
    m.verify()
    return m
