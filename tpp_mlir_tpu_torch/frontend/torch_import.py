"""PyTorch importer — the torch-dynamo ingestion equivalent.

The reference benchmarks torch-dynamo-exported MLP/GEMM models
(benchmarks/mlir/pytorch/*.mlir, config/pytorch/torch_dynamo.json): torch
traces to linalg IR, then the TPP pipeline compiles it. Here the importer
converts a torch.nn module directly into the tensor IR; weights become
literal constants (pre-packable by constant-fold-pack like any weight).

Supported module classes: Sequential / Linear (rank-2 or batch-first
rank-3 tokens) / ReLU / GELU / Tanh / Softmax / Flatten / Conv2d (incl.
zero padding) / BatchNorm2d (eval fold to scale+shift) / MaxPool2d /
AvgPool2d / LayerNorm (last dim) / MultiheadAttention (batch_first
self-attention -> ONE tl.attention core, i.e. the flash kernel) /
Identity / Dropout. Everything runs through the same default pipeline as
tpp-gen models — a torch transformer encoder block imports end to end.

Both importers (module-walk `import_torch` and graph-level
`import_torch_fx`) share ONE layer-lowering (`_LayerLowering`), so they
cannot diverge.
"""

from __future__ import annotations

from ..ir import Function, Module, TensorType, TppBuilder


def _pair(v):
    return v if isinstance(v, tuple) else (v, v)


class _LayerLowering:
    """Lowers a single torch.nn layer into tensor IR. Shared by the module
    importer and the fx importer so their semantics are identical."""

    def __init__(self, module: Module, builder: TppBuilder, dtype: str,
                 prefix: str):
        self.m = module
        self.b = builder
        self.dtype = dtype
        self.prefix = prefix
        self._counter = 0

    def const_of(self, tensor, shape):
        key = f"{self.prefix}{self._counter}_w"
        self._counter += 1
        self.m.literals[key] = tensor.detach().cpu().float().numpy()
        return self.b.create(
            "tl.constant", [], [TensorType(tuple(shape), self.dtype)],
            {"init": "literal", "literal": key}).result

    def lower(self, layer, x, **kw):
        import torch
        import torch.nn as nn

        b, dtype = self.b, self.dtype
        if isinstance(layer, nn.Sequential):
            for sub in layer:
                x = self.lower(sub, x)
                if isinstance(x, tuple):   # e.g. MultiheadAttention
                    x = x[0]
            return x
        if isinstance(layer, nn.Linear):
            K, N = layer.in_features, layer.out_features
            shape3 = x.type.shape if x.type.rank == 3 else None
            if shape3 is not None:   # tokens (B, S, E): flatten for the GEMM
                x = b.reshape(x, (shape3[0] * shape3[1], shape3[2]))
            w = self.const_of(layer.weight.T.contiguous(), (K, N))
            acc = b.constant(TensorType((x.type.shape[0], N), dtype),
                             init="zero")
            x = b.matmul(x, w, acc)
            if layer.bias is not None:
                x = b.add(x, self.const_of(layer.bias, (N,)))
            if shape3 is not None:
                x = b.reshape(x, (shape3[0], shape3[1], N))
            return x
        if isinstance(layer, nn.LayerNorm):
            return self.layer_norm(layer, x)
        if isinstance(layer, nn.MultiheadAttention):
            return self.multihead_attention(layer, x, **kw)
        if isinstance(layer, nn.Conv2d):
            if _pair(layer.dilation) != (1, 1):
                raise NotImplementedError(
                    f"torch import: Conv2d dilation={layer.dilation} is not "
                    "supported (only dilation=1)")
            if layer.groups != 1:
                raise NotImplementedError(
                    f"torch import: Conv2d groups={layer.groups} is not "
                    "supported (only groups=1)")
            if isinstance(layer.padding, str):
                raise NotImplementedError(
                    f"torch import: Conv2d string padding "
                    f"{layer.padding!r} is not supported (use explicit ints)")
            K = layer.out_channels
            w = self.const_of(layer.weight, tuple(layer.weight.shape))
            ph, pw = _pair(layer.padding)
            if ph or pw:
                x = b.pad(x, (0, 0, ph, pw), (0, 0, ph, pw))
            N_, C, H, W = x.type.shape
            R, S = layer.kernel_size
            sh, sw = layer.stride
            P = (H - R) // sh + 1
            Q = (W - S) // sw + 1
            acc = b.constant(TensorType((N_, K, P, Q), dtype), init="zero")
            x = b.conv2d_nchw_fchw(x, w, acc, strides=(sh, sw))
            if layer.bias is not None:
                x = b.add(x, b.reshape(self.const_of(layer.bias, (K,)),
                                       (K, 1, 1)))
            return x
        if isinstance(layer, nn.BatchNorm2d):
            # eval-mode fold: y = x * a + b, a = gamma/sqrt(var+eps),
            # b = beta - mean*a (per channel)
            with torch.no_grad():
                a = layer.weight / torch.sqrt(layer.running_var + layer.eps)
                bb = layer.bias - layer.running_mean * a
            C = a.numel()
            return b.add(
                b.mul(x, self.const_of(a.reshape(C, 1, 1), (C, 1, 1))),
                self.const_of(bb.reshape(C, 1, 1), (C, 1, 1)))
        if isinstance(layer, nn.ReLU):
            return b.relu(x)
        if isinstance(layer, nn.GELU):
            # torch default is the exact erf gelu; 'tanh' selects the
            # approximation — distinct tl kinds so numerics match exactly
            return b.unary("tl.gelu_tanh"
                           if getattr(layer, "approximate", "none") == "tanh"
                           else "tl.gelu", x)
        if isinstance(layer, nn.Tanh):
            return b.unary("tl.tanh", x)
        if isinstance(layer, nn.Softmax):
            return b.softmax(x, axis=layer.dim if layer.dim is not None
                             else -1)
        if isinstance(layer, (nn.MaxPool2d, nn.AvgPool2d)):
            ks = _pair(layer.kernel_size)
            st = _pair(layer.stride or ks)
            # refuse what the tl pool cannot express rather than import
            # silently-wrong semantics (the Conv2d handler's discipline)
            if _pair(getattr(layer, "padding", 0)) != (0, 0):
                raise NotImplementedError("pool2d padding != 0")
            if _pair(getattr(layer, "dilation", 1)) not in ((1, 1),):
                raise NotImplementedError("pool2d dilation != 1")
            if getattr(layer, "ceil_mode", False):
                raise NotImplementedError("pool2d ceil_mode")
            opn = ("tl.max_pool2d" if isinstance(layer, nn.MaxPool2d)
                   else "tl.avg_pool2d")
            return b.pool2d(opn, x, ks, st)
        if isinstance(layer, nn.Flatten):
            n = 1
            for d in x.type.shape[1:]:
                n *= d
            return b.reshape(x, (x.type.shape[0], n))
        if isinstance(layer, (nn.Identity, nn.Dropout)):
            return x
        if isinstance(layer, nn.Embedding):
            # token-id lookup -> tl.gather; the table is a literal constant
            # like any weight. Gathers stay tl-level through the pipeline
            # (XLA's dynamic-slice machinery, not an MXU op).
            V, E = layer.num_embeddings, layer.embedding_dim
            table = self.const_of(layer.weight, (V, E))
            return b.gather(table, x)
        if isinstance(layer, nn.TransformerEncoderLayer):
            # Stock torch encoder layer. Its forward is not fx-traceable
            # (mask dtype checks on proxies), but as a MODULE it decomposes
            # exactly into handlers we already have; dropouts are identity
            # in eval. Handles both norm_first (pre-LN) and the post-LN
            # default.
            import torch.nn.functional as F

            def sa(h):
                return self.multihead_attention(layer.self_attn, h)[0]

            def ff(h):
                h = self.lower(layer.linear1, h)
                act = layer.activation
                if act is F.relu or isinstance(act, nn.ReLU):
                    h = b.relu(h)
                elif act is F.gelu or isinstance(act, nn.GELU):
                    kind = ("tl.gelu_tanh"
                            if getattr(act, "approximate", "none") == "tanh"
                            else "tl.gelu")
                    h = b.unary(kind, h)
                else:
                    raise NotImplementedError(
                        f"torch import: TransformerEncoderLayer activation "
                        f"{act} is not supported (relu/gelu)")
                return self.lower(layer.linear2, h)

            if layer.norm_first:
                x = b.add(x, sa(self.layer_norm(layer.norm1, x)))
                return b.add(x, ff(self.layer_norm(layer.norm2, x)))
            x = self.layer_norm(layer.norm1, b.add(x, sa(x)))
            return self.layer_norm(layer.norm2, b.add(x, ff(x)))
        if isinstance(layer, nn.TransformerEncoder):
            for blk in layer.layers:
                x = self.lower(blk, x)
            if layer.norm is not None:
                x = self.layer_norm(layer.norm, x)
            return x
        raise NotImplementedError(
            f"torch import: unsupported layer {type(layer).__name__}")

    def layer_norm(self, layer, x):
        """Emit the FUSED tl.layer_norm op (one Pallas kernel: one HBM read,
        one write — the decomposed reduce/eltwise spelling costs ~6 kernel
        round trips). Biased variance matches torch."""
        b = self.b
        if len(layer.normalized_shape) != 1:
            raise NotImplementedError(
                "torch import: LayerNorm over multiple trailing dims is not "
                "supported (normalize the last dim only)")
        shape3 = x.type.shape if x.type.rank == 3 else None
        if shape3 is not None:
            x = b.reshape(x, (shape3[0] * shape3[1], shape3[2]))
        E = x.type.shape[-1]
        gamma = beta = None
        if layer.elementwise_affine:
            gamma = self.const_of(layer.weight, (E,))
            beta = (self.const_of(layer.bias, (E,))
                    if layer.bias is not None
                    else self.const_of(
                        __import__("torch").zeros(E), (E,)))
        y = b.layer_norm(x, gamma, beta, eps=float(layer.eps))
        if shape3 is not None:
            y = b.reshape(y, shape3)
        return y

    def multihead_attention(self, layer, x, need_weights=False,
                            is_causal=False, attn_mask=None, **_ignored):
        """nn.MultiheadAttention self-attention (batch_first): packed
        in-projection split into Q/K/V GEMMs, head split/merge reshapes,
        ONE tl.attention core (the flash kernel after lowering), output
        projection. `is_causal=True` becomes the attention op's causal
        attr (decoder blocks — torch-dynamo benchmark parity). Returns
        (result, None) matching torch's API."""
        b, dtype = self.b, self.dtype
        if attn_mask is not None and not is_causal:
            raise NotImplementedError(
                "torch import: arbitrary attn_mask is not supported "
                "(is_causal=True covers the decoder case)")
        if not layer.batch_first:
            raise NotImplementedError(
                "torch import: MultiheadAttention requires batch_first=True")
        if not layer._qkv_same_embed_dim:
            raise NotImplementedError(
                "torch import: MultiheadAttention needs kdim == vdim == "
                "embed_dim")
        E = layer.embed_dim
        H = layer.num_heads
        D = E // H
        B_, S, _ = x.type.shape
        M = B_ * S
        flat = b.reshape(x, (M, E))

        def in_proj(i):
            w = self.const_of(
                layer.in_proj_weight[i * E:(i + 1) * E].T.contiguous(),
                (E, E))
            acc = b.constant(TensorType((M, E), dtype), init="zero")
            v = b.matmul(flat, w, acc)
            if layer.in_proj_bias is not None:
                v = b.add(v, self.const_of(
                    layer.in_proj_bias[i * E:(i + 1) * E], (E,)))
            # token layout straight into the core: per-head columns are
            # selected inside the attention kernel (heads attr) — no
            # head-split transposes exist
            return b.reshape(v, (B_, S, E))

        q, k, v = in_proj(0), in_proj(1), in_proj(2)
        attrs = {"scale": D ** -0.5, "heads": H}
        if is_causal:
            attrs["causal"] = True
        att = b.create("tl.attention", [q, k, v],
                       [TensorType((B_, S, E), dtype)], attrs).result
        # output projection (NonDynamicallyQuantizableLinear is a Linear)
        outp = layer.out_proj
        flat_ctx = b.reshape(att, (M, E))
        w = self.const_of(outp.weight.T.contiguous(), (E, E))
        acc = b.constant(TensorType((M, E), dtype), init="zero")
        out = b.matmul(flat_ctx, w, acc)
        if outp.bias is not None:
            out = b.add(out, self.const_of(outp.bias, (E,)))
        return (b.reshape(out, (B_, S, E)), None)


def import_torch(model, example_shape, dtype: str = "f32",
                 name: str = "entry",
                 input_dtype: str | None = None) -> Module:
    """Convert a torch.nn module to a tensor-IR Module.

    example_shape: input tensor shape (batch included). input_dtype
    overrides the entry argument's dtype (token-id inputs of
    Embedding-first models want i32)."""
    model = model.eval()
    m = Module()
    f = m.add(Function(name, [TensorType(tuple(example_shape),
                                         input_dtype or dtype)],
                       ["x"]))
    b = TppBuilder(f)
    lowering = _LayerLowering(m, b, dtype, "t")

    out = lowering.lower(model, f.args[0])
    b.ret(out)
    m.verify()

    # FLOP accounting for the harness (BENCH_TOTAL_FLOPS role)
    from ..utils.flops import count_flops

    m.attrs["flops"] = count_flops(m, name)
    return m


def import_torch_fx(model, example_shape, dtype: str = "f32",
                    name: str = "entry",
                    input_dtype: str | None = None) -> Module:
    """Graph-level importer via torch.fx symbolic tracing: handles residual
    connections and functional calls (the closest analogue of the
    reference's torch-dynamo linalg export). call_module nodes lower
    through the same `_LayerLowering` as `import_torch`.

    input_dtype overrides the entry argument's dtype (token-id inputs of
    embedding models are "i32"; compute stays in `dtype`)."""
    import operator

    import torch
    import torch.fx as fx
    import torch.nn.functional as F

    model = model.eval()
    graph_module = fx.symbolic_trace(model)
    modules = dict(graph_module.named_modules())

    m = Module()
    f = m.add(Function(name, [TensorType(tuple(example_shape),
                                         input_dtype or dtype)],
                       ["x"]))
    b = TppBuilder(f)
    lowering = _LayerLowering(m, b, dtype, "fx")

    env = {}

    def val(name):
        """Materialize an env entry for use as an IR value. get_attr
        tensors stay lazy torch tensors until consumed so buffers that
        only feed torch-side kwargs (e.g. an explicit causal attn_mask,
        which torch needs but the attention op's causal attr subsumes)
        never become dead constants."""
        v = env[name]
        if isinstance(v, torch.Tensor):
            v = env[name] = lowering.const_of(v, tuple(v.shape))
        return v

    seen_placeholder = False
    for node in graph_module.graph.nodes:
        if node.op == "placeholder":
            if seen_placeholder:
                raise NotImplementedError(
                    "fx import: multiple model inputs are not supported "
                    "(every placeholder would alias the single entry "
                    "argument)")
            seen_placeholder = True
            env[node.name] = f.args[0]
        elif node.op == "get_attr":
            # registered buffers / bare parameters read in forward (e.g. a
            # learned positional table) — lowered to literal constants on
            # first real use (see `val`)
            t = graph_module
            for part in node.target.split("."):
                t = getattr(t, part)
            env[node.name] = t
        elif node.op == "call_module":
            # self-attention calls pass (q, k, v) positionally — all three
            # must be the same traced value (q = k = v) — plus kwargs
            # (need_weights, is_causal) forwarded to the layer lowering
            for extra in node.args[1:]:
                if getattr(extra, "name", None) != node.args[0].name:
                    raise NotImplementedError(
                        f"fx import: cross-attention (distinct q/k/v) is "
                        f"not supported at {node.target}")
            dropped = [k for k, v in node.kwargs.items()
                       if hasattr(v, "name")]
            # a tensor attn_mask may be dropped ONLY when is_causal=True
            # rides along (the lowering applies causal masking, identical
            # semantics); an attn_mask alone would silently import
            # BIDIRECTIONAL attention — refuse loudly
            if dropped and not (set(dropped) == {"attn_mask"}
                                and node.kwargs.get("is_causal") is True):
                raise NotImplementedError(
                    f"fx import: tensor-valued kwargs {dropped} at "
                    f"{node.target} are not supported (a causal mask must "
                    f"come WITH is_causal=True; other masks are "
                    f"unsupported)")
            kw = {k: v for k, v in node.kwargs.items()
                  if not hasattr(v, "name")}
            env[node.name] = lowering.lower(modules[node.target],
                                            val(node.args[0].name), **kw)
        elif node.op == "call_function":
            if node.target is operator.getitem:
                env[node.name] = env[node.args[0].name][node.args[1]]
            elif node.target in (operator.add, torch.add):
                if not all(hasattr(a, "name") for a in node.args[:2]):
                    raise NotImplementedError(
                        "fx import: add with a Python-scalar operand "
                        "(fold the constant into the model instead)")
                env[node.name] = b.add(val(node.args[0].name),
                                       val(node.args[1].name))
            elif node.target in (torch.relu, F.relu):
                env[node.name] = b.relu(val(node.args[0].name))
            elif node.target is torch.flatten:
                x = val(node.args[0].name)
                start = (node.args[1] if len(node.args) > 1
                         else node.kwargs.get("start_dim", 0))
                end = (node.args[2] if len(node.args) > 2
                       else node.kwargs.get("end_dim", -1))
                shape = list(x.type.shape)
                if end == -1 or end == len(shape) - 1:
                    n = 1
                    for d in shape[start:]:
                        n *= d
                    env[node.name] = b.reshape(
                        x, tuple(shape[:start]) + (n,))
                else:
                    raise NotImplementedError(
                        f"fx import: flatten end_dim={end}")
            else:
                raise NotImplementedError(
                    f"fx import: unsupported function {node.target}")
        elif node.op == "call_method":
            # tensor shape-plumbing methods (the ViT-class models:
            # conv patch embed -> flatten -> transpose -> encoder)
            if node.target in ("reshape", "view"):
                x = val(node.args[0].name)
                dims = [d for d in node.args[1:]]
                if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
                    dims = list(dims[0])
                n = 1
                for d in x.type.shape:
                    n *= d
                if -1 in dims:
                    known = 1
                    for d in dims:
                        if d != -1:
                            known *= d
                    dims[dims.index(-1)] = n // known
                env[node.name] = b.reshape(x, tuple(dims))
            elif node.target == "transpose":
                x = val(node.args[0].name)
                d0, d1 = node.args[1], node.args[2]
                perm = list(range(len(x.type.shape)))
                perm[d0], perm[d1] = perm[d1], perm[d0]
                env[node.name] = b.transpose(x, tuple(perm))
            elif node.target == "permute":
                x = val(node.args[0].name)
                dims = node.args[1:]
                if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
                    dims = tuple(dims[0])
                env[node.name] = b.transpose(x, tuple(dims))
            elif node.target == "flatten":
                x = val(node.args[0].name)
                start = node.args[1] if len(node.args) > 1 \
                    else node.kwargs.get("start_dim", 0)
                shape = list(x.type.shape)
                end = node.args[2] if len(node.args) > 2 \
                    else node.kwargs.get("end_dim", -1)
                if end < 0:
                    end += len(shape)
                n = 1
                for d in shape[start:end + 1]:
                    n *= d
                env[node.name] = b.reshape(
                    x, tuple(shape[:start]) + (n,) + tuple(shape[end + 1:]))
            elif node.target == "contiguous":
                env[node.name] = val(node.args[0].name)
            else:
                raise NotImplementedError(
                    f"fx import: unsupported method {node.target}")
        elif node.op == "output":
            arg = node.args[0]
            b.ret(val(arg.name) if hasattr(arg, "name")
                  else val(arg[0].name))
    m.verify()
    from ..utils.flops import count_flops

    m.attrs["flops"] = count_flops(m, name)
    return m
