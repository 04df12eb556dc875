"""Kernel wrappers: one callable per key, a Hopper kernel behind it.

`build_kernel(key)` returns a `Kernel`. Called with CUDA tensors it checks
device, dtype, shape and contiguity, allocates the output with
`torch.empty`, launches the CUDA kernel on the current stream and raises if
the launch returned an error. Called with CPU tensors it runs the plain
version from `reference.py`; that is the only way the plain version is
reached. Each wrapper counts its launches.

  BrgemmKey    -> csrc/brgemm.cu     (replaces xsmm/kernels.py:580
                                     _build_brgemm and :243
                                     _build_brgemm_wres, LayerNorm
                                     prologue and the ln_stats
                                     producer/consumer pair included;
                                     loader by
                                     reference.brgemm_route, tile and k
                                     split by tpp_gemm_plan: the key's
                                     bm/bn/bk, else the tuning table
                                     (xsmm/tune.py), else its heuristic)
  ChainKey     -> csrc/chain.cu      (replaces :1475 _build_chain, :2001
                                     _build_chain_bench and, pingpong,
                                     :1919 _build_chain_bench_pingpong;
                                     body by reference.chain_route, the
                                     warm-panel engine's plan by
                                     reference.warm_plan)
  BatchMatmulKey -> csrc/batch_matmul.cu (replaces :963
                                     _build_batch_matmul and :1065
                                     _build_batch_matmul_grouped; the
                                     multi or tiled kernel by
                                     reference.batch_matmul_route)
  FlashMhaKey  -> by reference.attention_route:
                  csrc/attention.cu  (loader by reference.attention_loader;
                                     replaces :2232 _build_flash_mha_tokens,
                                     token layout; :1660 _build_flash_mha,
                                     :2395 _qblock, :2721 _grouped, :2496
                                     _causal_twocall and :2618
                                     _causal_fold2, flat layout; with
                                     repeats, :2091 _build_flash_bench)
                  B14's forward      (strategy flash_heads)
                  no kernel          (strategy xla: the composed PyTorch
                                     attention, as the reference composes
                                     it in XLA)
  LayerNormKey -> csrc/layer_norm.cu (replaces :3257 _build_layer_norm;
                                     body by reference.layer_norm_route)
  DecodeAttnKey -> csrc/decode_attn.cu (replaces tpp_mlir_tpu/xsmm/
                                     decode_attn.py:101 build_decode_attn;
                                     split by reference.decode_attn_plan)
  Int8GemmKey  -> csrc/int8_gemm.cu  (replaces :1365 _build_int8_gemm;
                                     body by reference.int8_gemm_route,
                                     tile, split and grid by
                                     reference.int8_gemm_plan)
  FlashTrainKey -> by reference.flash_train_fwd_route (replaces
                                     tpp_mlir_tpu/xsmm/flash_train.py:146
                                     build_flash_train_fwd, B14):
                  csrc/attention.cu  (bf16: the wgmma kernel's training
                                     mode)
                  csrc/flash_train.cu (f32: the f32-FMA forward)
  FlashTrainBwdKey -> csrc/flash_train.cu (replaces flash_train.py:190
                                     build_flash_train_bwd, B18; wgmma
                                     passes for bf16, f32-FMA passes for
                                     f32, by
                                     reference.flash_train_bwd_route)
  GroupedGemmKey -> csrc/grouped_gemm.cu (replaces :1138
                                     _build_grouped_gemm, B16; tile by
                                     reference.grouped_gemm_route)
  GroupedWgradKey -> csrc/grouped_gemm.cu (replaces :1283
                                     _build_grouped_wgrad, B17; tile by
                                     reference.grouped_wgrad_route)
  BlockedMatmulKey -> csrc/blocked_matmul.cu (replaces :763
                                     _build_blocked_matmul, B19, on
                                     brgemm.cu's mainloop, loader by
                                     reference.blocked_matmul_route; with
                                     repeats :870
                                     _build_blocked_matmul_warm, B20, body
                                     by reference.warm_route)
  ConvBrgemmKey -> csrc/conv.cu, the channel-blocked entry (replaces
                                     :2778 _build_conv_brgemm, B23; stride
                                     1, as the reference; body by
                                     reference.conv_kernel_route)
  ConvNhwcKey  -> by reference.conv_route:
                  csrc/conv.cu       (replaces :2919 _build_conv_nhwc, B24,
                                     and :3117 _build_conv_nhwc_fullrow,
                                     B25; stride 1; body by
                                     reference.conv_kernel_route, tile and
                                     split by reference.conv_plan)
                  no kernel          (strategy xla, and auto at stride > 1:
                                     torch.nn.functional.conv2d and the
                                     epilogue, TF32 off, as the reference
                                     leaves it to XLA's conv, :3068)

A Kernel captures its launch plan when it is built (Kernel.plan; the
GEMM-class launches run that plan and no other, with the workspace sized
for it): B1/B2 and B19 a reference.GemmPlan, the warm-panel engine (B3/B4/
B5, B20) a reference.WarmPlan, each from the key's fields, then
tune.tuned(key), then the heuristic. B21 (batch_matmul.cu) has no tile
choice to bind: its multi route runs one warp a problem, its tiled route
one 64 x 64 tile.

Other keys and options raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import reference
from .flags import (BatchMatmulKey, BinaryKey, BlockedMatmulKey, BrgemmKey,
                    ChainKey, ConvBrgemmKey, ConvNhwcKey, DecodeAttnKey,
                    FlashMhaKey, FlashTrainBwdKey, FlashTrainKey,
                    GroupedGemmKey, GroupedWgradKey, Int8GemmKey,
                    LayerNormKey, UnaryKey)

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BINARY_CODE = {None: 0, "add": 1, "sub": 2, "mul": 3, "div": 4, "max": 5}
_BCAST_CODE = {"bcast_col": 0, "bcast_row": 1, "bcast_scalar": 2, "none": 3}
_UNARY_CODE = {None: 0, "identity": 0, "relu": 1, "exp": 2, "square": 3,
               "sqrt": 4, "rsqrt": 5, "tanh": 6, "gelu": 7, "gelu_tanh": 8,
               "negate": 9, "zero": 10}

# chain.cu's row block, paddings, layer limit and the shared memory one block
# may opt into on sm_90 (227 KB); chain_fits_smem mirrors the kernel's need
CHAIN_BM, CHAIN_HPAD, CHAIN_ZPAD, CHAIN_MAXL = 16, 8, 4, 32
SM90_SMEM_OPTIN = reference.SM90_SMEM_OPTIN


def chain_smem_bytes(dmax: int, mxu: torch.dtype) -> int:
    """Dynamic shared memory chain.cu asks for (its smem_bytes())."""
    h = CHAIN_BM * (dmax + CHAIN_HPAD) * (2 if mxu == torch.bfloat16 else 4)
    return (h + 127) // 128 * 128 + CHAIN_BM * (dmax + CHAIN_ZPAD) * 4


def chain_fits_smem(key: ChainKey) -> bool:
    """Whether chain.cu can run this chain: every width a multiple of 16
    (the tensor-core tile), at most CHAIN_MAXL layers, and the row block's
    activations within one block's shared memory. The chain-fusion pass
    gates on it, in place of the reference's chain_fits_vmem."""
    if len(key.dims) - 1 > CHAIN_MAXL or any(d % 16 for d in key.dims):
        return False
    mxu = reference.mxu_dtype(key.dtype, key.precision)
    return chain_smem_bytes(max(key.dims), mxu) <= SM90_SMEM_OPTIN


# blocked_matmul.cu's B20 holds two of chain.cu's row panels (CHAIN_BM rows
# of K + CHAIN_HPAD) and, on the tensor path, each warp's weight and output
# staging; the kernel's static_assert pins the staging's bytes to this
WARM_STAGING_BYTES = 34816


def blocked_warm_smem_bytes(K: int, mxu: torch.dtype) -> int:
    """Dynamic shared memory B20 asks for at K = Kb * kb (its
    warm_smem_bytes())."""
    h = 2 * CHAIN_BM * (K + CHAIN_HPAD) * (2 if mxu == torch.bfloat16 else 4)
    return (h + 127) // 128 * 128 + \
        (WARM_STAGING_BYTES if mxu == torch.bfloat16 else 0)


def blocked_warm_fits_smem(key: BlockedMatmulKey) -> bool:
    """Whether B20 can run this key's warm bench: square feedback
    (Nb == Kb, nb == kb), K = Kb * kb and nb multiples of 16 (the
    tensor-core tile; a warp's 16 columns inside one Nb block, read as
    16-byte vectors), and the row panel's two buffers within one block's
    shared memory, the same sm_90 opt-in limit the chain gate plans for. The
    executor's extract_bench_kernel gates on it in place of the reference's
    VMEM check (tpp_mlir_tpu/runtime/executor.py:863-870): a key it refuses
    times the loop lowering."""
    K = key.Kb * key.kb
    if key.Nb != key.Kb or key.nb != key.kb or K % 16 or key.nb % 16:
        return False
    mxu = reference.mxu_dtype(key.dtype, key.precision)
    return blocked_warm_smem_bytes(K, mxu) <= SM90_SMEM_OPTIN


class Kernel:
    """A callable for one key: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. `launches` counts CUDA launches only. A key
    with no kernel (launch None: attention's and conv's strategy "xla",
    which the reference leaves to XLA, and xsmm.unary/xsmm.binary, which
    it computes with jnp) runs its plain version on any device and counts
    nothing."""

    def __init__(self, key, launch):
        self.key = key
        self.launches = 0
        self._plain = reference.reference_kernel(key)
        self._launch = launch

    def __call__(self, *args, **kwargs):
        # the first floating-point operand decides (a stacked grouped GEMM
        # takes its layer index first, maybe as an int)
        device = next(a.device for a in args if isinstance(a, torch.Tensor)
                      and a.is_floating_point())
        if device.type == "cpu" or self._launch is None:
            return self._plain(*args, **kwargs)
        if device.type != "cuda":
            raise ValueError(f"no kernel for device {device}")
        with torch.cuda.device(device):
            out = self._launch(*args, **kwargs)
        self.launches += 1
        return out

    @property
    def route(self) -> str | None:
        """The route its launcher chose, None for a key with no kernel."""
        return getattr(self._launch, "route", None)

    @property
    def plan(self):
        """The launch plan captured when the kernel was built: a
        reference.GemmPlan (B1/B2, B19), a reference.WarmPlan (the
        warm-panel engine: B3/B4/B5, B20), or None (no plan to choose)."""
        return getattr(self._launch, "plan", None)

    @property
    def source(self) -> str | None:
        """The csrc/ source of its kernel, None for a key with no kernel."""
        return getattr(self._launch, "source", None)


def _tag(launch, route: str | None, source: str):
    """Record on a launch the route its launcher chose and the csrc/ file
    that runs it (Kernel.route, Kernel.source)."""
    launch.route, launch.source = route, f"tpp_mlir_tpu_torch/csrc/{source}"
    return launch


def _expect(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


_GEMM_ROUTE_CODE = {"fma": 0, "tma": 1, "convert": 2}


@functools.lru_cache(maxsize=None)
def _gemm_plan(device: int, Mb: int, Nb: int, Kb: int, mb: int, nb: int,
               kb: int, flags: int,
               force: tuple[int, int, int]) -> tuple[int, int, int, int]:
    from .build import check, library
    plan = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        check(library().tpp_gemm_plan(Mb, Nb, Kb, mb, nb, kb, flags,
                                      (ctypes.c_int * 3)(*force), plan),
              f"gemm_plan {force}")
    return tuple(plan)


# tpp_gemm_plan's flags (csrc/gemm_sm90.cuh PlanFlag)
_PLAN_LN, _PLAN_STATS_OUT, _PLAN_FMA = 1, 2, 4


def _plan_flags(key: BrgemmKey | BlockedMatmulKey) -> int:
    *_, fma, no_split = reference.gemm_problem(key)
    ln = isinstance(key, BrgemmKey) and key.prologue is not None
    return ((_PLAN_LN if ln else 0) | (_PLAN_STATS_OUT if no_split else 0)
            | (_PLAN_FMA if fma else 0))


def gemm_plan(key: BrgemmKey | BlockedMatmulKey, device: int | None = None,
              force=None) -> tuple[int, int, int, int]:
    """The launch plan of csrc/gemm_sm90.cuh's mainloop for a B1/B2 or B19
    key on a card (default: the current one), as the C++ launcher makes it
    (tpp_gemm_plan): (tile rows, tile columns, k split, workspace bytes).
    `force` is a forced (bm, bn, split), reference.plan_request's by
    default (the key's bm/bn/bk, else the tuning table; zeros: the
    heuristic's). A brgemm key on the "fma" route has 64 x 64 tiles and no
    split; an ln_stats_out key is never split. An illegal plan raises
    ValueError naming the legal set (reference.check_gemm_plan) before the
    card is asked."""
    if force is None:
        force = reference.plan_request(key)
    reference.gemm_plan(key, force)     # raises for an illegal plan
    if device is None:
        device = torch.cuda.current_device()
    Mb, Nb, Kb, mb, nb, kb, _, _ = reference.gemm_problem(key)
    return _gemm_plan(device, Mb, Nb, Kb, mb, nb, kb, _plan_flags(key),
                      tuple(force))


def _launch_plan(key: BrgemmKey | BlockedMatmulKey):
    """The plan a Kernel captures when it is built: the card's
    (gemm_plan: tile, split, workspace bytes) where there is one, else the
    H100's by the Python mirror with the bytes unknown (the CPU runs the
    plain version and launches nothing)."""
    force = reference.plan_request(key)
    if torch.cuda.is_available():
        return gemm_plan(key, force=force)
    return (*reference.gemm_plan(key, force), None)


def _plan_workspace(launch, dev) -> torch.Tensor | None:
    """The workspace a GEMM launch's plan needs (split partials, LayerNorm
    statistics, ln_stats_out row partials), from the caching allocator."""
    n = launch.work_bytes
    return torch.empty(n, dtype=torch.uint8, device=dev) if n else None


def _plan_arg(launch) -> ctypes.Array:
    """The {bm, bn, split, workspace bytes} array a GEMM launch passes: the
    launcher checks it is a plan it runs with this workspace, and never
    plans on its own."""
    return (ctypes.c_longlong * 4)(*launch.plan, launch.work_bytes)


def describe_plan(plan) -> str:
    """A Kernel's plan as --print-mlir kernel and -v print it."""
    if isinstance(plan, reference.WarmPlan):
        return (f"plan rows {plan.rows} cluster {plan.cluster} "
                f"{'resident' if plan.resident else 'streamed'}")
    return f"plan {plan.bm}x{plan.bn} split {plan.split}"


def _native(t: torch.Tensor, name: str, numel: int, dev) -> torch.Tensor:
    """An epilogue operand (C or D) as the kernel reads it: contiguous, in
    its stored dtype where that is f32 or bf16 (widened to f32 in
    registers), so no conversion kernel runs before the GEMM."""
    if t.dtype not in _DT_CODE:
        t = t.float()
    t = t.contiguous()
    if t.numel() != numel or t.device != dev:
        raise ValueError(f"{name} has {t.numel()} elements on {t.device}, "
                         f"expected {numel} on {dev}")
    return t


def _brgemm_launch(key: BrgemmKey):
    from .build import check, library

    B, m, n, k = key.batch, key.m, key.n, key.k
    in_dt = reference.DTYPES[key.dtype]
    mxu = reference.mxu_dtype(key.dtype, key.precision)
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    d_size = {"bcast_col": n, "bcast_row": m, "bcast_scalar": 1,
              "none": m * n}[key.binary_bcast]
    route = reference.brgemm_route(key)
    ln = {None: 0, "layer_norm": 1, "ln_stats": 2}[key.prologue]
    plan = _launch_plan(key)

    def launch(a, b, c=None, d=None, gamma=None, beta=None, mu=None,
               var=None):
        dev = a.device
        if key.vnni:
            _expect(b, "B", (B, k // key.vnni, n, key.vnni), in_dt, dev)
            b = reference.unvnni(b)     # the layout move _unvnni makes
        _expect(a, "A", (B, m, k), in_dt, dev)
        _expect(b, "B", (B, n, k) if key.transpose_b else (B, k, n),
                in_dt, dev)
        if route == "tma" and (a.data_ptr() % 16 or b.data_ptr() % 16):
            raise ValueError(f"brgemm's tma route needs 16-byte aligned A "
                             f"and B: {key}")
        if not key.beta0:
            if tuple(c.shape) != (m, n):
                raise ValueError(f"C has shape {tuple(c.shape)}, expected "
                                 f"{(m, n)}")
            c = _native(c, "C", m * n, dev)
        if key.binary_kind:
            d = _native(d, "D", d_size, dev)
        if ln and key.prologue_affine:
            gamma = gamma.reshape(-1).float().contiguous()
            beta = beta.reshape(-1).float().contiguous()
            _expect(gamma, "gamma", (k,), None, dev)
            _expect(beta, "beta", (k,), None, dev)
        else:
            gamma = beta = None
        if ln == 2:     # the producer's (m, 1) statistics
            if mu is None or var is None:
                raise ValueError(f"the ln_stats prologue needs the "
                                 f"producer's mu and var: {key}")
            mu = mu.reshape(-1).float().contiguous()
            var = var.reshape(-1).float().contiguous()
            _expect(mu, "mu", (m,), None, dev)
            _expect(var, "var", (m,), None, dev)
        # the plan the Kernel records is the plan this launch runs
        work = _plan_workspace(launch, dev)
        out = torch.empty((m, n), dtype=out_dt, device=dev)
        stats = [torch.empty((m, 1), dtype=torch.float32, device=dev)
                 for _ in range(2)] if key.ln_stats_out else [None, None]
        rc = library().tpp_brgemm(
            a.data_ptr(), b.data_ptr(),
            c.data_ptr() if not key.beta0 else None,
            d.data_ptr() if key.binary_kind else None,
            out.data_ptr(), work.data_ptr() if work is not None else None,
            B, m, n, k, _DT_CODE[in_dt], _DT_CODE[mxu], _DT_CODE[out_dt],
            _DT_CODE[c.dtype] if not key.beta0 else 0,
            _DT_CODE[d.dtype] if key.binary_kind else 0,
            int(key.transpose_b), int(not key.beta0),
            _BINARY_CODE[key.binary_kind], _BCAST_CODE[key.binary_bcast],
            _UNARY_CODE[key.unary_kind], int(ln), _GEMM_ROUTE_CODE[route],
            key.prologue_eps,
            gamma.data_ptr() if gamma is not None else None,
            beta.data_ptr() if beta is not None else None,
            mu.data_ptr() if ln == 2 else None,
            var.data_ptr() if ln == 2 else None, int(key.ln_stats_out),
            *(t.data_ptr() if t is not None else None for t in stats),
            _plan_arg(launch), _stream())
        check(rc, f"brgemm {key} {describe_plan(launch.plan)}")
        return (out, *stats) if key.ln_stats_out else out
    launch.plan, launch.work_bytes = reference.GemmPlan(*plan[:3]), plan[3]
    return _tag(launch, route, "brgemm.cu")


_WARM_ROUTES = ("panel", "fma", "wmma")


def _warm_plan(key, route: str, plan):
    """The warm-panel engine's plan on the "panel" route, or None for the
    first design; `plan` forces one (reference.requested_warm_plan's by
    default: the key's bm, else the tuning table, else warm_plan). A plan
    the caller forces on the first design, which has no panel to size
    (`plan`, a ChainKey's bm), raises; a table entry is not read there."""
    if route not in _WARM_ROUTES:
        raise ValueError(f"unknown warm route {route!r}")
    if route != "panel" and (plan or getattr(key, "bm", 0)):
        raise ValueError(f"a warm-panel plan is forced at {key}, which runs "
                         f"the first design ({route})")
    if route != "panel":
        # the first design's body follows the MXU dtype
        body = "fma" if reference.mxu_dtype(key.dtype, key.precision) == \
            torch.float32 else "wmma"
        if route != body:
            raise ValueError(f"the first design runs {body} at {key}")
        return None
    plan = plan or reference.requested_warm_plan(key)
    if plan is None:
        raise ValueError(f"the warm-panel engine has no plan for {key}")
    return plan


def _warm_plan_arg(plan) -> ctypes.Array | None:
    """The plan array the C entries take (rows, cluster, resident, bytes),
    None for the first design."""
    return None if plan is None else (ctypes.c_int * 4)(
        plan.rows, plan.cluster, int(plan.resident), plan.smem)


def warm_max_clusters(rows: int, cluster: int, smem: int) -> int:
    """The card's cudaOccupancyMaxActiveClusters for csrc/warm_panel.cuh at
    a panel of `rows`, clusters of `cluster` blocks and `smem` bytes of
    dynamic shared memory a block (the current device)."""
    from .build import check, library
    n = ctypes.c_int(0)
    check(library().tpp_warm_max_clusters(rows, cluster, smem,
                                          ctypes.byref(n)),
          "warm_max_clusters")
    return n.value


def _chain_launch(key: ChainKey, route: str | None = None, plan=None):
    from .build import check, library

    dims, L = key.dims, len(key.dims) - 1
    in_dt = reference.DTYPES[key.dtype]
    mxu = reference.mxu_dtype(key.dtype, key.precision)
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    bench = key.repeats > 1
    step = 2 if key.has_bias else 1
    route = route or reference.chain_route(key)
    plan = _warm_plan(key, route, plan)
    plan_arg = _warm_plan_arg(plan)

    def launch(x, *wb):
        if not chain_fits_smem(key):
            raise ValueError(f"chain does not fit chain.cu (widths multiple "
                             f"of 16, shared memory): {key}")
        dev = x.device
        _expect(x, "x", (key.m, dims[0]), in_dt, dev)
        if len(wb) != step * L:
            raise ValueError(f"expected {step * L} weight/bias operands, "
                             f"got {len(wb)}")
        ws, bs = [], []
        for li in range(L):
            w = wb[step * li]
            _expect(w, f"W{li}", (dims[li], dims[li + 1]), in_dt, dev)
            w = w.to(mxu)        # the MXU-dtype cast the TPU wrapper makes
            if w.data_ptr() % 32:
                raise ValueError(f"W{li} must be 32-byte aligned")
            ws.append(w)
            if key.has_bias:
                bias = wb[step * li + 1].reshape(-1).float().contiguous()
                _expect(bias, f"b{li}", (dims[li + 1],), None, dev)
                bs.append(bias)
        out = torch.empty((key.m, dims[-1]), dtype=out_dt, device=dev)
        w_ptrs = (ctypes.c_void_p * L)(*[w.data_ptr() for w in ws])
        b_ptrs = (ctypes.c_void_p * L)(*[b.data_ptr() for b in bs])
        c_dims = (ctypes.c_int * (L + 1))(*dims)
        rc = library().tpp_chain(
            x.data_ptr(), out.data_ptr(), w_ptrs, b_ptrs, c_dims, L, key.m,
            _DT_CODE[in_dt], _DT_CODE[mxu], _DT_CODE[out_dt],
            int(key.has_bias), _UNARY_CODE[key.unary_kind],
            _UNARY_CODE[key.last_unary], max(1, key.repeats), int(bench),
            int(key.pingpong and bench), plan_arg, _stream())
        check(rc, f"chain {key}")
        return out
    launch.plan = plan
    return _tag(launch, route, "chain.cu")


ATTENTION_HEAD_DIMS = (32, 64, 128)     # attention.cu's instantiations
CUDA_GRID_YZ = 65535                    # gridDim.y/z limit


def _attention_launch(key: FlashMhaKey):
    route = reference.attention_route(key)
    if route == "xla":
        return None
    if route == "flash_heads":
        return _flash_heads_launch(key)
    from .build import check, library

    B, S, Skv, D = key.batch, key.seq, key.seq_kv, key.head_dim
    H = key.heads or 1                  # the flat layout: one head per row
    E = H * D
    in_dt = reference.DTYPES[key.dtype]
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    shape = (B, S, E) if key.heads else (B, S, D)
    loader = reference.attention_loader(key)
    code = {"tma": 0, "convert": 1 if key.dtype == "f32" else 2,
            "fma": 3}[loader]

    def launch(q, k=None, v=None):
        if D not in ATTENTION_HEAD_DIMS:
            raise ValueError(f"attention.cu takes head_dim in "
                             f"{ATTENTION_HEAD_DIMS}: {key}")
        if B > CUDA_GRID_YZ or H > CUDA_GRID_YZ:
            raise ValueError(f"attention.cu puts the batch and the heads in "
                             f"gridDim.y/z, at most {CUDA_GRID_YZ}: {key}")
        dev = q.device
        if key.qkv_packed:
            # [Q|K|V] column groups of one operand, read in place
            _expect(q, "QKV", (B, S, 3 * E), in_dt, dev)
            ptrs = [q.data_ptr() + g * E * q.element_size()
                    for g in range(3)]
            ld = 3 * E
        else:
            _expect(q, "Q", shape, in_dt, dev)
            _expect(k, "K", shape[:1] + (Skv,) + shape[2:], in_dt, dev)
            _expect(v, "V", shape[:1] + (Skv,) + shape[2:], in_dt, dev)
            ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
            ld = E
        if loader != "fma" and any(p % 16 for p in ptrs):
            raise ValueError(f"attention.cu's {loader} loader needs 16-byte "
                             f"aligned operands: {key}")
        out = torch.empty(shape, dtype=out_dt, device=dev)
        rc = library().tpp_attention(
            *ptrs, out.data_ptr(), B, S, Skv, H, D, ld, _DT_CODE[in_dt],
            code, _DT_CODE[out_dt], int(key.causal), key.repeats,
            key.scale * reference.LOG2E, _stream())
        check(rc, f"attention {key}")
        return out
    return _tag(launch, loader, "attention.cu")


def _flash_heads_launch(key: FlashMhaKey):
    """Strategy "flash_heads" on the token layout: B14's forward on the
    (B, S, H, D) view of (B, S, H*D), which is the same memory."""
    fwd = _flash_train_fwd_launch(reference.flash_heads_key(key))
    B, S, H, D = key.batch, key.seq, key.heads, key.head_dim
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]

    def launch(q, k=None, v=None):
        if key.qkv_packed:      # B14 reads contiguous (B, S, H, D) slabs
            E = H * D
            q, k, v = (q[..., g * E:(g + 1) * E].contiguous()
                       for g in range(3))
        o, _ = fwd(*(x.reshape(B, S, H, D) for x in (q, k, v)))
        return o.reshape(B, S, H * D).to(out_dt)
    launch.route, launch.source = f"flash_heads/{fwd.route}", fwd.source
    return launch


BMM_TILE = 64        # batch_matmul.cu's tiled route: a 64 x 64 output tile


def _batch_matmul_launch(key: BatchMatmulKey):
    """O[b] = f(A[b]) @ B[b] (+ C[b]) on the kernel
    reference.batch_matmul_route chooses: "multi" (one warp per whole
    problem; operands by 16-byte copies, so 16-byte aligned) or "tiled",
    where a problem that fits one tile is one of `group` problems a block
    takes in turn (B22's grouping), as many as keep two blocks for every SM
    of the card."""
    from .build import check, library

    Bt, m, n, k = key.batch, key.m, key.n, key.k
    in_dt = reference.DTYPES[key.dtype]
    mxu = reference.mxu_dtype(key.dtype, key.precision)
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    a_shape = (m, k) if key.lhs_shared else (Bt, m, k)
    route = reference.batch_matmul_route(key)

    def launch(a, b, c=None):
        dev = a.device
        _expect(a, "A", a_shape, in_dt, dev)
        _expect(b, "B", (Bt, k, n), in_dt, dev)
        if not key.beta0:
            c = c.float().contiguous()
            _expect(c, "C", (Bt, m, n), None, dev)
        group = 1
        if route == "multi":
            if any(t.data_ptr() % 16 for t in (a, b) + (
                    () if key.beta0 else (c,))):
                raise ValueError(f"batch_matmul.cu's multi route needs "
                                 f"16-byte aligned operands: {key}")
        else:
            if m <= BMM_TILE and n <= BMM_TILE:
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                group = next(g for g in (8, 4, 2, 1) if Bt // g >= 2 * sms
                             or g == 1)
            if -(-Bt // group) > CUDA_GRID_YZ:
                raise ValueError(f"batch_matmul.cu's tiled route puts the "
                                 f"batch in gridDim.z, at most "
                                 f"{CUDA_GRID_YZ} blocks: {key}")
        out = torch.empty((Bt, m, n), dtype=out_dt, device=dev)
        rc = library().tpp_batch_matmul(
            a.data_ptr(), b.data_ptr(), None if key.beta0 else c.data_ptr(),
            out.data_ptr(), Bt, m, n, k, group, int(key.lhs_shared),
            int(key.softmax_lhs), _DT_CODE[in_dt], _DT_CODE[mxu],
            _DT_CODE[out_dt], int(route == "multi"), _stream())
        check(rc, f"batch_matmul {key}")
        return out
    return _tag(launch, route, "batch_matmul.cu")


LN_ROUTES = ("register", "strided")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its base is not 16-byte aligned (a view
    into another tensor); every torch allocation is aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _layer_norm_launch(key: LayerNormKey, route: str | None = None):
    """B12 on the body reference.layer_norm_route names, or `route` forced
    ("strided", the first design, takes any key). gamma and beta are read
    in their stored dtype (f32 or bf16)."""
    from .build import check, library

    m, n = key.m, key.n
    in_dt = reference.DTYPES[key.dtype]
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    own = reference.layer_norm_route(key)
    route = route or own
    if route not in LN_ROUTES or (route == "register" and own != route):
        raise ValueError(f"layer_norm.cu cannot run {key} on route "
                         f"{route!r} (its own: {own!r})")
    reg = route == "register"

    def launch(x, gamma=None, beta=None):
        dev = x.device
        _expect(x, "x", (m, n), in_dt, dev)
        g_code = 0
        if key.affine:
            gamma = _native(gamma.reshape(-1), "gamma", n, dev)
            beta = _native(beta.reshape(-1), "beta", n, dev).to(gamma.dtype)
            if reg:
                x, gamma, beta = _aligned(x), _aligned(gamma), _aligned(beta)
            g_code = _DT_CODE[gamma.dtype]
        elif reg:
            x = _aligned(x)
        out = torch.empty((m, n), dtype=out_dt, device=dev)
        rc = library().tpp_layer_norm(
            x.data_ptr(), gamma.data_ptr() if key.affine else None,
            beta.data_ptr() if key.affine else None, out.data_ptr(), m, n,
            _DT_CODE[in_dt], _DT_CODE[out_dt], g_code, int(reg), key.eps,
            _stream())
        check(rc, f"layer_norm {key} route {route}")
        return out
    return _tag(launch, route, "layer_norm.cu")


def empty_kernel() -> None:
    """One launch of an empty kernel on the current stream (csrc/
    layer_norm.cu's tpp_empty_kernel): the card's floor for a launch,
    timed from a CUDA graph beside B12."""
    from .build import check, library
    check(library().tpp_empty_kernel(_stream()), "empty kernel")


DECODE_ATTN_HEAD_DIMS = (32, 64, 128)   # decode_attn.cu's instantiations
DECODE_ATTN_MAX_GROUPS = 8
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_DECODE_COUNTS: dict[int, torch.Tensor] = {}


def _decode_counts(dev, n: int) -> torch.Tensor:
    """decode_attn.cu's arrival counters of the split merge on `dev`: n
    int32 zeros, kept for the process (each launch leaves them zero, so a
    captured graph replays right). Grown when a key needs more."""
    counts = _DECODE_COUNTS.get(dev.index)
    if counts is None or counts.numel() < n:
        counts = torch.zeros(n, dtype=torch.int32, device=dev)
        _DECODE_COUNTS[dev.index] = counts
    return counts


def _decode_attn_launch(key: DecodeAttnKey):
    from .build import check, library

    B, H, S, D, G = key.batch, key.heads, key.seq, key.head_dim, key.groups
    q_dt = reference.DTYPES[key.dtype]
    kv_dt = torch.int8 if key.kv_quant else q_dt
    if key.pack2:
        q_shape, slab = (B, H // 2, 2 * D), (B, H // 2, S, 2 * D)
    else:
        q_shape = (B, H, D) if G == 1 else (B, H, G, D)
        slab = (B, H, S, D)
    lead = (key.stacked,) if key.stacked else ()
    chunk, splits = reference.decode_attn_plan(key)

    def launch(q, k, v, pos, li=None, k_s=None, v_s=None):
        if D not in DECODE_ATTN_HEAD_DIMS or G > DECODE_ATTN_MAX_GROUPS:
            raise ValueError(f"decode_attn.cu takes head_dim in "
                             f"{DECODE_ATTN_HEAD_DIMS} and at most "
                             f"{DECODE_ATTN_MAX_GROUPS} groups: {key}")
        dev = q.device
        _expect(q, "q", q_shape, q_dt, dev)
        _expect(k, "K", lead + slab, kv_dt, dev)
        _expect(v, "V", lead + slab, kv_dt, dev)
        if k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError(f"decode_attn.cu's bulk copies need 16-byte "
                             f"aligned K and V: {key}")
        if pos.dtype != torch.int32 or pos.device != dev or \
                pos.numel() != (B if key.slotted else 1):
            raise ValueError(f"pos must be int32 on {dev} with "
                             f"{B if key.slotted else 1} element(s): "
                             f"{tuple(pos.shape)} {pos.dtype} on {pos.device}")
        pos = pos.contiguous()
        if key.kv_quant:
            _expect(k_s, "k_s", lead + (B, H, S), torch.float32, dev)
            _expect(v_s, "v_s", lead + (B, H, S), torch.float32, dev)
        li = int(li) if key.stacked else 0   # a host int: no device read
        if not 0 <= li < max(key.stacked, 1):
            raise ValueError(f"layer {li} outside the stacked cache: {key}")
        out = torch.empty(q_shape, dtype=torch.float32, device=dev)
        work = counts = None
        if splits > 1:   # each split's P.V sums [G][D] and (max, sum)
            work = torch.empty(B * H * splits * G * (D + 2),
                               dtype=torch.float32, device=dev)
            counts = _decode_counts(dev, B * H)
        rc = library().tpp_decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_s.data_ptr() if key.kv_quant else None,
            v_s.data_ptr() if key.kv_quant else None, pos.data_ptr(),
            out.data_ptr(), work.data_ptr() if work is not None else None,
            counts.data_ptr() if counts is not None else None, B, H, S, D,
            G, li, int(key.slotted), int(key.pack2), _DT_CODE[q_dt],
            _KV_CODE[kv_dt], chunk, splits, D ** -0.5, _stream())
        check(rc, f"decode_attn {key}")
        return out
    return _tag(launch, "split", "decode_attn.cu")


INT8_ROUTES = ("wgmma", "wmma")


def _int8_gemm_launch(key: Int8GemmKey, route: str | None = None):
    """B15 on the body reference.int8_gemm_route names, or `route` forced
    ("wmma", the first design). launch(xq, wq, xscale, wscale, bias=None,
    wt=None): Xq (m, k) and Wq (k, n) int8; wt is Wq's K-major (n, k) copy
    (QTensor.qt, made once where the engine places int8-compute weights),
    which the wgmma body reads; without it the wrapper makes one, a
    transposing copy each call. The scales and the bias are read in their
    stored dtype (f32 or bf16) on the wgmma body; the first design takes
    f32 copies."""
    from .build import check, library

    m, n, k = key.m, key.n, key.k
    out_dt = reference.DTYPES[key.out_dtype]
    if route is None and k % 16 == 0:   # else no body: the launch raises
        route = reference.int8_gemm_route(key)
    if route is not None and route not in INT8_ROUTES:
        raise ValueError(f"unknown int8 GEMM route {route!r}")
    plan = reference.int8_gemm_plan(key) if route == "wgmma" else None

    def launch(xq, wq, xscale, wscale, bias=None, wt=None):
        if k % 16:
            raise ValueError(f"int8_gemm.cu needs k a multiple of 16: {key}")
        dev = xq.device
        _expect(xq, "Xq", (m, k), torch.int8, dev)
        _expect(wq, "Wq", (k, n), torch.int8, dev)
        if xq.data_ptr() % 16 or wq.data_ptr() % 16:
            raise ValueError("Xq and Wq must be 16-byte aligned")
        out = torch.empty((m, n), dtype=out_dt, device=dev)
        if route == "wmma":
            xscale = xscale.reshape(-1).float().contiguous()
            wscale = wscale.reshape(-1).float().contiguous()
            _expect(xscale, "xscale", (m,), None, dev)
            _expect(wscale, "wscale", (n,), None, dev)
            if key.has_bias:
                bias = bias.reshape(-1).float().contiguous()
                _expect(bias, "bias", (n,), None, dev)
            rc = library().tpp_int8_gemm(
                xq.data_ptr(), wq.data_ptr(), xscale.data_ptr(),
                wscale.data_ptr(), bias.data_ptr() if key.has_bias else None,
                out.data_ptr(), m, n, k, _UNARY_CODE[key.unary_kind],
                _DT_CODE[out_dt], _stream())
            check(rc, f"int8_gemm {key} route wmma")
            return out
        if wt is None:
            wt = wq.t().contiguous()
        _expect(wt, "Wt", (n, k), torch.int8, dev)
        if wt.data_ptr() % 16:
            raise ValueError("Wt must be 16-byte aligned")
        xscale = _native(xscale.reshape(-1), "xscale", m, dev)
        wscale = _native(wscale.reshape(-1), "wscale", n, dev)
        if key.has_bias:
            bias = _native(bias.reshape(-1), "bias", n, dev)
        work = torch.empty(plan.split * m * n, dtype=torch.int32,
                           device=dev) if plan.split > 1 else None
        plan_arg = (ctypes.c_int * 6)(plan.bm, plan.bn, plan.split,
                                      plan.tiles, plan.grid, plan.smem)
        rc = library().tpp_int8_gemm_wgmma(
            xq.data_ptr(), wt.data_ptr(), xscale.data_ptr(),
            wscale.data_ptr(), bias.data_ptr() if key.has_bias else None,
            out.data_ptr(), work.data_ptr() if work is not None else None,
            m, n, k, _UNARY_CODE[key.unary_kind], _DT_CODE[out_dt],
            _DT_CODE[xscale.dtype], _DT_CODE[wscale.dtype],
            _DT_CODE[bias.dtype] if key.has_bias else 0, plan_arg,
            _stream())
        check(rc, f"int8_gemm {key} route wgmma")
        return out
    return _tag(launch, route, "int8_gemm.cu")


FLASH_TRAIN_HEAD_DIMS = (32, 64, 128)   # flash_train.cu's instantiations


def _flash_train_operands(key: FlashTrainKey, named: dict, dev) -> None:
    """Check (B, S, H, D) operands in the key's dtype and (B, H, S) f32
    statistics, all contiguous on `dev`."""
    if key.head_dim not in FLASH_TRAIN_HEAD_DIMS:
        raise ValueError(f"flash_train.cu takes head_dim in "
                         f"{FLASH_TRAIN_HEAD_DIMS}: {key}")
    B, S, H, D = key.batch, key.seq, key.heads, key.head_dim
    dt = reference.DTYPES[key.dtype]
    for name, t in named.items():
        if name in ("lse2", "delta"):
            _expect(t, name, (B, H, S), torch.float32, dev)
        else:
            _expect(t, name, (B, S, H, D), dt, dev)


def _flash_train_fwd_launch(key: FlashTrainKey):
    """B14 on the kernel reference.flash_train_fwd_route chooses:
    attention.cu's wgmma kernel in its training mode for bf16 (K/V by TMA:
    16-byte aligned operands, the batch in gridDim.y), flash_train.cu's
    f32-FMA forward for f32."""
    from .build import check, library

    B, S, H, D = key.batch, key.seq, key.heads, key.head_dim
    dt = reference.DTYPES[key.dtype]
    route = reference.flash_train_fwd_route(key)

    def launch(q, k, v):
        dev = q.device
        _flash_train_operands(key, {"q": q, "k": k, "v": v}, dev)
        if route == "wgmma" and (B > CUDA_GRID_YZ or any(
                t.data_ptr() % 16 for t in (q, k, v))):
            raise ValueError(f"attention.cu's training mode needs 16-byte "
                             f"aligned operands and a batch of at most "
                             f"{CUDA_GRID_YZ}: {key}")
        o = torch.empty((B, S, H, D), dtype=dt, device=dev)
        lse2 = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        rc = library().tpp_flash_train_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse2.data_ptr(), B, S, H, D, _DT_CODE[dt], int(key.causal),
            key.scale * reference.LOG2E, int(route == "wgmma"), _stream())
        check(rc, f"flash_train_fwd {key}")
        return o, lse2
    # bf16's wgmma kernel is attention.cu's training mode
    return _tag(launch, route, "attention.cu" if route == "wgmma"
                else "flash_train.cu")


def _flash_train_bwd_launch(key: FlashTrainBwdKey):
    """B18 on the kernels reference.flash_train_bwd_route chooses:
    flash_train.cu's two wgmma passes for bf16 (Q/K/V/dO and the
    statistics by TMA: 16-byte aligned operands, the batch in gridDim.y;
    the tensor maps are encoded once a call), its two f32-FMA passes for
    f32."""
    from .build import check, library

    B, S, H, D = key.batch, key.seq, key.heads, key.head_dim
    dt = reference.DTYPES[key.dtype]
    route = reference.flash_train_bwd_route(key)

    def launch(q, k, v, do, lse2, delta):
        dev = q.device
        _flash_train_operands(key, {"q": q, "k": k, "v": v, "do": do,
                                    "lse2": lse2, "delta": delta}, dev)
        if route == "wgmma" and (B > CUDA_GRID_YZ or any(
                t.data_ptr() % 16 for t in (q, k, v, do, lse2, delta))):
            raise ValueError(f"flash_train.cu's wgmma backward needs 16-byte "
                             f"aligned operands and a batch of at most "
                             f"{CUDA_GRID_YZ}: {key}")
        dq, dk, dv = (torch.empty((B, S, H, D), dtype=dt, device=dev)
                      for _ in range(3))
        rc = library().tpp_flash_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, H, D, _DT_CODE[dt], int(key.causal),
            key.scale * reference.LOG2E, key.scale, int(route == "wgmma"),
            _stream())
        check(rc, f"flash_train_bwd {key}")
        return dq, dk, dv
    return _tag(launch, route, "flash_train.cu")


_GROUPED_ROUTE_CODE = {"wmma": 0, "wgmma": 1}


def _grouped_gemm_launch(key: GroupedGemmKey, route: str | None = None):
    """B16 on the tile reference.grouped_gemm_route chooses, or on `route`
    where a caller forces one (chip_smoke.py times the WMMA tile at keys
    the route sends to wgmma)."""
    from .build import check, library

    G, L, m, n, k, bm = (key.n_groups, key.layers, key.m, key.n, key.k,
                         key.bm)
    in_dt = reference.DTYPES[key.dtype]
    mxu = reference.mxu_dtype(key.dtype, key.precision)
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    w_shape = ((L,) if L else ()) + (G,) + ((n, k) if key.transpose_b
                                           else (k, n))

    def launch(*args):
        chosen = reference.grouped_gemm_route(key)
        if route == "wgmma" and chosen != "wgmma":
            raise ValueError(f"the wgmma tile cannot take {key}")
        li, (ge, a, b) = (args[0], args[1:]) if L else (None, args)
        dev = a.device
        _expect(ge, "ge", (m // bm,), torch.int32, dev)
        _expect(a, "A", (m, k), in_dt, dev)
        _expect(b, "B", w_shape, in_dt, dev)
        if L:
            if not isinstance(li, torch.Tensor):   # a host int: checked here
                if not 0 <= li < L:
                    raise ValueError(f"layer {li} outside the table: {key}")
                li = torch.full((1,), li, dtype=torch.int32, device=dev)
            li = li.reshape(1)     # a device int, read by the kernel
            _expect(li, "li", (1,), torch.int32, dev)
        out = torch.empty((m, n), dtype=out_dt, device=dev)
        rc = library().tpp_grouped_gemm(
            a.data_ptr(), b.data_ptr(), ge.data_ptr(),
            li.data_ptr() if L else None, out.data_ptr(), G, L, m, n, k, bm,
            _DT_CODE[in_dt], _DT_CODE[mxu], _DT_CODE[out_dt],
            int(key.transpose_b), _UNARY_CODE[key.unary_kind],
            _GROUPED_ROUTE_CODE[route or chosen], _stream())
        check(rc, f"grouped_gemm {key}")
        return out
    try:
        own = reference.grouped_gemm_route(key)
    except ValueError:      # a bm with no tile: the launch raises
        own = None
    return _tag(launch, route or own, "grouped_gemm.cu")


def _grouped_wgrad_launch(key: GroupedWgradKey, route: str | None = None):
    """xt (k, m) is read through its strides: the transpose of a contiguous
    (m, k) tensor goes in as it is, with no copy. The tile is the one
    reference.grouped_wgrad_route chooses from the key and xt's strides, or
    `route` where a caller forces one (chip_smoke.py times the WMMA tile at
    keys the route sends to wgmma)."""
    from .build import check, library

    G, m, k, n, bm = key.n_groups, key.m, key.k, key.n, key.bm
    in_dt = reference.DTYPES[key.dtype]
    mxu = reference.mxu_dtype(key.dtype, key.precision)

    def launch(ge, xt, dy):
        dev = dy.device
        _expect(ge, "ge", (m // bm,), torch.int32, dev)
        _expect(dy, "dY", (m, n), in_dt, dev)
        if xt.device != dev or tuple(xt.shape) != (k, m) or \
                xt.dtype != in_dt:
            raise ValueError(f"xt is {tuple(xt.shape)} {xt.dtype} on "
                             f"{xt.device}, expected {(k, m)} {in_dt} on "
                             f"{dev}")
        chosen = reference.grouped_wgrad_route(key, xt.stride())
        if route == "wgmma" and chosen != "wgmma":
            raise ValueError(f"the wgmma tile cannot take {key} with xt "
                             f"strides {xt.stride()}")
        if (route or chosen) == "wgmma" and \
                any(t.data_ptr() % 16 for t in (xt, dy)):
            raise ValueError(f"the wgmma tile needs 16-byte aligned xt and "
                             f"dY: {key}")
        launch.route = route or chosen
        out = torch.empty((G, k, n), dtype=torch.float32, device=dev)
        rc = library().tpp_grouped_wgrad(
            xt.data_ptr(), dy.data_ptr(), ge.data_ptr(), out.data_ptr(), G, m,
            k, n, bm, *xt.stride(), _DT_CODE[in_dt], _DT_CODE[mxu],
            _GROUPED_ROUTE_CODE[route or chosen], _stream())
        check(rc, f"grouped_wgrad {key}")
        return out
    # the tile follows xt's strides: the last call's is recorded
    return _tag(launch, route or "by xt's strides", "grouped_gemm.cu")


_CONV_ROUTE_CODE = {"fma": 0, "tma": 1, "convert": 2, "wmma": 3}


def _conv_route(key, route: str | None) -> str:
    """The key's own route (reference.conv_kernel_route), or `route` forced:
    "wmma" (the tile body) for any key with bf16 products."""
    own = reference.conv_kernel_route(key)
    if route is None or route == own:
        return own
    if route != "wmma" or own == "fma":
        raise ValueError(f"conv.cu cannot run {key} on route {route!r} (its "
                         f"own: {own!r}; only 'wmma' may be forced, for bf16 "
                         f"products)")
    return route


def _conv_call(key, route: str, fn, i, w, c, d, out, geometry):
    """One launch of csrc/conv.cu's entry `fn` (tpp_conv_nhwc or
    tpp_conv_blocked) on the route: C and D read in their stored dtype
    (_native), the wgmma routes at conv_plan's tile and split with the
    split partials in a workspace."""
    from .build import check

    dev = i.device
    n_out = out.numel()
    in_dt = reference.DTYPES[key.dtype]
    mxu = reference.mxu_dtype(key.dtype, key.precision)
    if not key.beta0:
        if tuple(c.shape) != tuple(out.shape):
            raise ValueError(f"C has shape {tuple(c.shape)}, expected "
                             f"{tuple(out.shape)}")
        c = _native(c, "C", n_out, dev)
    if key.binary_kind:   # a full residual, or a bias of the K columns
        d = _native(d.reshape(-1), "D", n_out if key.binary_bcast == "none"
                    else n_out // (key.N * key.P * key.Q), dev)
    bm, bn, split = reference.conv_plan(key) \
        if route in ("tma", "convert") else (64, 64, 1)
    if route in ("tma", "convert") and (i.data_ptr() % 16 or
                                        w.data_ptr() % 16):
        raise ValueError(f"conv.cu's {route} route needs 16-byte aligned I "
                         f"and W: {key}")
    work = torch.empty(split * n_out, dtype=torch.float32, device=dev) \
        if split > 1 else None
    rc = fn(i.data_ptr(), w.data_ptr(), None if key.beta0 else c.data_ptr(),
            d.data_ptr() if key.binary_kind else None, out.data_ptr(),
            work.data_ptr() if work is not None else None, *geometry,
            _DT_CODE[in_dt], _DT_CODE[mxu], _DT_CODE[out.dtype],
            0 if key.beta0 else _DT_CODE[c.dtype],
            _DT_CODE[d.dtype] if key.binary_kind else 0, int(not key.beta0),
            _BINARY_CODE[key.binary_kind], _BCAST_CODE[key.binary_bcast],
            _UNARY_CODE[key.unary_kind], _CONV_ROUTE_CODE[route], bm, bn,
            split, _stream())
    check(rc, f"conv {key} route {route}")
    return out


def _conv_launch(key: ConvNhwcKey, route: str | None = None):
    """csrc/conv.cu for the stride-1 routes (reference.conv_kernel_route,
    or `route` forced); None (the plain version on any device, counting
    nothing) for the xla route."""
    if reference.conv_route(key) == "xla":
        return None
    from .build import library

    N, H, W, C, K, P, Q = key.N, key.H, key.W, key.C, key.K, key.P, key.Q
    in_dt = reference.DTYPES[key.dtype]
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    route = _conv_route(key, route)

    def launch(i, w, c=None, d=None):
        dev = i.device
        _expect(i, "I", (N, H, W, C), in_dt, dev)
        _expect(w, "W", (key.R, key.S, C, K), in_dt, dev)
        out = torch.empty((N, P, Q, K), dtype=out_dt, device=dev)
        return _conv_call(key, route, library().tpp_conv_nhwc, i, w, c, d,
                          out, (N, H, W, C, K, key.R, key.S, key.pad[0],
                                key.pad[2], P, Q))
    return _tag(launch, route, "conv.cu")


def _blocked_matmul_launch(key: BlockedMatmulKey, warm: str | None = None,
                           plan=None):
    """B19, or with repeats B20, on packed operands: a [Mb,Kb,mb,kb],
    b [Nb,Kb,kb,nb] (VNNI [Nb,Kb,kb/2,nb,2], read in place by the kernel),
    c [Mb,Nb,mb,nb] unless beta_0 (B20 takes none), d the bias with Nb*nb
    elements; the output is [Mb,Nb,mb,nb]. B19 takes the loader
    reference.blocked_matmul_route names and reads C and the bias in their
    stored dtype; B20 reads an f32 bias and takes the body
    reference.warm_route names (or `warm`, forced)."""
    from .build import check, library

    Mb, Nb, Kb, mb, nb, kb = key.Mb, key.Nb, key.Kb, key.mb, key.nb, key.kb
    in_dt = reference.DTYPES[key.dtype]
    mxu = reference.mxu_dtype(key.dtype, key.precision)
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    v = key.vnni
    b_shape = (Nb, Kb, kb // v, nb, v) if v else (Nb, Kb, kb, nb)
    has_c = not key.beta0 and not key.repeats
    route = reference.blocked_matmul_route(key)
    if key.repeats:
        plan = _warm_plan(key, warm or reference.warm_route(key), plan)
        gemm = None
    else:
        gemm = _launch_plan(key)
    plan_arg = _warm_plan_arg(plan) if key.repeats else None

    def launch(a, b, c=None, d=None):
        if key.repeats and not blocked_warm_fits_smem(key):
            raise ValueError(f"the blocked warm bench does not fit "
                             f"blocked_matmul.cu (square feedback, K a "
                             f"multiple of 16, shared memory): {key}")
        dev = a.device
        _expect(a, "A", (Mb, Kb, mb, kb), in_dt, dev)
        _expect(b, "B", b_shape, in_dt, dev)
        if key.repeats and b.data_ptr() % 16:
            raise ValueError("B must be 16-byte aligned for the warm bench")
        if route == "tma" and (a.data_ptr() % 16 or b.data_ptr() % 16):
            raise ValueError(f"blocked_matmul's tma route needs 16-byte "
                             f"aligned A and B: {key}")
        if has_c:
            if tuple(c.shape) != (Mb, Nb, mb, nb):
                raise ValueError(f"C has shape {tuple(c.shape)}, expected "
                                 f"{(Mb, Nb, mb, nb)}")
            c = _native(c, "C", Mb * Nb * mb * nb, dev)
        if key.binary_kind:
            d = d.reshape(-1).float() if key.repeats else d.reshape(-1)
            d = _native(d, "D", Nb * nb, dev)
        work = None if key.repeats else _plan_workspace(launch, dev)
        out = torch.empty((Mb, Nb, mb, nb), dtype=out_dt, device=dev)
        rc = library().tpp_blocked_matmul(
            a.data_ptr(), b.data_ptr(), c.data_ptr() if has_c else None,
            d.data_ptr() if key.binary_kind else None, out.data_ptr(),
            work.data_ptr() if work is not None else None, Mb, Nb, Kb, mb,
            nb, kb, v, _DT_CODE[in_dt], _DT_CODE[mxu], _DT_CODE[out_dt],
            _DT_CODE[c.dtype] if has_c else 0,
            _DT_CODE[d.dtype] if key.binary_kind else 0, int(has_c),
            _BINARY_CODE[key.binary_kind], _UNARY_CODE[key.unary_kind],
            key.repeats, _GEMM_ROUTE_CODE.get(route, 0),
            None if key.repeats else _plan_arg(launch), plan_arg,
            _stream())
        check(rc, f"blocked_matmul {key}")
        return out
    if key.repeats:
        launch.plan = plan
    else:
        launch.plan, launch.work_bytes = reference.GemmPlan(*gemm[:3]), \
            gemm[3]
    return _tag(launch, warm or reference.warm_route(key) if key.repeats
                else route, "blocked_matmul.cu")


def _conv_blocked_launch(key: ConvBrgemmKey, route: str | None = None):
    """B23 on the channel-blocked layout: i [N,Cb,H,W,c], w
    [Kb,Cb,R,S,c,k], c [N,Kb,P,Q,k] unless beta_0, d the bias with Kb*k
    elements; the output is [N,Kb,P,Q,k]. Stride 1 only (check_slice
    raises in the reference's words for a stride). The route is
    reference.conv_kernel_route's, or `route` forced."""
    from .build import library

    N, H, W, Cb, cb, Kb, kb = key.N, key.H, key.W, key.Cb, key.c, key.Kb, \
        key.k
    P, Q = key.P, key.Q
    in_dt = reference.DTYPES[key.dtype]
    out_dt = reference.DTYPES[key.out_dtype or key.dtype]
    route = _conv_route(key, route)

    def launch(i, w, c=None, d=None):
        dev = i.device
        _expect(i, "I", (N, Cb, H, W, cb), in_dt, dev)
        _expect(w, "W", (Kb, Cb, key.R, key.S, cb, kb), in_dt, dev)
        out = torch.empty((N, Kb, P, Q, kb), dtype=out_dt, device=dev)
        return _conv_call(key, route, library().tpp_conv_blocked, i, w, c,
                          d, out, (N, H, W, Cb, cb, Kb, kb, key.R, key.S, P,
                                   Q))
    return _tag(launch, route, "conv.cu")


_LAUNCHES = {BrgemmKey: _brgemm_launch, ChainKey: _chain_launch,
             BatchMatmulKey: _batch_matmul_launch,
             FlashMhaKey: _attention_launch,
             LayerNormKey: _layer_norm_launch,
             DecodeAttnKey: _decode_attn_launch,
             Int8GemmKey: _int8_gemm_launch,
             FlashTrainKey: _flash_train_fwd_launch,
             FlashTrainBwdKey: _flash_train_bwd_launch,
             GroupedGemmKey: _grouped_gemm_launch,
             GroupedWgradKey: _grouped_wgrad_launch,
             ConvNhwcKey: _conv_launch,
             BlockedMatmulKey: _blocked_matmul_launch,
             ConvBrgemmKey: _conv_blocked_launch,
             # xsmm.unary / xsmm.binary: jnp in the reference
             # (kernels.py:3315-3345 there), PyTorch ops here: no launch
             UnaryKey: lambda key: None, BinaryKey: lambda key: None}


def build_kernel(key) -> Kernel:
    reference.check_slice(key)
    return Kernel(key, _LAUNCHES[type(key)](key))


def build_conv(key: ConvNhwcKey | ConvBrgemmKey, route: str) -> Kernel:
    """csrc/conv.cu with its body forced to `route` (its own, or "wmma" for
    a key with bf16 products), for timing the tile body beside the wgmma
    kernel; build_kernel takes reference.conv_kernel_route's choice."""
    reference.check_slice(key)
    launch = _conv_blocked_launch if isinstance(key, ConvBrgemmKey) \
        else _conv_launch
    return Kernel(key, launch(key, route))


def build_warm(key: ChainKey | BlockedMatmulKey, route: str,
               plan: reference.WarmPlan | None = None) -> Kernel:
    """csrc/chain.cu (B3/B4/B5) or B20 with its body forced to `route`
    ("panel": the warm-panel engine, on `plan` or reference.warm_plan's;
    "wmma" or "fma": the first design), for timing and testing the two
    side by side; build_kernel takes reference.chain_route's /
    warm_route's choice."""
    reference.check_slice(key)
    if isinstance(key, ChainKey):
        return Kernel(key, _chain_launch(key, route, plan))
    if not key.repeats:
        raise ValueError(f"B19 has no warm body: {key}")
    return Kernel(key, _blocked_matmul_launch(key, route, plan))


def build_int8(key: Int8GemmKey, route: str) -> Kernel:
    """B15 with its body forced to `route` ("wgmma", or "wmma": the first
    design), for timing the two side by side and holding them bit-equal;
    build_kernel takes reference.int8_gemm_route's choice."""
    reference.check_slice(key)
    return Kernel(key, _int8_gemm_launch(key, route))


def build_layer_norm(key: LayerNormKey, route: str) -> Kernel:
    """B12 with its body forced to `route` ("register" where
    reference.layer_norm_route allows it, or "strided": the first design),
    for timing the two side by side."""
    reference.check_slice(key)
    return Kernel(key, _layer_norm_launch(key, route))


def build_grouped_gemm(key: GroupedGemmKey | GroupedWgradKey,
                       route: str) -> Kernel:
    """B16 or B17 with its tile forced to `route` ("wgmma" or "wmma"), for
    timing the two side by side; build_kernel takes the route's own
    choice."""
    if route not in _GROUPED_ROUTE_CODE:
        raise ValueError(f"unknown grouped GEMM route {route!r}")
    reference.check_slice(key)
    launch = _grouped_wgrad_launch if isinstance(key, GroupedWgradKey) \
        else _grouped_gemm_launch
    return Kernel(key, launch(key, route))
