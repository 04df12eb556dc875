"""Kernel-cache keys of the port's slice.

Field-for-field copies of `tpp_mlir_tpu/xsmm/flags.py` (BrgemmKey,
BlockedMatmulKey, BatchMatmulKey, ChainKey, ConvBrgemmKey, ConvNhwcKey, FlashMhaKey,
GroupedGemmKey, GroupedWgradKey, LayerNormKey, UnaryKey, BinaryKey,
Int8GemmKey), of
`tpp_mlir_tpu/xsmm/decode_attn.py` (DecodeAttnKey) and of
`tpp_mlir_tpu/xsmm/flash_train.py` (FlashTrainKey, without `hpp`). The port
imports nothing of the JAX package, so it keeps its own copies.
`tests/test_torch_flags.py` pins every field name and default to the
originals, so the two backends keep one key contract.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BrgemmKey:
    """Key for gemm/brgemm/fused_brgemm kernels (gemm == batch 1)."""

    batch: int
    m: int
    n: int
    k: int
    dtype: str = "f32"
    out_dtype: str | None = None
    beta0: bool = False            # GemmFlags BETA_0: ignore C, start at 0
    vnni: int = 0                  # 0 = flat B [b,k,n]; 2/4 = VNNI [b,k/v,n,v]
    transpose_b: bool = False      # B given as [b,n,k]
    binary_kind: str | None = None  # fused epilogue binary (bias add, ...)
    binary_bcast: str = "bcast_col"  # broadcast of the D operand
    unary_kind: str | None = None   # fused epilogue unary (relu, ...)
    # "default" = bf16 operands with f32 accumulation; "highest" = f32 FMA
    precision: str = "default"
    bm: int = 0                    # block-size overrides (0 = heuristic)
    bn: int = 0
    bk: int = 0
    # LayerNorm A-row prologue and per-row output statistics (queue A6)
    prologue: str | None = None
    prologue_affine: bool = True
    prologue_eps: float = 1e-5
    ln_stats_out: bool = False


@dataclass(frozen=True)
class BlockedMatmulKey:
    """Key for the packed-layout matmul (packed parity mode)
    C[Mb,Nb,mb,nb] += A[Mb,Kb,mb,kb] * B[Nb,Kb,kb,nb]: csrc/blocked_matmul.cu
    (B19; with repeats, B20)."""

    Mb: int
    Nb: int
    Kb: int
    mb: int
    nb: int
    kb: int
    dtype: str = "f32"
    out_dtype: str | None = None
    beta0: bool = False
    vnni: int = 0                  # B packed [Nb,Kb,kb/v,nb,v]
    binary_kind: str | None = None
    binary_bcast: str = "bcast_col"
    unary_kind: str | None = None
    precision: str = "default"
    # > 0: the in-kernel perf.bench timed region (B20): `repeats`
    # applications with the output fed back as the next packed activation
    # (Nb == Kb and nb == kb)
    repeats: int = 0


@dataclass(frozen=True)
class BatchMatmulKey:
    """Key for the parallel-batch matmul O[b] = f(A[b]) @ B[b] (+ C[b])
    (tl.batch_matmul, xsmm.batch_gemm)."""

    batch: int
    m: int
    n: int
    k: int
    dtype: str = "f32"
    out_dtype: str | None = None
    beta0: bool = False
    # f = the row softmax over k, in f32 (the softmax(scores) @ V kernel)
    softmax_lhs: bool = False
    # A is one rank-2 (m, k) operand shared by every batch element
    lhs_shared: bool = False
    precision: str = "default"
    bm: int = 0
    bn: int = 0
    bk: int = 0


@dataclass(frozen=True)
class ChainKey:
    """Key for the whole-chain fused MLP kernel:
    act(...act(act(x@W1+b1)@W2+b2)...) in one launch."""

    m: int
    dims: tuple[int, ...]          # (k0, n1, ..., nL)
    dtype: str = "f32"
    out_dtype: str | None = None
    has_bias: bool = True
    unary_kind: str | None = "relu"   # activation after every layer
    last_unary: str | None = "relu"   # activation after the final layer
    precision: str = "default"
    bm: int = 0                       # M block (0 = heuristic)
    # repeats > 1 = the perf.bench timed region runs inside the kernel: the
    # chain is applied `repeats` times with the output fed back as input.
    # Requires dims[0] == dims[-1].
    repeats: int = 1
    # warm bench of a non-square single-layer fc (B5): with repeats > 1,
    # odd repeats contract the state with the same W on its n axis
    pingpong: bool = False


@dataclass(frozen=True)
class ConvBrgemmKey:
    """Key for the NCHW channel-blocked conv as batch-reduce GEMM
    O[N,Kb,P,Q,k] += sum_{Cb,R,S} I[N,Cb,h+r,w+s,c] * W[Kb,Cb,R,S,c,k]
    (packed parity mode; csrc/conv.cu's channel-blocked entry, B23;
    stride 1 only, as in the reference)."""

    N: int
    H: int
    W: int
    Cb: int
    c: int
    Kb: int
    k: int
    R: int = 1
    S: int = 1
    stride_h: int = 1
    stride_w: int = 1
    dtype: str = "f32"
    out_dtype: str | None = None
    beta0: bool = False
    binary_kind: str | None = None
    binary_bcast: str = "bcast_col"
    unary_kind: str | None = None
    precision: str = "default"

    @property
    def P(self) -> int:
        return (self.H - self.R) // self.stride_h + 1

    @property
    def Q(self) -> int:
        return (self.W - self.S) // self.stride_w + 1


@dataclass(frozen=True)
class ConvNhwcKey:
    """Key for the NHWC conv I[N,H,W,C] * W[R,S,C,K] -> O[N,P,Q,K] with a
    fused zero padding and epilogue: unary(C + conv (+) D). `G`, `cblk` and
    `kblk` are the TPU kernels' VMEM blocking; csrc/conv.cu takes them and
    uses its own tiles. `strategy` names the TPU kernel asked for ("window"
    B24, "fullrow" B25, "xla", "auto"); reference.conv_route says what the
    port runs for each."""

    N: int
    H: int
    W: int
    C: int
    K: int
    R: int = 1
    S: int = 1
    stride_h: int = 1
    stride_w: int = 1
    dtype: str = "f32"
    out_dtype: str | None = None
    beta0: bool = False
    binary_kind: str | None = None
    binary_bcast: str = "bcast_col"
    unary_kind: str | None = None
    precision: str = "default"
    G: int = 0                 # images per TPU program (0 = heuristic)
    cblk: int = 0              # input-channel block (0 = heuristic)
    kblk: int = 0              # output-channel block (0 = heuristic)
    strategy: str = "auto"
    # zero padding fused into the conv (h_lo, h_hi, w_lo, w_hi)
    pad: tuple[int, int, int, int] = (0, 0, 0, 0)

    @property
    def P(self) -> int:
        return (self.H + self.pad[0] + self.pad[1] - self.R) \
            // self.stride_h + 1

    @property
    def Q(self) -> int:
        return (self.W + self.pad[2] + self.pad[3] - self.S) \
            // self.stride_w + 1


@dataclass(frozen=True)
class FlashMhaKey:
    """Key for the fused attention kernel softmax(Q K^T * scale) V."""

    batch: int                 # batch * heads (flat), or the batch (tokens)
    seq: int
    seq_kv: int
    head_dim: int
    dtype: str = "f32"
    out_dtype: str | None = None
    scale: float = 1.0
    causal: bool = False
    precision: str = "default"
    bq: int = 0                # query block (0 = heuristic)
    bk: int = 0                # key/value block
    # the TPU kernel a key asks for; on the card (reference.attention_route):
    # flat auto/grouped/qblock/twocall/twocall2 and token auto/tokens run
    # csrc/attention.cu, token flash_heads B14 (csrc/flash_train.cu), token
    # xla the composed PyTorch attention; every other pair raises
    strategy: str = "auto"
    repeats: int = 0           # > 0: the in-kernel warm bench (B11)
    # heads > 0: token layout (batch, seq, heads*head_dim); 0: flat layout
    # (batch*heads, seq, head_dim)
    heads: int = 0
    # one (batch, seq, 3*heads*head_dim) operand holding [Q | K | V]
    qkv_packed: bool = False


@dataclass(frozen=True)
class LayerNormKey:
    """Key for the row LayerNorm kernel (two-pass f32 statistics)."""

    m: int                     # tokens (rows)
    n: int                     # features (normalized dim)
    dtype: str
    out_dtype: str | None = None
    affine: bool = True        # gamma/beta operands present
    eps: float = 1e-5
    precision: str = "default"


@dataclass(frozen=True)
class GroupedGemmKey:
    """Key for the grouped (ragged-batch) GEMM

        O[i*bm:(i+1)*bm] = unary(A[i*bm:(i+1)*bm] @ B[ge[i]])

    A (m, k) holds rows sorted by group, each group's rows padded to a
    multiple of bm; B (n_groups, k, n), or (n_groups, n, k) under
    transpose_b (the dgrad dy @ w[ge]^T); ge (m // bm,) int32 is the
    block -> group map, read on the device, so one kernel serves every
    routing. layers > 0: B is the stacked (layers, n_groups, ., .) table
    and the call takes the layer index first: fn(li, ge, a, b)."""

    n_groups: int
    m: int                         # padded rows; m % bm == 0
    n: int
    k: int
    dtype: str = "f32"
    out_dtype: str | None = None
    unary_kind: str | None = None  # fused epilogue (gelu for MoE FFN1)
    precision: str = "default"
    bm: int = 128                  # row block = the group padding quantum
    bn: int = 0
    bk: int = 0
    layers: int = 0
    transpose_b: bool = False


@dataclass(frozen=True)
class GroupedWgradKey:
    """Key for the grouped weight gradient

        dW[g] = sum_{i : ge[i] == g} A[i*bm:(i+1)*bm].T @ dY[i*bm:(i+1)*bm]

    A arrives transposed as (k, m), rows sorted by group (the grouped
    forward's layout, so ge is non-decreasing); dW is f32 (n_groups, k, n).
    A group that owns no block gets zeros."""

    n_groups: int
    m: int                          # padded rows; m % bm == 0
    k: int                          # A rows (input features)
    n: int                          # dY cols (output features)
    dtype: str = "f32"
    precision: str = "default"
    bm: int = 128
    bn: int = 0


@dataclass(frozen=True)
class UnaryKey:
    kind: str                      # identity/zero/relu/transpose/vnni2/...
    shape: tuple[int, ...]
    dtype: str
    out_shape: tuple[int, ...] | None = None
    out_dtype: str | None = None
    bcast: str = "none"
    perm: tuple[int, ...] | None = None
    vnni: int = 2


@dataclass(frozen=True)
class BinaryKey:
    kind: str                      # add/mul/sub/div/max
    shape_a: tuple[int, ...]
    shape_b: tuple[int, ...]
    dtype: str
    out_dtype: str | None = None
    bcast_a: str = "none"
    bcast_b: str = "none"


@dataclass(frozen=True)
class DecodeAttnKey:
    """Key for the single-token (T=1) decode-attention kernel (a copy of
    `tpp_mlir_tpu/xsmm/decode_attn.py:33`, whose module imports JAX)."""

    batch: int
    heads: int          # KV heads (== query heads when groups == 1)
    seq: int
    head_dim: int
    dtype: str = "bf16"
    slotted: bool = False          # pos is (B,) per row instead of a scalar
    groups: int = 1                # GQA: query heads per KV head
    stacked: int = 0               # K/V are the full (L, B, H, S, D) cache
    kv_quant: bool = False         # int8 K/V with (L, B, H, S) f32 scales
    pack2: bool = False            # two heads per (H/2, S, 2D) cache row


@dataclass(frozen=True)
class Int8GemmKey:
    """Key for the int8 compute GEMM
    O = unary((Xq @ Wq) * xscale[m] * wscale[n] [+ bias]): s8 x s8 -> s32,
    dequantized once on the f32 accumulator."""

    m: int
    n: int
    k: int
    out_dtype: str = "f32"
    unary_kind: str | None = None
    has_bias: bool = False
    bm: int = 0
    bn: int = 0
    bk: int = 0


@dataclass(frozen=True)
class FlashTrainKey:
    """Key of the training-attention pair (a copy of
    `tpp_mlir_tpu/xsmm/flash_train.py:51`): the forward with the base-2
    log-sum-exp (B14) under this type, the backward (B18) under
    FlashTrainBwdKey. `hpp` (heads per TPU program, sized to VMEM) is left
    out: a Hopper block holds one head's tiles."""

    batch: int
    heads: int
    seq: int
    head_dim: int
    dtype: str = "bf16"          # operand dtype: f32 | bf16
    causal: bool = True
    scale: float = 1.0


@dataclass(frozen=True)
class FlashTrainBwdKey(FlashTrainKey):
    """FlashTrainKey's fields for the backward kernel: its own type, so that
    the kernel cache and the launch counts keep B14 and B18 apart."""
