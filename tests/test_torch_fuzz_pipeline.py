"""The JAX package's differential pipeline fuzzer, run on the port.

Seeded random `tl` graphs (a copy of the generator of
tests/integration/test_fuzz_pipeline.py: random op mixes over a small
shape vocabulary, baited with the patterns the fold and fuse passes
rewrite: residual diamonds through accumulating matmul dests, trailing
unaries, reshapes and transposes between a contraction and its epilogue,
multi-consumer values, returned intermediates, softmaxes, and convs on
every lowering path) go through the port's default-tpp-passes, -flat and
-packed and run on the CPU (the kernels' plain versions) against the
port's --linalg-to-loops of the same text and against the JAX package's
run of it. Any semantics-changing rewrite shows as a numeric mismatch.
The patchify pipeline of the original is not ported (ROADMAP, "Not to
port").

f32 graphs run at precision "highest" (true f32 on both sides, so a
rewrite that changes the math cannot hide inside f32 "default"'s bf16
operand rounding) at the original's f32 tolerance, atol = rtol = 2e-4;
bf16 graphs at its bf16 tolerance, atol 0.3, rtol 0.08. Inputs are
seeded numpy normals, rounded to bf16 the same way on both sides.
`test_fuzzer_catches_dropped_epilogue` plants the original's canary bug (an
elementwise xsmm.unary dropped after lowering) and holds the corpus to
catching it.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpp_mlir_tpu.ir import parse_module as jax_parse_module
from tpp_mlir_tpu.runtime import compile as jax_compile
from tpp_mlir_tpu_torch.ir import parse_module
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.runtime import compile as port_compile

DIMS = (16, 32, 64)
UNARIES = ("relu", "gelu", "tanh", "square", "negate")
BINARIES = ("add", "mul", "sub", "max")
PIPELINES = (("default-tpp-passes",),
             ("default-tpp-passes-flat",),
             ("default-tpp-passes-packed",))
SEEDS = 48
TOL = {"f32": dict(atol=2e-4, rtol=2e-4), "bf16": dict(atol=0.3, rtol=0.08)}


class _Gen:
    """Random straight-line tl graph over 2-D tensors."""

    def __init__(self, seed: int, dtype: str):
        self.rnd = random.Random(seed)
        self.dtype = dtype
        self.lines = []
        self.pool = []          # (name, shape) of every SSA value
        self.n = 0

    def t(self, shape):
        return "tensor<" + "x".join(map(str, shape)) + f"x{self.dtype}>"

    def fresh(self):
        self.n += 1
        return f"%v{self.n}"

    def const(self, shape, init="normal"):
        v = self.fresh()
        seed = self.rnd.randrange(1000)
        self.lines.append(
            f'  {v} = tl.constant {{init = "{init}", seed = {seed}}} '
            f": {self.t(shape)}")
        return v

    def pick(self, pred=None):
        cands = [p for p in self.pool if pred is None or pred(p[1])]
        return self.rnd.choice(cands) if cands else None

    def emit_matmul(self):
        src = self.pick(lambda s: len(s) == 2)
        if src is None:
            return
        a, (m, k) = src
        n = self.rnd.choice(DIMS)
        w = self.const((k, n))
        # dest: zero constant (BETA_0 bait) or an existing same-shape
        # value (residual-accumulator bait for fold-add-into-dest /
        # fold-residual-acc)
        existing = self.pick(lambda s: s == (m, n))
        if existing is not None and self.rnd.random() < 0.4:
            c = existing[0]
        else:
            c = self.const((m, n), init="zero")
        v = self.fresh()
        self.lines.append(
            f"  {v} = tl.matmul {a}, {w}, {c} : {self.t((m, n))}")
        self.pool.append((v, (m, n)))

    def emit_bias(self):
        src = self.pick(lambda s: len(s) == 2)
        if src is None:
            return
        a, (m, n) = src
        b = self.const((n,))
        kind = self.rnd.choice(("add", "mul"))
        v = self.fresh()
        self.lines.append(
            f"  {v} = tl.{kind} {a}, {b} : {self.t((m, n))}")
        self.pool.append((v, (m, n)))

    def emit_binary(self):
        src = self.pick(lambda s: len(s) == 2)
        if src is None:
            return
        a, shape = src
        other = self.pick(lambda s: s == shape)
        if other is None:
            return
        kind = self.rnd.choice(BINARIES)
        v = self.fresh()
        self.lines.append(
            f"  {v} = tl.{kind} {a}, {other[0]} : {self.t(shape)}")
        self.pool.append((v, shape))

    def emit_unary(self):
        src = self.pick()
        if src is None:
            return
        a, shape = src
        kind = self.rnd.choice(UNARIES)
        v = self.fresh()
        self.lines.append(f"  {v} = tl.{kind} {a} : {self.t(shape)}")
        self.pool.append((v, shape))

    def emit_transpose(self):
        src = self.pick(lambda s: len(s) == 2)
        if src is None:
            return
        a, (m, n) = src
        v = self.fresh()
        self.lines.append(
            f"  {v} = tl.transpose {a} {{perm = [1, 0]}} "
            f": {self.t((n, m))}")
        self.pool.append((v, (n, m)))

    def emit_reshape(self):
        src = self.pick(lambda s: len(s) == 2)
        if src is None:
            return
        a, (m, n) = src
        d = self.rnd.choice([x for x in DIMS if (m * n) % x == 0])
        v = self.fresh()
        shape = (m * n // d, d)
        self.lines.append(f"  {v} = tl.reshape {a} : {self.t(shape)}")
        self.pool.append((v, shape))

    def emit_conv(self):
        """NHWC conv from fresh constants, result reshaped back into the
        2-D pool. Modes cover every conv-lowering path: 1x1 (conv1x1-to-
        matmul), 3x3 stride 1 (conv-to-brgemm / native NHWC kernel),
        stride<kernel (the xla strategy), and stride==kernel (the
        patchify shape — xla strategy by default, the rewrite under the
        'patchify' pipeline; both must stay exact)."""
        N = self.rnd.choice((1, 2))
        C = self.rnd.choice((3, 8, 16))
        K = self.rnd.choice((16, 32))
        mode = self.rnd.choice(("1x1", "3x3", "patchify", "strided"))
        if mode == "1x1":
            R = S = 1
            st = (1, 1)
            H = W = self.rnd.choice((8, 16))
        elif mode == "3x3":
            R = S = 3
            st = (1, 1)
            H = W = self.rnd.choice((6, 10))
        elif mode == "patchify":
            R = S = self.rnd.choice((2, 4))
            st = (R, S)
            H = W = R * self.rnd.choice((2, 4))
        else:
            R = S = 3
            st = (2, 2)
            H = W = 7
        ho = (H - R) // st[0] + 1
        wo = (W - S) // st[1] + 1
        i = self.const((N, H, W, C))
        w = self.const((R, S, C, K))
        o = self.const((N, ho, wo, K), init="zero")
        v = self.fresh()
        self.lines.append(
            f"  {v} = tl.conv2d_nhwc_hwcf {i}, {w}, {o} "
            f"{{strides = [{st[0]}, {st[1]}]}} "
            f": {self.t((N, ho, wo, K))}")
        r = self.fresh()
        self.lines.append(
            f"  {r} = tl.reshape {v} : {self.t((N * ho * wo, K))}")
        self.pool.append((r, (N * ho * wo, K)))

    def emit_softmax(self):
        src = self.pick(lambda s: len(s) == 2)
        if src is None:
            return
        a, shape = src
        v = self.fresh()
        self.lines.append(
            f"  {v} = tl.softmax {a} {{axis = 1}} : {self.t(shape)}")
        self.pool.append((v, shape))

    def build(self):
        m, k = self.rnd.choice(DIMS), self.rnd.choice(DIMS)
        args = [("%x", (m, k))]
        if self.rnd.random() < 0.5:
            args.append(("%y", (self.rnd.choice(DIMS),
                                self.rnd.choice(DIMS))))
        self.pool = list(args)
        emitters = [self.emit_matmul, self.emit_matmul, self.emit_bias,
                    self.emit_binary, self.emit_unary, self.emit_unary,
                    self.emit_transpose, self.emit_reshape,
                    self.emit_softmax, self.emit_conv]
        for _ in range(self.rnd.randrange(3, 11)):
            self.rnd.choice(emitters)()
        # return a random computed value (returned-intermediate bait:
        # passes must not rewrite a value that escapes via return),
        # preferring late values so most of the graph stays live
        computed = self.pool[len(args):] or self.pool
        ret, rshape = computed[-1] if self.rnd.random() < 0.7 \
            else self.rnd.choice(computed)
        sig = ", ".join(f"{n.replace('%', '%')}: {self.t(s)}"
                        for n, s in args)
        body = "\n".join(self.lines)
        text = (f"func @entry({sig}) {{\n{body}\n"
                f"  return {ret} : {self.t(rshape)}\n}}\n")
        return text, args


def _inputs(seed, args, dtype):
    """(torch tensors, jnp arrays) of the same seeded normals."""
    rng = np.random.default_rng(seed)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    port = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(tdt) for _, s in args]
    jax = [jnp.asarray(t.float().numpy()).astype(
        {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]) for t in port]
    return port, jax


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _lowered(text, pipeline, dtype):
    m = parse_module(text)
    if dtype == "f32":
        m.attrs["precision"] = "highest"
    run_pipeline(m, *pipeline)
    m.verify()
    return m


def _run_differential(seed):
    rnd = random.Random(seed ^ 0x5EED)
    dtype = "bf16" if rnd.random() < 0.3 else "f32"
    pipeline = rnd.choice(PIPELINES)
    text, args = _Gen(seed, dtype).build()
    port_in, jax_in = _inputs(seed, args, dtype)
    loops = parse_module(text)
    if dtype == "f32":
        loops.attrs["precision"] = "highest"
    want = _f32(port_compile(loops, device="cpu")(*port_in))
    jax_want = _f32(jax_compile(jax_parse_module(text), jit=False)(*jax_in))
    got = _f32(port_compile(_lowered(text, pipeline, dtype),
                            device="cpu")(*port_in))
    msg = f"seed={seed} pipeline={pipeline} dtype={dtype}\n{text}"
    np.testing.assert_allclose(want, jax_want, err_msg="loops vs JAX: " + msg,
                               **TOL[dtype])
    np.testing.assert_allclose(got, want, err_msg="lowered vs loops: " + msg,
                               **TOL[dtype])
    np.testing.assert_allclose(got, jax_want, err_msg="lowered vs JAX: " + msg,
                               **TOL[dtype])


@pytest.mark.parametrize("batch", range(8))
def test_fuzz_default_pipelines(batch):
    """48 seeded graphs x {default, flat, packed} x {f32, bf16}, 6 a case,
    each lowered and run against the port's --linalg-to-loops and the JAX
    package's run."""
    per = SEEDS // 8
    for seed in range(batch * per, (batch + 1) * per):
        _run_differential(seed)


_ELTWISE_KINDS = ("relu", "gelu", "gelu_tanh", "tanh", "square", "negate",
                  "exp")


def _drop_trailing_unary_bug(module):
    """The original's canary: a buggy rewrite absorbs an elementwise
    xsmm.unary "into its producer" and never runs it, so the activation
    disappears from the executed program while the IR still verifies."""
    for func in module.funcs.values():
        for op in list(func.ops):
            if op.opname != "xsmm.unary":
                continue
            d = op.operands[0].owner
            if d is None or d.attrs.get("kind") not in _ELTWISE_KINDS:
                continue
            if any(r is op.result for r in func.returns):
                continue   # a directly-returned value: too obvious
            func.replace_all_uses(op.result, op.operands[1])
            func.erase(op)
            return True
    return False


def test_fuzzer_catches_dropped_epilogue():
    """The corpus must fail when the dropped-unary bug is planted after
    lowering: the fuzzer is sensitive to the bug class it exists for."""
    caught = planted = 0
    for seed in range(120):
        text, args = _Gen(seed, "f32").build()
        low = _lowered(text, ("default-tpp-passes",), "f32")
        if not _drop_trailing_unary_bug(low):
            continue
        planted += 1
        port_in, _ = _inputs(seed, args, "f32")
        loops = parse_module(text)
        loops.attrs["precision"] = "highest"
        want = _f32(port_compile(loops, device="cpu")(*port_in))
        got = _f32(port_compile(low, device="cpu")(*port_in))
        if not np.allclose(got, want, **TOL["f32"]):
            caught += 1
    assert planted >= 10, f"the corpus planted only {planted} bugs"
    # a few drops are semantically dead (relu after relu): demand a high
    # catch rate, not every one
    assert caught >= planted * 0.6, (caught, planted)
