"""The port's default-tpp-passes against the JAX package's: the same printed
IR on tpp-gen's MLP, fc and matmul modules and on the imported GPT and
transformer block once the tile_* hints (TPU blocks there, Hopper tiles
here) are stripped; the chain gate chain_fits_smem on each side of its
limit; and verify-slice refusing what the port cannot run."""

import re

import pytest

from tpp_mlir_tpu.models.gpt import build_gpt as ref_build_gpt
from tpp_mlir_tpu.models.mlp import build_mlp as ref_build_mlp
from tpp_mlir_tpu.models.transformer_block import \
    build_transformer_block as ref_build_transformer_block
from tpp_mlir_tpu.passes import run_pipeline as ref_run_pipeline
from tpp_mlir_tpu_torch.ir import Function, Module, TensorType, TppBuilder
from tpp_mlir_tpu_torch.models.gpt import build_gpt
from tpp_mlir_tpu_torch.models.mlp import MlpConfig, build_mlp
from tpp_mlir_tpu_torch.models.transformer_block import \
    build_transformer_block
from tpp_mlir_tpu_torch.passes import run_pipeline
from tpp_mlir_tpu_torch.xsmm import ChainKey, chain_fits_smem


def _strip_tiles(text: str) -> str:
    return re.sub(r"tile_[mnk] = \d+(, )?", "", text).replace(", }", " }")


def _invokes(module):
    return [op.opname for op in module["entry"].ops
            if op.opname.startswith("xsmm.")
            and not op.opname.endswith("_dispatch")]


CONFIGS = {
    "mlp-f32-const": MlpConfig(batch=8, layers=(16, 32, 16), bias=True,
                               relu=True),
    "mlp-bf16-const": MlpConfig(batch=8, layers=(16, 32, 16), bias=True,
                                relu=True, float_type="bf16"),
    "mlp-f32-args": MlpConfig(batch=8, layers=(16, 16, 16, 16), bias=True,
                              relu=True, kernel="args"),
    "mlp-bf16-args": MlpConfig(batch=8, layers=(16, 16, 16, 16), bias=True,
                               relu=True, float_type="bf16", kernel="args"),
    "mlp-bf16-vnni2": MlpConfig(batch=8, layers=(16, 16, 16), bias=True,
                                relu=True, float_type="bf16", vnni=2),
    "mlp-no-bias": MlpConfig(batch=8, layers=(16, 16, 16), relu=True),
    "mlp-no-relu": MlpConfig(batch=8, layers=(16, 16, 16), bias=True),
    "fc-single-layer": MlpConfig(batch=8, layers=(16, 32), bias=True,
                                 relu=True),
    "fc-bf16-vnni2": MlpConfig(batch=8, layers=(16, 32), bias=True,
                               relu=True, float_type="bf16", vnni=2),
    "matmul": MlpConfig(batch=8, layers=(32, 16)),
    "flagship-bf16": MlpConfig(batch=256, layers=(1024,) * 4, bias=True,
                               relu=True, float_type="bf16"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_default_tpp_passes_matches_reference(name, precision):
    # each package lowers IR built by its own copy of the builder
    port, ref = build_mlp(CONFIGS[name]), ref_build_mlp(CONFIGS[name])
    if precision != "default":
        port.attrs["precision"] = ref.attrs["precision"] = precision
    run_pipeline(port, "default-tpp-passes")
    ref_run_pipeline(ref, "default-tpp-passes")
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))


def test_flagship_lowers_to_one_fused_chain():
    for dt in ("bf16", "f32"):
        m = build_mlp(MlpConfig(batch=256, layers=(1024,) * 4, bias=True,
                                relu=True, float_type=dt))
        run_pipeline(m, "default-tpp-passes")
        assert _invokes(m) == ["xsmm.fused_chain"]


def test_tile_hints_are_the_hopper_tile():
    m = build_mlp(MlpConfig(batch=256, layers=(1024, 1024), bias=True,
                            relu=True))
    run_pipeline(m, "default-tpp-passes")
    d = [op for op in m["entry"].ops
         if op.opname == "xsmm.fused_brgemm_dispatch"][0]
    assert (d.attrs["tile_m"], d.attrs["tile_n"], d.attrs["tile_k"]) == \
        (64, 64, 32)


@pytest.mark.parametrize("dtype,precision", [("bf16", "default"),
                                             ("f32", "default"),
                                             ("f32", "highest")])
def test_chain_gate_accepts_the_flagship(dtype, precision):
    assert chain_fits_smem(ChainKey(m=256, dims=(1024,) * 4, dtype=dtype,
                                    precision=precision))


@pytest.mark.parametrize("dims,dtype,precision", [
    ((16, 4096, 16), "bf16", "default"),    # 392 KB of shared memory
    ((16, 2048, 16), "f32", "highest"),     # 259 KB in f32
    ((24, 24, 24), "f32", "default"),       # not a multiple of 16
])
def test_chain_gate_declines_and_layers_stay_fused_brgemm(dims, dtype,
                                                          precision):
    assert not chain_fits_smem(ChainKey(m=8, dims=dims, dtype=dtype,
                                        precision=precision))
    m = build_mlp(MlpConfig(batch=8, layers=dims, bias=True, relu=True,
                            float_type=dtype))
    if precision != "default":
        m.attrs["precision"] = precision
    run_pipeline(m, "default-tpp-passes")
    assert _invokes(m) == ["xsmm.fused_brgemm"] * (len(dims) - 1)


def test_chain_gate_limit_follows_the_kernel():
    # 2048 wide: bf16 fits (197 KB), f32 "highest" (259 KB) does not
    key = ChainKey(m=8, dims=(2048, 2048), dtype="f32")
    assert chain_fits_smem(key)
    assert not chain_fits_smem(ChainKey(m=8, dims=(2048, 2048),
                                        dtype="f32", precision="highest"))


@pytest.mark.parametrize("cfg", [
    MlpConfig(batch=8, layers=(16, 16), softmax=True),
    MlpConfig(batch=8, layers=(16, 16), bias=True, output="generic"),
    MlpConfig(batch=8, layers=(16, 16), tiles=(4, 8, 8)),
], ids=["softmax", "generic", "packed"])
def test_ir_outside_the_slice_is_refused(cfg):
    with pytest.raises(NotImplementedError, match="outside the port's slice"):
        run_pipeline(build_mlp(cfg), "default-tpp-passes")


def test_cpu_target_plans_for_the_sm90_kernels():
    from tpp_mlir_tpu_torch.utils import current_target
    from tpp_mlir_tpu_torch.xsmm.kernels import SM90_SMEM_OPTIN
    t = current_target("cpu")
    assert (t.name, t.sm_count) == ("cpu", 0)
    assert t.smem_per_block_optin == SM90_SMEM_OPTIN


# (builder, kwargs); the builder is "gpt" or "block", from either package
MODELS = {
    "gpt-bf16": ("gpt", dict(batch=2, seq=64, vocab=256, embed=128, heads=2,
                             layers=2, dtype="bf16")),
    "gpt-f32": ("gpt", dict(batch=1, seq=32, vocab=96, embed=64, heads=2,
                            layers=1)),
    "block-f32": ("block", dict(batch=2, seq=32, embed=128, heads=2)),
    "block-bf16-causal": ("block", dict(batch=1, seq=32, embed=64, heads=4,
                                        dtype="bf16", causal=True)),
    "encoder-2-layers": ("block", dict(batch=1, seq=32, embed=64, heads=2,
                                       layers=2)),
}


def _model(name, ref=False):
    kind, kw = MODELS[name]
    build = {("gpt", False): build_gpt, ("gpt", True): ref_build_gpt,
             ("block", False): build_transformer_block,
             ("block", True): ref_build_transformer_block}[kind, ref]
    return build(**kw)


def _xsmm_sequence(module):
    return [(op.opname, {k: v for k, v in op.attrs.items()
                         if not k.startswith("tile_")})
            for op in module["entry"].ops if op.opname.startswith("xsmm.")]


@pytest.mark.parametrize("name", list(MODELS))
def test_imported_models_lower_like_the_reference(name):
    port, ref = _model(name), _model(name, ref=True)
    run_pipeline(port, "default-tpp-passes")
    ref_run_pipeline(ref, "default-tpp-passes")
    assert _xsmm_sequence(port) == _xsmm_sequence(ref)
    assert _strip_tiles(str(port)) == _strip_tiles(str(ref))
    # the folded QKV weights are the same literals
    for key, arr in ref.literals.items():
        assert (port.literals[key] == arr).all()


def test_gpt_lowers_to_the_transformer_kernels():
    m = _model("gpt-bf16")
    run_pipeline(m, "default-tpp-passes")
    ops = m["entry"].ops
    disp = {id(op.result): op for op in ops if op.opname.endswith("_dispatch")}
    kinds = [(op.opname, disp[id(op.operands[0])].attrs.get("prologue"))
             for op in ops if op.opname.startswith("xsmm.")
             and not op.opname.endswith("_dispatch")]
    # per layer: LN-prologue QKV, packed attention, out-proj (+residual),
    # LN-prologue fc1 (+gelu), fc2 (+residual); then ln_f and the LM head
    layer = [("xsmm.fused_brgemm", "layer_norm"), ("xsmm.attention", None),
             ("xsmm.fused_brgemm", None), ("xsmm.fused_brgemm", "layer_norm"),
             ("xsmm.fused_brgemm", None)]
    assert kinds == [("xsmm.binary", None)] + layer * 2 + [
        ("xsmm.layer_norm", None), ("xsmm.gemm", None)]
    att = [disp[id(op.operands[0])].attrs for op in ops
           if op.opname == "xsmm.attention"]
    assert all(a["qkv_packed"] and a["causal"] and a["heads"] == 2
               and a["head_dim"] == 64 for a in att)


def _attention_module(attrs):
    t = TensorType((2, 32, 64), "f32")
    m = Module()
    f = m.add(Function("entry", [t, t, t], ["q", "k", "v"]))
    f.returns = [TppBuilder(f).create("tl.attention", list(f.args), [t],
                                      attrs).result]
    m.verify()
    return m


@pytest.mark.parametrize("attrs,why", [
    # heads = 0 is the flat layout, whose kernel runs every flat strategy;
    # a token-layout strategy there is what the reference would swap for B6
    ({"causal": True, "strategy": "tokens"}, "strategy 'tokens'"),
    ({"strategy": "xla"}, "strategy 'xla'"),
], ids=["flat-heads-0", "forced-xla"])
def test_verify_slice_refuses_attention_outside_the_slice(attrs, why):
    with pytest.raises(NotImplementedError, match=why):
        run_pipeline(_attention_module(attrs), "default-tpp-passes")


def test_verify_slice_admits_token_attention():
    m = _attention_module({"heads": 2, "strategy": "tokens"})
    run_pipeline(m, "default-tpp-passes")
    assert _invokes(m) == ["xsmm.attention"]
