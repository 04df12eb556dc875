"""The port's default-tpp-passes against the JAX package's: the same printed
IR on tpp-gen's MLP, fc and matmul modules once the tile_* hints (TPU
blocks there, Hopper tiles here) are stripped; and the chain gate
chain_fits_smem on each side of its limit."""

import re

import pytest

from tpp_mlir_tpu.models.mlp import MlpConfig, build_mlp
from tpp_mlir_tpu.passes import run_pipeline as ref_run_pipeline
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
    port, ref = build_mlp(CONFIGS[name]), build_mlp(CONFIGS[name])
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
