"""The port's copies of the JAX package's IR, model builders, importer,
tpp-gen and attention-fusion pass (tpp_mlir_tpu_torch/ir, models, frontend,
tools/mlir_gen, passes/attention.py) against the originals: the same
printed text for every tpp-gen flag set the chip smoke and the tests use,
the same IR for the conv suite's nets, the same IR and literal arrays for
the imported GPT, encoder block, ResNet block and ViT, the
same IR from every MHA builder before and after attention-fusion, and the
JAX-printed text parsed by the port printing back identical. Everything is
compared exactly."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import tpp_mlir_tpu.ir as jax_ir
import tpp_mlir_tpu.models.mha as jax_mha
import tpp_mlir_tpu.tools.mlir_gen as jax_gen
import tpp_mlir_tpu_torch.ir as port_ir
import tpp_mlir_tpu_torch.models.mha as port_mha
import tpp_mlir_tpu_torch.tools.mlir_gen as port_gen
from tpp_mlir_tpu.passes import PassManager as JaxPassManager
from tpp_mlir_tpu_torch.passes import PassManager
from tpp_mlir_tpu.models.gpt import build_gpt as jax_build_gpt
from tpp_mlir_tpu.models.transformer_block import \
    build_transformer_block as jax_build_block
from tpp_mlir_tpu.models.convnet import ConvConfig as JaxConvConfig
from tpp_mlir_tpu.models.convnet import build_convnet as jax_build_convnet
from tpp_mlir_tpu.models.resnet_block import \
    build_resnet_block as jax_build_resnet_block
from tpp_mlir_tpu.models.vit import build_vit_block as jax_build_vit
from tpp_mlir_tpu_torch.models.convnet import ConvConfig, build_convnet
from tpp_mlir_tpu_torch.models.gpt import build_gpt
from tpp_mlir_tpu_torch.models.resnet_block import build_resnet_block
from tpp_mlir_tpu_torch.models.transformer_block import \
    build_transformer_block
from tpp_mlir_tpu_torch.models.vit import build_vit_block

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke_flags():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [flags for _, flags, _ in mod.MODULES]


FLAGS = [
    # tests/test_torch_imports.py and the verify notes
    "--batch=8 --layers=16,16,16 --bias --relu --float-type=bf16",
    "--batch=8 --layers=16,32 --bias --relu",
    "--batch=8 --layers=32,16",
    "--batch=8 --layers=16,16 --bias --relu",
    # the other options of the generator
    "--batch=8 --layers=16,16,16 --bias --relu --float-type=bf16 --vnni=2",
    "--batch=8 --layers=16,16 --bias --relu --kernel=args",
    "--batch=8 --layers=16,16 --bias --output=generic",
    "--batch=8 --layers=16,16 --softmax",
    "--batch=8 --layers=16,16 --tiles=4,8,8 --seed=7 --init-type=rand",
]


def _text(gen, flags):
    return gen.generate_text(gen.config_from_args(
        gen.build_parser().parse_args(flags.split())))


@pytest.mark.parametrize("flags", FLAGS + ["chip_smoke"])
def test_generator_prints_the_same_text(flags):
    for f in (_chip_smoke_flags() if flags == "chip_smoke" else [flags]):
        assert _text(port_gen, f) == _text(jax_gen, f), f


@pytest.mark.parametrize("build,ref,kw", [
    (build_gpt, jax_build_gpt, dict(batch=1, seq=16, vocab=64, embed=32,
                                    heads=2, layers=1)),
    (build_gpt, jax_build_gpt, dict(batch=2, seq=8, vocab=48, embed=32,
                                    heads=4, layers=2, dtype="bf16")),
    (build_transformer_block, jax_build_block,
     dict(batch=2, seq=16, embed=32, heads=2)),
    (build_transformer_block, jax_build_block,
     dict(batch=1, seq=16, embed=32, heads=4, layers=2, causal=True)),
    (build_resnet_block, jax_build_resnet_block,
     dict(batch=2, channels=16, hw=6)),
    (build_resnet_block, jax_build_resnet_block,
     dict(batch=1, channels=8, hw=5, seed=3, dtype="bf16")),
    (lambda **kw: build_vit_block(**kw)[0],
     lambda **kw: jax_build_vit(**kw)[0],
     dict(batch=2, image=32, patch=16, embed=64, heads=2, layers=1)),
    (lambda **kw: build_vit_block(**kw)[0],
     lambda **kw: jax_build_vit(**kw)[0],
     dict(batch=1, image=16, patch=4, embed=32, heads=4, layers=2,
          classes=10, dtype="bf16")),
], ids=["gpt", "gpt-bf16-2layers", "block", "block-causal-2layers",
        "resnet_block", "resnet_block-bf16", "vit", "vit-head-bf16-2layers"])
@pytest.mark.filterwarnings("ignore:enable_nested_tensor")
def test_imported_models_build_the_same_ir_and_literals(build, ref, kw):
    port, jax = build(**kw), ref(**kw)
    assert str(port) == str(jax)
    assert port.attrs == jax.attrs
    assert sorted(port.literals) == sorted(jax.literals)
    for name, arr in jax.literals.items():
        np.testing.assert_array_equal(np.asarray(port.literals[name]),
                                      np.asarray(arr))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(layout="nhwc", float_type="bf16", const_weights=False),
    dict(layers=2, padding="same", residual=True, channels=128,
         filters=128, height=16, width=16, seed=5),
    dict(kernel=1, height=14, width=14, bias=False, relu=False),
], ids=["suite-default", "nhwc-bf16-args", "same-residual", "1x1-plain"])
def test_convnet_builds_the_same_ir(kw):
    port = build_convnet(ConvConfig(**kw))
    jax = jax_build_convnet(JaxConvConfig(**kw))
    assert str(port) == str(jax)
    assert port.attrs == jax.attrs


@pytest.mark.parametrize("flags", FLAGS)
def test_port_parser_round_trips_jax_printed_text(flags):
    text = jax_ir.print_module(jax_ir.parse_module(_text(jax_gen, flags)))
    module = port_ir.parse_module(text)
    module.verify()
    assert port_ir.print_module(module) == text


MHA = [
    ("build_qk", dict(batch=2, heads=2, seq=32, head_dim=64)),
    ("build_softmax_v", dict(batch=2, heads=2, seq=32, head_dim=64,
                             dtype="bf16")),
    ("build_projection", dict(batch=2, seq=32, model_dim=64)),
    ("build_mha", dict(batch=2, heads=2, seq=64, head_dim=32)),
    ("build_mha", dict(batch=2, heads=2, seq=64, head_dim=32, scale=0.25)),
    ("build_mha", dict(batch=1, heads=2, seq=64, head_dim=32, causal=True,
                       scale=0.125, strategy="twocall", bq=32)),
    ("build_mha", dict(batch=1, heads=2, seq=64, head_dim=32, fused=True,
                       dtype="bf16")),
    ("build_mha_block", dict(batch=2, heads=2, seq=32, head_dim=32)),
]


@pytest.mark.parametrize("fn,kw", MHA, ids=[
    "qk", "softmax_v-bf16", "projection", "mha", "mha-scaled",
    "mha-causal-twocall", "mha-fused-bf16", "mha_block"])
def test_mha_builders_and_attention_fusion_match(fn, kw):
    port, jax = getattr(port_mha, fn)(**kw), getattr(jax_mha, fn)(**kw)
    assert str(port) == str(jax)
    assert port.attrs == jax.attrs
    PassManager(["attention-fusion"]).run(port)
    JaxPassManager(["attention-fusion"]).run(jax)
    assert str(port) == str(jax)
