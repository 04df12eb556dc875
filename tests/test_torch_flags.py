"""The port's kernel keys are field-for-field copies of the JAX package's:
same field names, same order, same defaults. One field is left out on
purpose: FlashTrainKey's `hpp` (heads per TPU program, chosen by the VMEM
gates `flash_train_hpp`/`flash_fwd_hpp`, which size TPU programs and which
the port does not carry, ADVICE.md #3); a Hopper block holds one head."""

import dataclasses

import pytest

import tpp_mlir_tpu.xsmm.decode_attn as decode_attn
import tpp_mlir_tpu.xsmm.flags as ref_flags
import tpp_mlir_tpu.xsmm.flash_train as flash_train
import tpp_mlir_tpu_torch.xsmm.flags as port_flags


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["BrgemmKey", "BlockedMatmulKey",
                                  "BatchMatmulKey", "ChainKey",
                                  "ConvBrgemmKey", "ConvNhwcKey",
                                  "FlashMhaKey",
                                  "LayerNormKey", "UnaryKey", "BinaryKey",
                                  "DecodeAttnKey", "Int8GemmKey",
                                  "GroupedGemmKey", "GroupedWgradKey"])
def test_key_copy_matches_reference(name):
    port = getattr(port_flags, name)
    ref = getattr(decode_attn if name == "DecodeAttnKey" else ref_flags,
                  name)
    assert _fields(port) == _fields(ref)
    assert port.__dataclass_params__.frozen and ref.__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["ConvBrgemmKey", "ConvNhwcKey"])
def test_conv_key_output_shape_matches_reference(name):
    kw = dict(N=2, H=9, W=11, R=3, S=3, stride_h=2, stride_w=1)
    kw.update(dict(Cb=1, c=16, Kb=1, k=16) if name == "ConvBrgemmKey"
              else dict(C=16, K=16, pad=(1, 0, 2, 1)))
    port, ref = getattr(port_flags, name)(**kw), getattr(ref_flags, name)(**kw)
    assert (port.P, port.Q) == (ref.P, ref.Q)


def test_keys_hash_equal_across_packages():
    # same field values -> same cache identity on both sides
    kw = dict(m=8, dims=(16, 16), dtype="bf16", repeats=3)
    p, r = port_flags.ChainKey(**kw), ref_flags.ChainKey(**kw)
    assert dataclasses.astuple(p) == dataclasses.astuple(r)
    assert hash(p) == hash(port_flags.ChainKey(**kw))


def test_flash_train_key_copy_matches_reference_without_hpp():
    ref = [f for f in _fields(flash_train.FlashTrainKey) if f[0] != "hpp"]
    assert _fields(port_flags.FlashTrainKey) == ref
    # the backward's key: the same fields under a type of its own
    assert _fields(port_flags.FlashTrainBwdKey) == ref
    kw = dict(batch=2, heads=4, seq=16, head_dim=32)
    assert port_flags.FlashTrainKey(**kw) != port_flags.FlashTrainBwdKey(**kw)
