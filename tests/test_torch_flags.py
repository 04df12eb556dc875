"""The port's kernel keys are field-for-field copies of the JAX package's:
same field names, same order, same defaults."""

import dataclasses

import pytest

import tpp_mlir_tpu.xsmm.decode_attn as decode_attn
import tpp_mlir_tpu.xsmm.flags as ref_flags
import tpp_mlir_tpu_torch.xsmm.flags as port_flags


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["BrgemmKey", "ChainKey", "FlashMhaKey",
                                  "LayerNormKey", "UnaryKey", "BinaryKey",
                                  "DecodeAttnKey", "Int8GemmKey"])
def test_key_copy_matches_reference(name):
    port = getattr(port_flags, name)
    ref = getattr(decode_attn if name == "DecodeAttnKey" else ref_flags,
                  name)
    assert _fields(port) == _fields(ref)
    assert port.__dataclass_params__.frozen and ref.__dataclass_params__.frozen


def test_keys_hash_equal_across_packages():
    # same field values -> same cache identity on both sides
    kw = dict(m=8, dims=(16, 16), dtype="bf16", repeats=3)
    p, r = port_flags.ChainKey(**kw), ref_flags.ChainKey(**kw)
    assert dataclasses.astuple(p) == dataclasses.astuple(r)
    assert hash(p) == hash(port_flags.ChainKey(**kw))
