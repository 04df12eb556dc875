"""The serving core: GPT-family prefill, KV-cache decode, extend and
generate (`engine.py`), int8 and int4 quantization (`quant.py`), continuous
batching with host and device schedulers (`batching.py`), beam search
(`beam.py`), speculative decoding (`speculative.py`) and LoRA/QLoRA
fine-tuning (`lora.py`), the port of the modules of the same names in
`tpp_mlir_tpu/serving/`."""

from .batching import (BatchingEngine, DeviceBatchingEngine,
                       init_slot_cache, init_staging, make_decode_loop,
                       make_device_loop, make_insert, make_stage_prefill)
from .beam import make_beam_generate
from .engine import (DecodeRunner, GptConfig, Replayed,
                     composed_causal_attention, decode_cache_specs,
                     decode_param_specs, init_params, make_decode_step,
                     make_extend, make_generate, make_prefill, make_sampler,
                     make_tp_decode_step, params_from_numpy,
                     params_from_torch, stack_params)
from .lora import (ALL_TARGETS, adapters_from_numpy, lora_init,
                   make_lora_train_step, merge_lora)
from .quant import (QTensor, dequantize, dequantize_params, pack_int4,
                    quantize, quantize_params, quantize_tokens,
                    quantized_bytes, unpack_int4, with_kmajor)
from .speculative import make_speculative_generate

__all__ = [
    "ALL_TARGETS", "adapters_from_numpy", "lora_init",
    "make_lora_train_step", "merge_lora",
    "BatchingEngine", "DecodeRunner", "DeviceBatchingEngine", "GptConfig",
    "QTensor", "Replayed", "composed_causal_attention",
    "decode_cache_specs", "decode_param_specs", "dequantize",
    "dequantize_params", "init_params", "init_slot_cache", "init_staging",
    "make_beam_generate", "make_decode_loop", "make_decode_step",
    "make_device_loop", "make_extend", "make_generate", "make_insert",
    "make_prefill", "make_sampler", "make_speculative_generate",
    "make_stage_prefill", "make_tp_decode_step", "pack_int4", "params_from_numpy",
    "params_from_torch", "quantize", "quantize_params", "quantize_tokens",
    "quantized_bytes", "stack_params", "unpack_int4", "with_kmajor",
]
