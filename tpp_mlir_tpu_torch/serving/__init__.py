"""The serving core: GPT-family prefill, KV-cache decode, extend and
generate (`engine.py`) and int8 quantization (`quant.py`), the port of
`tpp_mlir_tpu/serving/engine.py` and `quant.py`."""

from .engine import (DecodeRunner, GptConfig, composed_causal_attention,
                     init_params, make_decode_step, make_extend,
                     make_generate, make_prefill, make_sampler,
                     params_from_numpy, params_from_torch, stack_params)
from .quant import (QTensor, dequantize, dequantize_params, quantize,
                    quantize_params, quantize_tokens, quantized_bytes,
                    with_kmajor)

__all__ = [
    "DecodeRunner", "GptConfig", "QTensor",
    "composed_causal_attention", "dequantize", "dequantize_params",
    "init_params", "make_decode_step", "make_extend",
    "make_generate", "make_prefill", "make_sampler", "params_from_numpy",
    "params_from_torch", "quantize", "quantize_params", "quantize_tokens",
    "quantized_bytes", "stack_params", "with_kmajor",
]
