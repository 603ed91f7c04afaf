"""bigdl_tpu_torch.quant: int8/bf16 quantization, storage and compute
(port of ``bigdl_tpu/quant``).

Symmetric int8 weights with per-channel float32 scales
(:class:`QTensor`) in the regimes ``QuantPolicy(compute=...)`` selects:
``"dequant"`` (expand, then a float product), ``"int8"`` (per-token
activation quantization, exact int32 accumulation through
``torch._int_mm``, one float32 rescale), ``"auto"`` (the autotuned
int8-vs-dequant verdict for the device kind, ``ops.autotune``; dequant
without one) and ``"fp8"`` (e4m3, gated on capable devices).

Entry points:

- ``model.quantize("int8", compute="int8")``: a quantized clone of a
  ``TransformerLM`` or of an image classifier (``Linear`` and
  ``SpatialConvolution`` weights in their native layouts, ``qconv``);
- :func:`quantize_params`: the tree-level transform and its policy;
- ``LMServingEngine(model, spec=4)`` or
  ``SpecConfig(drafter_compute="int8")``: the default int8 drafter;
- ``LMServingEngine(model, kv_quant="int8")``: int8 KV arenas.
"""
from bigdl_tpu_torch.quant.activations import (ActCalibrator,
                                               attach_act_scales,
                                               fp8_supported,
                                               quantize_per_token,
                                               quantize_per_token_fp8)
from bigdl_tpu_torch.quant.kernels import (int_mm, qconv, qconv_i8,
                                           qlinear, qlinear_i8, qmatmul,
                                           qmatmul_f8, qmatmul_i8,
                                           resolve_compute)
from bigdl_tpu_torch.quant.qtensor import (QMAX, QTensor, dequantize_array,
                                           is_qtensor, quantize_array)
from bigdl_tpu_torch.quant.transform import (QuantPolicy, dequantize_entry,
                                             dequantize_params,
                                             params_compute_tag,
                                             params_dtype_tag, params_nbytes,
                                             quantize_params,
                                             set_compute_mode,
                                             stage_quantized_params)

__all__ = [
    "ActCalibrator", "QMAX", "QTensor", "QuantPolicy", "attach_act_scales",
    "dequantize_array", "dequantize_entry", "dequantize_params",
    "fp8_supported", "int_mm", "is_qtensor", "params_compute_tag",
    "params_dtype_tag", "params_nbytes", "qconv", "qconv_i8", "qlinear",
    "qlinear_i8", "qmatmul", "qmatmul_f8",
    "qmatmul_i8", "quantize_array", "quantize_params", "quantize_per_token",
    "quantize_per_token_fp8", "resolve_compute", "set_compute_mode",
    "stage_quantized_params",
]
