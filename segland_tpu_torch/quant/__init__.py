"""Post-training int8 quantization for inference: a calibration pass, then
int8 products with int32 sums in every large conv and linear layer.  See
ptq.py."""

from .ptq import (DEFAULT_CONFIG, ActScales, QuantConfig, build_fused_block_inputs, calibrate,
                  calibrate_across_ranks, quant_interceptor, quantized_apply)
