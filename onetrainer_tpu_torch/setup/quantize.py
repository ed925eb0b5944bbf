"""Quantized frozen-base wiring of the family setups.

Counterpart of onetrainer_tpu/setup/quantize.py. A frozen part whose
configured weight dtype is FLOAT_8, INT_8 or NFLOAT_4 has its dense and
conv weights quantized in place (ops/quant.py:quantize_module, the
reference's `quantize_tree` policy: kernel weights of >= 4096 elements;
everything else of the part cast to bf16). The layers dequantize them at
each use (models/layers.py). Only frozen parts quantize: trainable parts
keep full-precision weights.

The module is changed in place and each layer's full-precision weight is
dropped as soon as its quantized form exists, so no unquantized copy stays
alive (the reference re-points model attributes at the quantized tree for
the same reason: an SDXL base held twice costs 5.2 GB). A second call
finds the part quantized and leaves it alone.
"""

from __future__ import annotations

import torch
from torch import nn

from onetrainer_tpu_torch.ops.quant import module_is_quantized, quantize_module
from onetrainer_tpu_torch.util.enums import DataType


def quant_storage_dtype(dt: DataType):
    """`quantize_module`'s dtype for a quantized DataType ("nf4" or a
    torch storage dtype)."""
    if dt == DataType.NFLOAT_4:
        return "nf4"
    if dt == DataType.INT_8:
        return torch.int8
    return torch.float8_e4m3fn


def quantize_frozen_parts(frozen: dict[str, nn.Module], weight_dtypes,
                          part_map: dict[str, str]) -> None:
    """Quantize, in place, each frozen module whose configured weight dtype
    is quantized. part_map: frozen key -> ModelWeightDtypes attribute, e.g.
    {"unet": "unet", "text_encoder": "text_encoder"}; keys absent from
    `frozen` (trained in this run) are skipped."""
    for key, attr in part_map.items():
        dt = getattr(weight_dtypes, attr)
        module = frozen.get(key)
        if dt.is_quantized() and module is not None and not module_is_quantized(module):
            quantize_module(module, quant_storage_dtype(dt))
