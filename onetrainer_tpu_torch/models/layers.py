"""Per-op dtype casting for plain torch layers.

The reference keeps parameters in fp32 and computes each op in the model's
compute dtype (bf16 by default), casting per op (onetrainer_tpu/models/
unet.py). These helpers apply a plain `nn.Linear`/`nn.Conv2d`/norm module
that way: inputs and weights cast to `dtype`; norm statistics in fp32 with
the result cast to `dtype`, as flax's norms do.

`linear` and `conv` also apply a PEFT adapter attached to the layer
(peft/layers.py: LoRA's and LoHa's additive terms, DoRA's merged weight),
as the reference's LoraDense/LoraConv do inside the layer, and dequantize a
quantized frozen weight (ops/quant.py: fp8, int8, NF4 through K4) to the
compute dtype at each use, as the reference's `_get_kernel` does. Autograd
saves that dequantized weight for the input gradient like any cast weight;
under gradient checkpointing the recompute dequantizes (and, for DoRA,
merges) again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.ops.quant import dequantized_weight, is_quantized
from onetrainer_tpu_torch.peft.layers import LoraAdapter, LohaAdapter, adapter_of, dora_weight


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


def weight_in(layer: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """The weight `layer` computes with in `dtype`: its own, dequantized
    (ops/quant.py), or under DoRA the merged m (W + dW) / (||W + dW|| + eps)
    over it in fp32, cast to `dtype` (W the fp32 weight, or a quantized one
    dequantized to `dtype` first, as the reference's `_get_kernel` does)."""
    w = layer.weight
    adapter = adapter_of(layer)
    if isinstance(adapter, LoraAdapter) and adapter.dora_scale is not None:
        w = dequantized_weight(w, dtype) if is_quantized(w) else w
        return dora_weight(w.float(), adapter).to(dtype)
    return dequantized_weight(w, dtype)


def _additive(adapter) -> bool:
    """Whether `adapter` adds a term to the layer's output (LoRA, LoHa;
    DoRA works through `weight_in`)."""
    return adapter is not None and not (
        isinstance(adapter, LoraAdapter) and adapter.dora_scale is not None)


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    xp = x.to(dtype)
    y = F.linear(xp, weight_in(layer, dtype), _cast(layer.bias, dtype))
    adapter = adapter_of(layer)
    if not _additive(adapter):
        return y
    if isinstance(adapter, LohaAdapter):
        return y + F.linear(xp, adapter.delta().to(dtype))
    return y + adapter.linear(xp, dtype)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    xp = x.to(dtype)
    y = F.conv2d(xp, weight_in(layer, dtype), _cast(layer.bias, dtype), layer.stride,
                 layer.padding, groups=layer.groups)
    adapter = adapter_of(layer)
    if not _additive(adapter):
        return y
    if isinstance(adapter, LohaAdapter):
        kernel = adapter.delta().reshape(y.shape[1], *adapter.w1b.shape[1:])
        return y + F.conv2d(xp, kernel.to(dtype), None, layer.stride, layer.padding)
    return y + adapter.conv(xp, dtype, layer.stride, layer.padding)


def group_norm(layer: nn.GroupNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return F.group_norm(x.float(), layer.num_groups, layer.weight.float(),
                        layer.bias.float(), layer.eps).to(dtype)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight.float(),
                        layer.bias.float(), layer.eps).to(dtype)
