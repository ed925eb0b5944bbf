"""Per-op dtype casting for plain torch layers.

The reference keeps parameters in fp32 and computes each op in the model's
compute dtype (bf16 by default), casting per op (onetrainer_tpu/models/
unet.py). These helpers apply a plain `nn.Linear`/`nn.Conv2d`/norm module
that way: inputs and weights cast to `dtype`; norm statistics in fp32 with
the result cast to `dtype`, as flax's norms do.

`linear` and `conv` also add a layer's LoRA term when a PEFT adapter is
attached to it (peft/layers.py), as the reference's LoraDense/LoraConv do
inside the layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.peft.layers import adapter_of


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    xp = x.to(dtype)
    y = F.linear(xp, layer.weight.to(dtype), _cast(layer.bias, dtype))
    adapter = adapter_of(layer)
    return y if adapter is None else y + adapter.linear(xp, dtype)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    xp = x.to(dtype)
    y = F.conv2d(xp, layer.weight.to(dtype), _cast(layer.bias, dtype),
                 layer.stride, layer.padding)
    adapter = adapter_of(layer)
    if adapter is None:
        return y
    return y + adapter.conv(xp, dtype, layer.stride, layer.padding)


def group_norm(layer: nn.GroupNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return F.group_norm(x.float(), layer.num_groups, layer.weight.float(),
                        layer.bias.float(), layer.eps).to(dtype)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight.float(),
                        layer.bias.float(), layer.eps).to(dtype)
