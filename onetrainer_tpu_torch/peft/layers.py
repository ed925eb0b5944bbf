"""LoRA applied inside the layer.

Counterpart of onetrainer_tpu/peft/layers.py (LoraDense/LoraConv), LoRA
only. The base modules stay plain `nn.Linear`/`nn.Conv2d` with diffusers'
state_dict keys; an adapter is attached to a layer as a plain attribute
(not a parameter or buffer, so `state_dict()` does not change), and
`models/layers.py:linear`/`conv` add its term:

    y = x W^T + b + ((x down^T) up^T)        (dense)
    y = conv(x, W) + b + conv1x1(conv(x, down), up)   (conv: down has the
                                              base geometry, up is 1x1)

with `down` scaled by alpha/rank at use and both factors cast to the
layer's compute dtype, as the reference's `adapters_to_lora_collection`
and `_adapter_y` do. The factors are the caller's tensors (trainable
leaves); gradients reach them through the term. DoRA, LoHa, rank dropout
and the fp8-activation path are not ported (peft/lora.py raises for them).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

_ATTR = "peft_adapter"


@dataclass
class LoraAdapter:
    down: torch.Tensor   # [r, in] or [r, in, kh, kw]
    up: torch.Tensor     # [out, r]
    scale: float         # alpha / rank

    def _factors(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        return (self.down * self.scale).to(dtype), self.up.to(dtype)

    def linear(self, xp: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        down, up = self._factors(dtype)
        return F.linear(F.linear(xp, down), up)

    def conv(self, xp: torch.Tensor, dtype: torch.dtype, stride,
             padding) -> torch.Tensor:
        down, up = self._factors(dtype)
        h = F.conv2d(xp, down, None, stride, padding)
        return F.conv2d(h, up[:, :, None, None])


def adapter_of(layer: nn.Module) -> LoraAdapter | None:
    return getattr(layer, _ATTR, None)


def attach_adapter(layer: nn.Module, adapter: LoraAdapter | None) -> None:
    """Attach `adapter` to `layer` (None detaches)."""
    if adapter is None:
        layer.__dict__.pop(_ATTR, None)
    else:
        object.__setattr__(layer, _ATTR, adapter)
