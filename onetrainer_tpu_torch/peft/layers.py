"""PEFT adapters applied inside the layer.

Counterpart of onetrainer_tpu/peft/layers.py (LoraDense/LoraConv). The
base modules stay plain `nn.Linear`/`nn.Conv2d` with diffusers' state_dict
keys; an adapter is attached to a layer as a plain attribute (not a
parameter or buffer, so `state_dict()` does not change), and
`models/layers.py:linear`/`conv` apply it:

    LoRA  y = x W^T + b + ((x down^T) up^T)            (dense)
          y = conv(x, W) + b + conv1x1(conv(x, down), up)   (conv: down has
                                              the base geometry, up is 1x1)
    LoHa  y = x W^T + b + x dW^T, dW = (w1a w1b) * (w2a w2b)   (conv: dW
                                              as a full kh x kw kernel)
    DoRA  y = x W'^T + b, W' = m (W + up down) / (||W + up down|| + eps)

with `down` (LoHa: `w1b`) scaled by alpha/rank at use, rank dropout's keep
mask applied to `down`'s rows, and the factors cast to the layer's compute
dtype, as the reference's `adapters_to_lora_collection`, `_adapter_y` and
`_dora_weight` do. LoHa's delta and DoRA's merged weight are built in
fp32 and cast to the compute dtype; DoRA's norm is detached, taken per
output row (`dora_scale` [out, 1(, 1, 1)]) or per input column ([1, in(,
1, 1)]), for a conv over the other channel axis and the kh x kw taps. The
factors are the caller's tensors (trainable leaves); gradients reach them
through the term; fp8 factors are scaled in fp32. The fp8-activation path
is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

_ATTR = "peft_adapter"


def _arithmetic(t: torch.Tensor) -> torch.Tensor:
    """`t`, or for fp8 factors (which torch does no arithmetic in) `t` in
    fp32."""
    return t.float() if t.dtype.itemsize == 1 else t


@dataclass
class LoraAdapter:
    down: torch.Tensor   # [r, in] or [r, in, kh, kw]
    up: torch.Tensor     # [out, r]
    scale: float         # alpha / rank
    dora_scale: torch.Tensor | None = None   # DoRA's magnitude
    dora_eps: float = 0.0
    dropout: float = 0.0                     # rank dropout p
    keep: torch.Tensor | None = None         # its [r, 1(, 1, 1)] bool mask, set per step

    def _down(self) -> torch.Tensor:
        down = _arithmetic(self.down) * self.scale
        if self.keep is not None:
            down = down * self.keep / (1.0 - self.dropout)
        return down

    def _factors(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        return self._down().to(dtype), self.up.to(dtype)

    def delta(self) -> torch.Tensor:
        """up . down in fp32, [out, in * kh * kw]."""
        down = self._down().float()
        return self.up.float() @ down.reshape(down.shape[0], -1)

    def linear(self, xp: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        down, up = self._factors(dtype)
        return F.linear(F.linear(xp, down), up)

    def conv(self, xp: torch.Tensor, dtype: torch.dtype, stride,
             padding) -> torch.Tensor:
        down, up = self._factors(dtype)
        h = F.conv2d(xp, down, None, stride, padding)
        return F.conv2d(h, up[:, :, None, None])


@dataclass
class LohaAdapter:
    w1a: torch.Tensor    # [out, r]
    w1b: torch.Tensor    # [r, in] or [r, in, kh, kw]
    w2a: torch.Tensor    # [out, r]
    w2b: torch.Tensor
    scale: float         # alpha / rank, on w1b

    def delta(self) -> torch.Tensor:
        """(w1a w1b) * (w2a w2b) in fp32, [out, in * kh * kw]."""
        w1b = (_arithmetic(self.w1b) * self.scale).float()
        w2b = self.w2b.float()
        return (self.w1a.float() @ w1b.reshape(w1b.shape[0], -1)) \
            * (self.w2a.float() @ w2b.reshape(w2b.shape[0], -1))


def dora_norm(w: torch.Tensor, output_axis: bool) -> torch.Tensor:
    """The norm of a torch-layout weight per output row, or per input column
    (a conv's over the output channels and the kh x kw taps), in
    `dora_scale`'s shape: DoRA's magnitude at init, its divisor after."""
    dims = tuple(range(1, w.dim())) if output_axis else (0,) + tuple(range(2, w.dim()))
    return torch.sqrt((w * w).sum(dim=dims, keepdim=True))


def dora_weight(w: torch.Tensor, adapter: LoraAdapter) -> torch.Tensor:
    """DoRA's merged weight m (W + dW) / (||W + dW|| + eps), fp32, in `w`'s
    torch layout ([out, in] or [out, in, kh, kw]; `w` fp32), the norm
    detached (reference: peft/layers.py `_dora_weight`)."""
    wp = w + adapter.delta().reshape(w.shape)
    m = adapter.dora_scale.float()
    norm = dora_norm(wp, m.shape[0] != 1).detach() + adapter.dora_eps
    return m.reshape(norm.shape) * wp / norm


def adapter_of(layer: nn.Module) -> LoraAdapter | LohaAdapter | None:
    return getattr(layer, _ATTR, None)


def attach_adapter(layer: nn.Module, adapter: LoraAdapter | LohaAdapter | None) -> None:
    """Attach `adapter` to `layer` (None detaches)."""
    if adapter is None:
        layer.__dict__.pop(_ATTR, None)
    else:
        object.__setattr__(layer, _ATTR, adapter)
