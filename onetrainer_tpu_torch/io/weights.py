"""Weight carry for the port's SDXL modules.

- `sdxl_params_from_flax` loads the reference's flax param trees (as numpy
  arrays) into the port's modules through the reference's own key maps
  (`onetrainer_tpu/io/torch_flax.py`), strictly: every key must match.
- `init_sdxl_weights` materialises full-width weights on a device from a
  seeded `torch.Generator`, for runs without a checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from onetrainer_tpu.io.torch_flax import (
    clip_flax_to_state_dict, unet_flax_to_state_dict, vae_flax_to_state_dict,
)


def _load(module: nn.Module, state_dict: dict) -> None:
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in state_dict.items()}, strict=True)


def sdxl_params_from_flax(model, unet: dict, te: dict, te2: dict,
                          vae: dict) -> None:
    """Load flax param trees into `model`'s unet, text encoders and vae."""
    _load(model.unet, unet_flax_to_state_dict(unet))
    _load(model.text_encoder, clip_flax_to_state_dict(te))
    _load(model.text_encoder_2, clip_flax_to_state_dict(te2))
    _load(model.vae, vae_flax_to_state_dict(vae))


@torch.no_grad()
def _init_module(module: nn.Module, gen: torch.Generator,
                 device: torch.device) -> None:
    module.to_empty(device=device)
    for sub in module.modules():
        if isinstance(sub, (nn.GroupNorm, nn.LayerNorm)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            sub.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(sub, (nn.Linear, nn.Conv2d)):
            # variance-preserving: std 1/sqrt(fan_in)
            fan_in = sub.weight[0].numel()
            sub.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
            if sub.bias is not None:
                sub.bias.zero_()


def init_sdxl_weights(model, seed: int, device: torch.device | str) -> None:
    """Seeded random weights for every module of `model`, on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules().values():
        _init_module(module, gen, device)
    model.device = device
