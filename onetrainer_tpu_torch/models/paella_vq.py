"""Paella VQGAN (Würstchen stage A): the decoder, and the encoder's path.

Counterpart of onetrainer_tpu/models/paella_vq.py (the diffusers
`PaellaVQModel` the reference decodes samples through, without vector
quantization: the sampler decodes `scale_factor * latents` and clamps to
[0, 1]). Decoder: a 1x1 conv latent -> embed_dim (`up_blocks.0.0`), 12
MixingResidualBlocks, a 4x4 stride-2 transposed conv (`up_blocks.13`), one
MixingResidualBlock at embed_dim / 2, a 1x1 conv to out * 4 channels and a
pixel shuffle (`out_block.0`). A MixingResidualBlock modulates two
LayerNorm (no affine) branches with six scalar `gammas`: a depthwise 3x3
over an edge-padded input, and the channelwise MLP with GRN. The encoder
(pixel unshuffle, 1x1 conv, mixing blocks with a 4x4 stride-2 conv
between levels, a 1x1 conv and BatchNorm to the latent channels) is
carried for completeness; nothing trains or encodes through it. NHWC,
computed in `cfg.dtype` (fp32 by default).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.cascade import pixel_shuffle, pixel_unshuffle
from onetrainer_tpu_torch.models.wuerstchen import (
    FrozenBatchNorm, channelwise, layer_norm_no_affine, nhwc_conv, run_channelwise,
)


@dataclass(frozen=True)
class PaellaVQConfig:
    in_channels: int = 3
    out_channels: int = 3
    up_down_scale_factor: int = 2
    levels: int = 2
    bottleneck_blocks: int = 12
    embed_dim: int = 384
    latent_channels: int = 4
    scale_factor: float = 0.3764
    dtype: torch.dtype = torch.float32

    @property
    def c_levels(self) -> tuple:
        return tuple(self.embed_dim // (2 ** (self.levels - 1 - i)) for i in range(self.levels))


class MixingResidualBlock(nn.Module):
    def __init__(self, c: int, embed: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gammas = nn.Parameter(torch.zeros(6))
        self.depthwise = nn.ModuleList([nn.Identity(), nn.Conv2d(c, c, 3, groups=c)])
        self.channelwise = channelwise(c, c, embed)

    def forward(self, x):
        g = self.gammas.float()
        h = layer_norm_no_affine(x) * (1 + g[0]) + g[1]
        h = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
        x = x + nhwc_conv(self.depthwise[1], h, self.dtype) * g[2]
        h = layer_norm_no_affine(x) * (1 + g[3]) + g[4]
        return x + run_channelwise(self.channelwise, h, self.dtype) * g[5]


class PaellaVQDecoder(nn.Module):
    """up_blocks + out_block of PaellaVQModel: [B, h, w, 4] -> [B, 4h, 4w, 3]."""

    def __init__(self, cfg: PaellaVQConfig):
        super().__init__()
        self.cfg = cfg
        c_levels, dt = cfg.c_levels, cfg.dtype
        blocks = [nn.ModuleList([nn.Conv2d(cfg.latent_channels, c_levels[-1], 1)])]
        for i in range(cfg.levels):
            c = c_levels[cfg.levels - 1 - i]
            for _ in range(cfg.bottleneck_blocks if i == 0 else 1):
                blocks.append(MixingResidualBlock(c, c * 4, dt))
            if i < cfg.levels - 1:
                blocks.append(nn.ConvTranspose2d(c, c_levels[cfg.levels - 2 - i], 4, stride=2,
                                                 padding=1))
        self.up_blocks = nn.ModuleList(blocks)
        self.out_block = nn.ModuleList([nn.Conv2d(
            c_levels[0], cfg.out_channels * cfg.up_down_scale_factor ** 2, 1)])

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        x = nhwc_conv(self.up_blocks[0][0], latents.to(dt), dt)
        for block in self.up_blocks[1:]:
            if isinstance(block, nn.ConvTranspose2d):
                y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), block.weight.to(dt),
                                       block.bias.to(dt), block.stride, block.padding)
                x = y.permute(0, 2, 3, 1)
            else:
                x = block(x)
        x = nhwc_conv(self.out_block[0], x, dt)
        return pixel_shuffle(x, cfg.up_down_scale_factor)


class PaellaVQEncoder(nn.Module):
    """in_block + down_blocks of PaellaVQModel (continuous latents, before
    the quantizer): [B, H, W, 3] -> [B, H/4, W/4, 4]."""

    def __init__(self, cfg: PaellaVQConfig):
        super().__init__()
        self.cfg = cfg
        c_levels, dt = cfg.c_levels, cfg.dtype
        self.in_block = nn.ModuleList([nn.Identity(), nn.Conv2d(
            cfg.in_channels * cfg.up_down_scale_factor ** 2, c_levels[0], 1)])
        blocks = []
        for i in range(cfg.levels):
            if i > 0:
                blocks.append(nn.Conv2d(c_levels[i - 1], c_levels[i], 4, stride=2, padding=1))
            blocks.append(MixingResidualBlock(c_levels[i], c_levels[i] * 4, dt))
        blocks.append(nn.ModuleList([
            nn.Conv2d(c_levels[-1], cfg.latent_channels, 1, bias=False),
            FrozenBatchNorm(cfg.latent_channels, eps=1e-5)]))
        self.down_blocks = nn.ModuleList(blocks)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        x = pixel_unshuffle(pixels.to(dt), cfg.up_down_scale_factor)
        x = nhwc_conv(self.in_block[1], x, dt)
        for block in self.down_blocks[:-1]:
            x = nhwc_conv(block, x, dt) if isinstance(block, nn.Conv2d) else block(x)
        last = self.down_blocks[-1]
        return last[1](nhwc_conv(last[0], x, dt))
