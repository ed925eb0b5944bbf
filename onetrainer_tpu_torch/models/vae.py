"""AutoencoderKL (SD-family VAE), NHWC at the public edges.

Counterpart of onetrainer_tpu/models/vae.py. Module names follow
diffusers' `AutoencoderKL`. The mid-block attention is single-head
attention over all positions; the reference leaves it to XLA
(`jax.nn.dot_product_attention`), and the port leaves it to PyTorch's
`scaled_dot_product_attention`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.layers import conv, group_norm, linear


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def spatial_scale(self) -> int:
        """pixels per latent cell (8 for the SD VAE: 3 downsamples)."""
        return 2 ** (len(self.block_out_channels) - 1)


def sd15_vae_config(**overrides) -> VAEConfig:
    return VAEConfig(**overrides)


def sdxl_vae_config(**overrides) -> VAEConfig:
    return VAEConfig(scaling_factor=0.13025, **overrides)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = nn.GroupNorm(32, out_channels, eps=1e-6)
        self.conv2 = _conv3(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        dt = self.dtype
        h = conv(self.conv1, F.silu(group_norm(self.norm1, x, dt)), dt)
        h = conv(self.conv2, F.silu(group_norm(self.norm2, h, dt)), dt)
        if self.conv_shortcut is not None:
            x = conv(self.conv_shortcut, x, dt)
        return x.to(dt) + h


class VAEAttention(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.group_norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):   # NCHW
        dt = self.dtype
        b, c, h, w = x.shape
        t = group_norm(self.group_norm, x, dt).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
        out = F.scaled_dot_product_attention(
            linear(self.to_q, t, dt), linear(self.to_k, t, dt),
            linear(self.to_v, t, dt))
        out = linear(self.to_out[0], out, dt).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return out + x.to(dt)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList(VAEResnetBlock(channels, channels, dtype)
                                     for _ in range(2))
        self.attentions = nn.ModuleList([VAEAttention(channels, dtype)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEDownsampler(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        # asymmetric pad: one row at the bottom, one column at the right
        return conv(self.conv, F.pad(x, (0, 1, 0, 1)), self.dtype)


class VAEUpsampler(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = _conv3(channels, channels)

    def forward(self, x):
        return conv(self.conv, F.interpolate(x, scale_factor=2, mode="nearest"),
                    self.dtype)


class DownEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, layers: int,
                 add_downsample: bool, dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_channels if j == 0 else channels, channels, dtype)
            for j in range(layers))
        self.downsamplers = (nn.ModuleList([VAEDownsampler(channels, dtype)])
                             if add_downsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, layers: int,
                 add_upsample: bool, dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_channels if j == 0 else channels, channels, dtype)
            for j in range(layers))
        self.upsamplers = (nn.ModuleList([VAEUpsampler(channels, dtype)])
                           if add_upsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        self.conv_in = _conv3(cfg.in_channels, boc[0])
        self.down_blocks = nn.ModuleList(
            DownEncoderBlock(boc[max(i - 1, 0)], ch, cfg.layers_per_block,
                             i != len(boc) - 1, cfg.dtype)
            for i, ch in enumerate(boc))
        self.mid_block = VAEMidBlock(boc[-1], cfg.dtype)
        self.conv_norm_out = nn.GroupNorm(32, boc[-1], eps=1e-6)
        self.conv_out = _conv3(boc[-1], 2 * cfg.latent_channels)

    def forward(self, x):   # NCHW
        dt = self.cfg.dtype
        x = conv(self.conv_in, x, dt)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        x = F.silu(group_norm(self.conv_norm_out, x, dt))
        return conv(self.conv_out, x, torch.float32)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = _conv3(cfg.latent_channels, rev[0])
        self.mid_block = VAEMidBlock(rev[0], cfg.dtype)
        self.up_blocks = nn.ModuleList(
            UpDecoderBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                           i != len(rev) - 1, cfg.dtype)
            for i, ch in enumerate(rev))
        self.conv_norm_out = nn.GroupNorm(32, rev[-1], eps=1e-6)
        self.conv_out = _conv3(rev[-1], cfg.out_channels)

    def forward(self, z):   # NCHW
        dt = self.cfg.dtype
        x = self.mid_block(conv(self.conv_in, z, dt))
        for block in self.up_blocks:
            x = block(x)
        x = F.silu(group_norm(self.conv_norm_out, x, dt))
        return conv(self.conv_out, x, torch.float32)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """image NHWC in [-1, 1] -> (mean, logvar) NHWC of the latent."""
        moments = conv(self.quant_conv, self.encoder(x.permute(0, 3, 1, 2)),
                       torch.float32).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latent NHWC -> image NHWC (fp32)."""
        z = conv(self.post_quant_conv, z.permute(0, 3, 1, 2), torch.float32)
        return self.decoder(z).permute(0, 2, 3, 1)
