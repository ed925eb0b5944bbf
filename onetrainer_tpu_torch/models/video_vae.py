"""Causal 3D video VAE (HunyuanVideo's): 4x temporal and 8x spatial
compression into 16 latent channels.

Counterpart of onetrainer_tpu/models/video_vae.py. Every temporal
convolution pads on the left only (the past), so a frame's latent depends
on it and the frames before it, and a single image encodes as a 1-frame
video. Downsampling halves time on the first two stages while a clip has
more than one frame; upsampling doubles time without duplicating the first
frame into the past (2T - 1 frames). NDHWC at the public edges (the
reference's layout), NCDHW inside; the convolutions are PyTorch's
`conv3d`, as the reference's are XLA's.

Module and parameter names follow the reference's flax tree through the
generic key map (`encoder.down_blocks.0.1.conv1.weight`,
`decoder.upsamplers.3.conv.bias`): a convolution's weight is
[out, in, kt, kh, kw]. Numerics kept from the reference: a convolution
computes in its weight's dtype and casts to its input's; the group norms
take fp32 statistics and cast to `cfg.dtype` (32 groups where the channels
allow, else one per channel); the decoder returns fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.layers import group_norm


@dataclass(frozen=True)
class VideoVAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    temporal_compression: int = 4
    spatial_compression: int = 8
    scaling_factor: float = 0.476986
    dtype: torch.dtype = torch.bfloat16

    @property
    def spatial_scale(self) -> int:
        return self.spatial_compression


def hunyuan_video_vae_config(**overrides) -> VideoVAEConfig:
    return VideoVAEConfig(**overrides)


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32 if channels % 32 == 0 else channels, channels, eps=1e-6)


def _temporal_stages(cfg: VideoVAEConfig) -> int:
    return {4: 2, 2: 1, 1: 0}[cfg.temporal_compression]


# the most elements one convolution call takes: cuDNN indexes its
# operands with 32-bit integers (a 33-frame 512x512 clip's last upsampler
# input is 2.2e9 elements)
MAX_CONV_ELEMENTS = 2 ** 31 - 1


class CausalConv3d(nn.Conv3d):
    """Conv3d with causal (left-only) temporal padding, spatial padding
    (k-1)//2 before and k//2 after, on NCDHW. An input too large for one
    call runs in chunks of output frames, each over the input frames it
    reads (every output element is the same sum)."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(3, 3, 3),
                 stride=(1, 1, 1)):
        super().__init__(in_channels, out_channels, kernel, stride=stride)

    def _conv(self, xp, stride):
        w = self.weight
        y = F.conv3d(xp.to(w.dtype), w, None, stride)
        return y + self.bias.to(w.dtype)[:, None, None, None]

    def forward(self, x, stride=None):
        kt, kh, kw = self.kernel_size
        stride = stride or self.stride
        xp = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2, kt - 1, 0))
        t_in, st = xp.shape[2], stride[0]
        t_out = (t_in - kt) // st + 1
        per_frame = xp[:, :, :1].numel()
        # output frames per call, so that the frames they read fit one call
        chunk = max((MAX_CONV_ELEMENTS // per_frame - kt) // st + 1, 1)
        if chunk >= t_out:
            return self._conv(xp, stride).to(x.dtype)
        parts = [self._conv(xp[:, :, o0 * st:(min(o0 + chunk, t_out) - 1) * st + kt],
                            stride).to(x.dtype)
                 for o0 in range(0, t_out, chunk)]
        return torch.cat(parts, dim=2)


class VideoResBlock(nn.Module):
    """Two causal 3x3x3 convolutions behind group norms and SiLU, added to
    the input (every block keeps its width, so the reference's shortcut
    convolution never exists)."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _norm(channels)
        self.conv1 = CausalConv3d(channels, channels)
        self.norm2 = _norm(channels)
        self.conv2 = CausalConv3d(channels, channels)

    def forward(self, x):
        dt = self.dtype
        h = self.conv1(F.silu(group_norm(self.norm1, x, dt)))
        return x + self.conv2(F.silu(group_norm(self.norm2, h, dt)))


class VideoDown(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temporal: bool):
        super().__init__()
        self.temporal = temporal
        self.conv = CausalConv3d(in_channels, out_channels)

    def forward(self, x):
        st = 2 if self.temporal and x.shape[2] > 1 else 1
        return self.conv(x, stride=(st, 2, 2))


class VideoUp(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temporal: bool):
        super().__init__()
        self.temporal = temporal
        self.conv = CausalConv3d(in_channels, out_channels)

    def forward(self, x):
        b, c, t, h, w = x.shape
        if self.temporal and t > 1:
            # causal: the first frame is not duplicated into the past
            x = x[:, :, :, None].expand(b, c, t, 2, h, w).reshape(b, c, 2 * t, h, w)[:, :, 1:]
            t = 2 * t - 1
        x = x[:, :, :, :, None, :, None].expand(b, c, t, h, 2, w, 2)
        return self.conv(x.reshape(b, c, t, 2 * h, 2 * w))


class VideoEncoder(nn.Module):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        self.cfg = cfg
        chans, n_temporal = cfg.block_out_channels, _temporal_stages(cfg)
        self.conv_in = CausalConv3d(cfg.in_channels, chans[0])
        # each stage keeps its width; the downsampler after it widens
        self.down_blocks = nn.ModuleList(
            nn.ModuleList(VideoResBlock(ch, cfg.dtype)
                          for _ in range(cfg.layers_per_block)) for ch in chans)
        self.downsamplers = nn.ModuleList(
            VideoDown(chans[s], chans[s + 1], temporal=s < n_temporal)
            for s in range(len(chans) - 1))
        self.mid_block = VideoResBlock(chans[-1], cfg.dtype)
        self.conv_norm_out = _norm(chans[-1])
        self.conv_out = CausalConv3d(chans[-1], 2 * cfg.latent_channels)

    def forward(self, x):
        dt = self.cfg.dtype
        x = self.conv_in(x.to(dt))
        for s, stage in enumerate(self.down_blocks):
            for block in stage:
                x = block(x)
            if s < len(self.downsamplers):
                x = self.downsamplers[s](x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(group_norm(self.conv_norm_out, x, dt)))


class VideoDecoder(nn.Module):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        self.cfg = cfg
        chans, n_temporal = cfg.block_out_channels, _temporal_stages(cfg)
        self.conv_in = CausalConv3d(cfg.latent_channels, chans[-1])
        self.mid_block = VideoResBlock(chans[-1], cfg.dtype)
        # each stage keeps its width; stages 1.. upsample into the
        # (narrower) stage below them
        self.up_blocks = nn.ModuleList(
            nn.ModuleList(VideoResBlock(ch, cfg.dtype)
                          for _ in range(cfg.layers_per_block)) for ch in chans)
        self.upsamplers = nn.ModuleDict({
            str(s): VideoUp(chans[s], chans[s - 1], temporal=(s - 1) < n_temporal)
            for s in range(1, len(chans))})
        self.conv_norm_out = _norm(chans[0])
        self.conv_out = CausalConv3d(chans[0], cfg.in_channels)

    def forward(self, z):
        dt = self.cfg.dtype
        x = self.mid_block(self.conv_in(z.to(dt)))
        for s in reversed(range(len(self.up_blocks))):
            for block in self.up_blocks[s]:
                x = block(x)
            if s > 0:
                x = self.upsamplers[str(s)](x)
        return self.conv_out(F.silu(group_norm(self.conv_norm_out, x, dt))).float()


def _to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class AutoencoderKLVideo(nn.Module):
    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = VideoEncoder(cfg)
        self.decoder = VideoDecoder(cfg)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, H, W, 3] -> (mean, logvar) [B, T', H/8, W/8, 16]."""
        moments = _to_ndhwc(self.encoder(_to_ncdhw(x)))
        return moments.chunk(2, dim=-1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, T', h, w, 16] -> [B, T, 8h, 8w, 3] fp32."""
        return _to_ndhwc(self.decoder(_to_ncdhw(z)))
