"""Deep-Compression Autoencoder (DC-AE f32c32), Sana's 32x VAE.

Counterpart of onetrainer_tpu/models/dcae.py (reference:
modules/model/SanaModel.py imports diffusers AutoencoderDC): the encoder
and decoder `conv_in`, stages of residual blocks (two 3x3 convs and a
channel RMS norm) and, in the deep stages, EfficientViT blocks (LiteMLA:
ReLU linear attention over the 1x1 qkv projection and its 5x5 depthwise
aggregation, then a GLUMBConv), 3x3 stride-2 convs down and nearest x2
upsampling plus a 3x3 conv up, the decoder's norm, SiLU and `conv_out`.
The latent is deterministic (no KL): `encode` returns it. Module names
follow the reference's flax tree through its key maps
(`encoder.down_blocks.3.0.attn.aggreg.0`, `decoder.upsamplers.5.conv`),
which round-trip within both packages; a diffusers AutoencoderDC file may
lay its blocks out differently (the reference's note, sana_checkpoints.py).

The public interface is NHWC, as the reference's; inside, the convs run
NCHW (models/layers.py: each op in `cfg.dtype`, the decoder's `conv_out`
in fp32), the RMS norms take fp32 statistics over the channels and cast
back, and the linear attention contracts in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.layers import conv


@dataclass(frozen=True)
class DCAEConfig:
    in_channels: int = 3
    latent_channels: int = 32
    encoder_block_out_channels: tuple[int, ...] = (128, 256, 512, 512, 1024, 1024)
    decoder_block_out_channels: tuple[int, ...] = (128, 256, 512, 512, 1024, 1024)
    encoder_layers_per_block: tuple[int, ...] = (2, 2, 2, 3, 3, 3)
    decoder_layers_per_block: tuple[int, ...] = (3, 3, 3, 3, 3, 3)
    vit_stages: tuple[bool, ...] = (False, False, False, True, True, True)
    attention_head_dim: int = 32
    scaling_factor: float = 0.41407
    dtype: torch.dtype = torch.bfloat16

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.encoder_block_out_channels) - 1)


def dcae_f32c32_config(**overrides) -> DCAEConfig:
    return DCAEConfig(**overrides)


def relu_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """ReLU-kernel linear attention over [B, N, H, D] tensors in fp32:
    out_i = (sum_j relu(k_j)^T v_j) relu(q_i) / (sum_j relu(k_j) . relu(q_i)
    + 1e-15), two contractions and no N x N matrix. -> [B, N, H, D] fp32."""
    q, k, v = F.relu(q).float(), F.relu(k).float(), v.float()
    kv = torch.einsum("bnhd,bnhe->bhde", k, v)
    ksum = k.sum(dim=1)
    num = torch.einsum("bnhd,bhde->bnhe", q, kv)
    den = torch.einsum("bnhd,bhd->bnh", q, ksum)[..., None] + 1e-15
    return num / den


class RMSNorm2d(nn.Module):
    """RMS norm over the channels of an NCHW tensor, with weight and bias."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=1, keepdim=True) + self.eps)
        return (y * self.weight.float()[:, None, None]
                + self.bias.float()[:, None, None]).to(x.dtype)


class DCAEResBlock(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.norm = RMSNorm2d(channels)

    def forward(self, x):
        h = F.silu(conv(self.conv1, x, self.dtype))
        return self.norm(conv(self.conv2, h, self.dtype)) + x


class GLUMBConvDC(nn.Module):
    """1x1 expand x2, SiLU, depthwise 3x3, SiLU gate, 1x1 project, RMS norm,
    residual."""

    def __init__(self, channels: int, dtype: torch.dtype, expand: float = 4.0):
        super().__init__()
        self.dtype = dtype
        mid = int(channels * expand)
        self.conv_inverted = nn.Conv2d(channels, mid * 2, 1)
        self.conv_depth = nn.Conv2d(mid * 2, mid * 2, 3, padding=1, groups=mid * 2)
        self.conv_point = nn.Conv2d(mid, channels, 1, bias=False)
        self.norm = RMSNorm2d(channels)

    def forward(self, x):
        dt = self.dtype
        h = conv(self.conv_depth, F.silu(conv(self.conv_inverted, x, dt)), dt)
        h, gate = h.chunk(2, dim=1)
        return self.norm(conv(self.conv_point, h * F.silu(gate), dt)) + x


class LiteMLA(nn.Module):
    """Lightweight multi-scale linear attention: the 1x1 qkv projection and
    its 5x5 depthwise aggregation each attend (ReLU linear attention), the
    two outputs concatenated on channels, projected, normed, residual."""

    def __init__(self, channels: int, head_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype, self.head_dim = dtype, head_dim
        c = channels
        self.qkv = nn.Conv2d(c, 3 * c, 1, bias=False)
        self.aggreg = nn.ModuleList([nn.Conv2d(3 * c, 3 * c, 5, padding=2, groups=3 * c,
                                               bias=False)])
        self.proj_out = nn.Conv2d(2 * c, c, 1, bias=False)
        self.norm_out = RMSNorm2d(c)

    def forward(self, x):
        dt = self.dtype
        b, c, h, w = x.shape
        heads = c // self.head_dim
        qkv = conv(self.qkv, x, dt)
        outs = []
        for branch in (qkv, conv(self.aggreg[0], qkv, dt)):
            tokens = branch.reshape(b, 3 * c, h * w).transpose(1, 2)
            q, k, v = (t.reshape(b, h * w, heads, self.head_dim)
                       for t in tokens.chunk(3, dim=-1))
            out = relu_linear_attention(q, k, v).reshape(b, h * w, c)
            outs.append(out.transpose(1, 2).reshape(b, c, h, w).to(dt))
        return self.norm_out(conv(self.proj_out, torch.cat(outs, dim=1), dt)) + x


class EfficientViTBlock(nn.Module):
    def __init__(self, channels: int, head_dim: int, dtype: torch.dtype):
        super().__init__()
        self.attn = LiteMLA(channels, head_dim, dtype)
        self.conv_out = GLUMBConvDC(channels, dtype)

    def forward(self, x):
        return self.conv_out(self.attn(x))


class DCDown(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, 3, stride=2, padding=1)

    def forward(self, x):
        return conv(self.conv, x, self.dtype)


class DCUp(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return conv(self.conv, x, self.dtype)


def _stage(channels: int, layers: int, vit: bool, head_dim: int, dtype) -> nn.ModuleList:
    return nn.ModuleList(EfficientViTBlock(channels, head_dim, dtype) if vit
                         else DCAEResBlock(channels, dtype) for _ in range(layers))


class DCAEEncoder(nn.Module):
    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.encoder_block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _stage(ch, cfg.encoder_layers_per_block[s], cfg.vit_stages[s],
                   cfg.attention_head_dim, cfg.dtype) for s, ch in enumerate(chans))
        self.downsamplers = nn.ModuleList(
            DCDown(chans[s], chans[s + 1], cfg.dtype) for s in range(len(chans) - 1))
        self.conv_out = nn.Conv2d(chans[-1], cfg.latent_channels, 3, padding=1)

    def forward(self, x):   # NCHW
        dt = self.cfg.dtype
        x = conv(self.conv_in, x, dt)
        for s, stage in enumerate(self.down_blocks):
            for block in stage:
                x = block(x)
            if s < len(self.downsamplers):
                x = self.downsamplers[s](x)
        return conv(self.conv_out, x, dt)


class DCAEDecoder(nn.Module):
    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.decoder_block_out_channels
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[-1], 3, padding=1)
        self.up_blocks = nn.ModuleList(
            _stage(ch, cfg.decoder_layers_per_block[s], cfg.vit_stages[s],
                   cfg.attention_head_dim, cfg.dtype) for s, ch in enumerate(chans))
        # upsamplers.{s} for s = 1..n-1 (up from stage s to stage s - 1)
        self.upsamplers = nn.ModuleDict(
            {str(s): DCUp(chans[s], chans[s - 1], cfg.dtype) for s in range(1, len(chans))})
        self.norm_out = RMSNorm2d(chans[0])
        self.conv_out = nn.Conv2d(chans[0], cfg.in_channels, 3, padding=1)

    def forward(self, z):   # NCHW
        dt = self.cfg.dtype
        x = conv(self.conv_in, z, dt)
        for s in reversed(range(len(self.up_blocks))):
            for block in self.up_blocks[s]:
                x = block(x)
            if s > 0:
                x = self.upsamplers[str(s)](x)
        return conv(self.conv_out, F.silu(self.norm_out(x)), torch.float32)


class AutoencoderDC(nn.Module):
    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = DCAEEncoder(cfg)
        self.decoder = DCAEDecoder(cfg)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images in [-1, 1] -> NHWC latents (unscaled), compute dtype."""
        return self.encoder(x.to(self.cfg.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latents (unscaled) -> NHWC images, fp32."""
        return self.decoder(z.to(self.cfg.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x):
        return self.decode(self.encode(x))
