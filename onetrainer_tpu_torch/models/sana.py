"""Sana linear-attention DiT.

Counterpart of onetrainer_tpu/models/sana.py (reference:
modules/model/SanaModel.py imports diffusers SanaTransformer2DModel): the
patch embedding, the timestep embedding and its AdaLN-single projection,
the caption projection and RMS norm, blocks of ReLU linear self-attention
(two fp32 contractions, no S x S matrix: models/dcae.py:
relu_linear_attention), cross-attention to the Gemma-2 states under their
keep mask, and the GLUMBConv feed-forward (1x1 expand, depthwise 3x3, SiLU
gate, 1x1 project on the 2D token grid), each block with its learned
`scale_shift_table`, then the final modulation and `proj_out`. Module and
parameter names follow diffusers (`patch_embed.proj`,
`time_embed.emb.timestep_embedder.linear_1`, `time_embed.linear`,
`caption_projection.linear_1`, `caption_norm`,
`transformer_blocks.0.ff.conv_depth`), as the reference's key maps carry
them.

Numerics as the reference's: parameters fp32 unless the caller casts them,
each op in `cfg.dtype` (models/layers.py) and `proj_out` in fp32, the fp32
tables added to the compute-dtype conditioning. The cross-attention's
d=112 heads sit off the kernel's slots, so it is PyTorch's SDPA on the
card; a sample whose keep mask drops every caption token (conditioning
dropout zeroes it) attends uniformly, to the mean of v, as the reference's
masked softmax does where every logit takes the same fill. Under
`gradient_checkpointing` every block is one recomputed segment (the
"full" DiT policy of models/remat.py). The reference's scan-over-layers
layout is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.dcae import relu_linear_attention
from onetrainer_tpu_torch.models.flux import MLPEmbedder, plain_layer_norm
from onetrainer_tpu_torch.models.layers import conv, linear
from onetrainer_tpu_torch.models.pixart import CaptionProjection, _modulations
from onetrainer_tpu_torch.models.remat import checkpointed
from onetrainer_tpu_torch.models.unet import timestep_embedding
from onetrainer_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class SanaConfig:
    in_channels: int = 32
    out_channels: int = 32
    num_layers: int = 20
    num_attention_heads: int = 70
    attention_head_dim: int = 32
    num_cross_attention_heads: int = 20
    cross_attention_head_dim: int = 112
    caption_channels: int = 2304
    mlp_ratio: float = 2.5
    patch_size: int = 1
    qkv_bias: bool = False               # attn1 (detected from the checkpoint)
    cross_qkv_bias: bool = True          # attn2
    gradient_checkpointing: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def sana_config(**overrides) -> SanaConfig:
    return SanaConfig(**overrides)


class SanaRMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class SanaLinearAttention(nn.Module):
    """ReLU-kernel linear self-attention (diffusers SanaLinearAttnProcessor2_0)."""

    def __init__(self, cfg: SanaConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.to_q = nn.Linear(dim, dim, bias=cfg.qkv_bias)
        self.to_k = nn.Linear(dim, dim, bias=cfg.qkv_bias)
        self.to_v = nn.Linear(dim, dim, bias=cfg.qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x):
        c = self.cfg
        dt = c.dtype
        b, n, dim = x.shape
        h, d = c.num_attention_heads, c.attention_head_dim
        q, k, v = (linear(layer, x, dt).reshape(b, n, h, d)
                   for layer in (self.to_q, self.to_k, self.to_v))
        out = relu_linear_attention(q, k, v).reshape(b, n, dim).to(dt)
        return linear(self.to_out[0], out, dt)


class SanaCrossAttention(nn.Module):
    def __init__(self, cfg: SanaConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_cross_attention_heads * cfg.cross_attention_head_dim
        self.to_q = nn.Linear(cfg.hidden_size, inner, bias=cfg.cross_qkv_bias)
        self.to_k = nn.Linear(cfg.hidden_size, inner, bias=cfg.cross_qkv_bias)
        self.to_v = nn.Linear(cfg.hidden_size, inner, bias=cfg.cross_qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, cfg.hidden_size)])

    def forward(self, x, context, context_mask=None):
        c = self.cfg
        dt = c.dtype
        h, d = c.num_cross_attention_heads, c.cross_attention_head_dim
        b, n, _ = x.shape
        s = context.shape[1]
        q = linear(self.to_q, x, dt).reshape(b, n, h, d)
        k = linear(self.to_k, context, dt).reshape(b, s, h, d)
        v = linear(self.to_v, context, dt).reshape(b, s, h, d)
        if context_mask is None:
            out = dot_product_attention(q, k, v)
        else:
            keep = context_mask.to(torch.bool)
            empty = ~keep.any(dim=-1)
            out = dot_product_attention(q, k, v, mask=(keep | empty[:, None])[:, None, None, :])
            uniform = v.float().mean(dim=1, keepdim=True).to(out.dtype).expand_as(out)
            out = torch.where(empty[:, None, None, None], uniform, out)
        return linear(self.to_out[0], out.reshape(b, n, h * d), dt)


class GLUMBConv(nn.Module):
    """1x1 expand x2, SiLU, depthwise 3x3, SiLU gate, 1x1 project (diffusers
    GLUMBConv), on the 2D token grid."""

    def __init__(self, cfg: SanaConfig):
        super().__init__()
        self.dtype = cfg.dtype
        dim = cfg.hidden_size
        mid = int(dim * cfg.mlp_ratio)
        self.conv_inverted = nn.Conv2d(dim, mid * 2, 1)
        self.conv_depth = nn.Conv2d(mid * 2, mid * 2, 3, padding=1, groups=mid * 2)
        self.conv_point = nn.Conv2d(mid, dim, 1, bias=False)

    def forward(self, x, gh: int, gw: int):
        dt = self.dtype
        b, n, dim = x.shape
        h = x.reshape(b, gh, gw, dim).permute(0, 3, 1, 2)
        h = conv(self.conv_depth, F.silu(conv(self.conv_inverted, h, dt)), dt)
        h, gate = h.chunk(2, dim=1)
        h = conv(self.conv_point, h * F.silu(gate), dt)
        return h.permute(0, 2, 3, 1).reshape(b, n, dim)


class SanaBlock(nn.Module):
    def __init__(self, cfg: SanaConfig):
        super().__init__()
        self.cfg = cfg
        self.scale_shift_table = nn.Parameter(torch.zeros(6, cfg.hidden_size))
        self.attn1 = SanaLinearAttention(cfg)
        self.attn2 = SanaCrossAttention(cfg)
        self.ff = GLUMBConv(cfg)

    def plain(self, x, context, context_mask, t6, gh: int, gw: int):
        c = self.cfg
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            _modulations(self.scale_shift_table, t6, c.hidden_size)
        n = plain_layer_norm(x, c.dtype) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        x = x + gate_msa[:, None] * self.attn1(n)
        # the cross-attention takes the raw hidden state (no pre-norm)
        x = x + self.attn2(x, context, context_mask)
        n = plain_layer_norm(x, c.dtype) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        return x + gate_mlp[:, None] * self.ff(n, gh, gw)

    def forward(self, x, context, context_mask, t6, gh: int, gw: int):
        if self.cfg.gradient_checkpointing:
            return checkpointed(self.plain, x, context, context_mask, t6, gh, gw)
        return self.plain(x, context, context_mask, t6, gh, gw)


class _TimeEmbed(nn.Module):
    """time_embed: emb.timestep_embedder (the MLP) and linear (to 6 x hidden)."""

    def __init__(self, cfg: SanaConfig):
        super().__init__()
        self.emb = nn.Module()
        self.emb.timestep_embedder = MLPEmbedder(256, cfg.hidden_size, cfg.dtype)
        self.linear = nn.Linear(cfg.hidden_size, 6 * cfg.hidden_size)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SanaConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_size, p, stride=p)


class SanaTransformer2D(nn.Module):
    def __init__(self, cfg: SanaConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.time_embed = _TimeEmbed(cfg)
        self.caption_projection = CaptionProjection(cfg)
        self.caption_norm = SanaRMSNorm(cfg.hidden_size)
        self.transformer_blocks = nn.ModuleList(SanaBlock(cfg) for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(torch.zeros(2, cfg.hidden_size))
        p = cfg.patch_size
        self.proj_out = nn.Linear(cfg.hidden_size, p * p * cfg.out_channels)

    def forward(
            self,
            latents: torch.Tensor,        # [B, H, W, in_channels] NHWC
            timestep: torch.Tensor,       # [B]
            context: torch.Tensor,        # [B, S, caption_channels]
            context_mask: torch.Tensor | None = None,   # [B, S] keep mask
    ) -> torch.Tensor:
        """-> the flow [B, H, W, out_channels], fp32."""
        c = self.cfg
        dt = c.dtype
        b = latents.shape[0]
        p = c.patch_size
        x = conv(self.patch_embed.proj, latents.to(dt).permute(0, 3, 1, 2), dt)
        gh, gw = x.shape[2], x.shape[3]
        x = x.permute(0, 2, 3, 1).reshape(b, gh * gw, c.hidden_size)

        t_emb = timestep_embedding(timestep.float(), 256, flip_sin_to_cos=True,
                                   downscale_freq_shift=0)
        emb = self.time_embed.emb.timestep_embedder(t_emb)
        t6 = linear(self.time_embed.linear, F.silu(emb), dt)
        ctx = self.caption_norm(self.caption_projection(context))

        for block in self.transformer_blocks:
            x = block(x, ctx, context_mask, t6, gh, gw)

        mods = self.scale_shift_table[None] + emb.reshape(-1, 1, c.hidden_size)
        shift, scale = mods[:, 0], mods[:, 1]
        x = plain_layer_norm(x, dt) * (1 + scale[:, None]) + shift[:, None]
        x = linear(self.proj_out, x, torch.float32)
        x = x.reshape(b, gh, gw, p, p, c.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * p, gw * p, c.out_channels)
