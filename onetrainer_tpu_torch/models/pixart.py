"""PixArt-α/Σ DiT.

Counterpart of onetrainer_tpu/models/pixart.py (weight-parity contract with
`diffusers.PixArtTransformer2DModel`): the patchified 4-channel latents
with 2D sincos position embeddings, blocks of self-attention,
cross-attention to the projected T5 states and a GELU feed-forward under
AdaLN-single (one conditioning MLP shared by every block plus each block's
learned `scale_shift_table`), and the learned-variance output: 8 channels,
eps then the variance values that PixArt's VB loss trains
(math/losses.py:vb_losses). PixArt-α at 1024 px (sample size 128) adds
the resolution and aspect-ratio micro-conditions to the timestep
embedding. Module and parameter names follow diffusers (`pos_embed.proj`,
`adaln_single.emb.timestep_embedder.linear_1`, `adaln_single.linear`,
`caption_projection.linear_1`, `transformer_blocks.0.attn1.to_out.0`,
`transformer_blocks.0.ff.net.0.proj`, `scale_shift_table`), so the
reference's flax trees load through the port's copy of its key maps.

Parameters are fp32 unless the caller casts them; each op computes in
`cfg.dtype` (models/layers.py) and `proj_out` in fp32; the modulations
add the fp32 tables to the compute-dtype conditioning, and the residual
stream takes the promoted dtype, as the reference's arithmetic does. The
attention goes through ops/attention.py:attention: PixArt's d=72 heads
sit off the kernel's slots, so it is PyTorch's SDPA on the card too.
Under `gradient_checkpointing` every block is one recomputed segment
(models/remat.py, the "full" DiT policy). The reference's
scan-over-layers layout is not ported: the blocks run in a loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.flux import GeluMLP, MLPEmbedder, plain_layer_norm
from onetrainer_tpu_torch.models.layers import conv, linear
from onetrainer_tpu_torch.models.remat import checkpointed
from onetrainer_tpu_torch.models.unet import timestep_embedding
from onetrainer_tpu_torch.ops.attention import attention


@dataclass(frozen=True)
class PixArtConfig:
    sample_size: int = 64            # latent grid (64 = 512px)
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8            # 4 eps + 4 learned-variance
    num_layers: int = 28
    num_heads: int = 16
    head_dim: int = 72
    cross_attention_dim: int = 4096  # T5
    caption_channels: int = 4096
    # PixArt-alpha 1024 (sample_size 128) micro-conditions: resolution and
    # aspect-ratio sinusoidal embeddings added to the timestep embedding
    use_additional_conditions: bool = False
    gradient_checkpointing: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim


def pixart_alpha_config(**overrides) -> PixArtConfig:
    return PixArtConfig(**overrides)


def pixart_sigma_config(**overrides) -> PixArtConfig:
    return PixArtConfig(**overrides)


def sincos_pos_embed(dim: int, gh: int, gw: int, base_size: int = 64) -> np.ndarray:
    """2D sincos position embedding [gh * gw, dim], float64 (diffusers
    get_2d_sincos_pos_embed, grid scaled to `base_size`)."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(gh, dtype=np.float64) / (gh / base_size)
    grid_w = np.arange(gw, dtype=np.float64) / (gw / base_size)
    grid = np.meshgrid(grid_w, grid_h)  # w first
    grid = np.stack(grid, axis=0).reshape(2, 1, gh, gw)
    emb_h = _1d(dim // 2, grid[1])
    emb_w = _1d(dim // 2, grid[0])
    return np.concatenate([emb_h, emb_w], axis=1)


def _features(t: torch.Tensor) -> torch.Tensor:
    return timestep_embedding(t.float(), 256, flip_sin_to_cos=True, downscale_freq_shift=0)


class PixArtAttention(nn.Module):
    """Self-attention (context None) or cross-attention to the projected
    caption: to_q/to_k/to_v/to_out.0, all hidden wide."""

    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.hidden_size
        self.to_q = nn.Linear(inner, inner)
        self.to_k = nn.Linear(inner, inner)
        self.to_v = nn.Linear(inner, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])

    def forward(self, x, context=None):
        dt = self.cfg.dtype
        kv = x if context is None else context
        out = attention(linear(self.to_q, x, dt), linear(self.to_k, kv, dt),
                        linear(self.to_v, kv, dt), self.cfg.num_heads)
        return linear(self.to_out[0], out, dt)


class PixArtFF(GeluMLP):
    """diffusers FeedForward(activation="gelu-approximate"): net.0.proj to
    4x hidden, tanh GELU, net.2 back."""

    def __init__(self, cfg: PixArtConfig):
        super().__init__(cfg.hidden_size, cfg.dtype)


def _modulations(table: torch.Tensor, t6: torch.Tensor, hidden: int) -> list:
    mods = table[None] + t6.reshape(-1, 6, hidden)
    return [mods[:, i] for i in range(6)]


class PixArtBlock(nn.Module):
    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.cfg = cfg
        self.scale_shift_table = nn.Parameter(torch.zeros(6, cfg.hidden_size))
        self.attn1 = PixArtAttention(cfg)
        self.attn2 = PixArtAttention(cfg)
        self.ff = PixArtFF(cfg)

    def plain(self, x, context, t6):
        c = self.cfg
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            _modulations(self.scale_shift_table, t6, c.hidden_size)
        n = plain_layer_norm(x, c.dtype) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        x = x + gate_msa[:, None] * self.attn1(n)
        x = x + self.attn2(x, context)
        n = plain_layer_norm(x, c.dtype) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        return x + gate_mlp[:, None] * self.ff(n)

    def forward(self, x, context, t6):
        if self.cfg.gradient_checkpointing:
            return checkpointed(self.plain, x, context, t6)
        return self.plain(x, context, t6)


class _TimestepInner(nn.Module):
    """The timestep embedding, plus α-1024's resolution and aspect-ratio
    embeddings (each hidden / 3 wide: two resolution chunks and one aspect
    ratio chunk make the hidden width)."""

    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.cfg = cfg
        self.timestep_embedder = MLPEmbedder(256, cfg.hidden_size, cfg.dtype)
        if cfg.use_additional_conditions:
            size_dim = cfg.hidden_size // 3
            self.resolution_embedder = MLPEmbedder(256, size_dim, cfg.dtype)
            self.aspect_ratio_embedder = MLPEmbedder(256, size_dim, cfg.dtype)

    def forward(self, t_emb, resolution=None, aspect_ratio=None):
        emb = self.timestep_embedder(t_emb)
        if self.cfg.use_additional_conditions:
            b = t_emb.shape[0]
            res_emb = self.resolution_embedder(_features(resolution.reshape(-1)))
            ar_emb = self.aspect_ratio_embedder(_features(aspect_ratio.reshape(-1)))
            emb = emb + torch.cat([res_emb.reshape(b, -1), ar_emb.reshape(b, -1)], dim=1)
        return emb


class AdaLNSingle(nn.Module):
    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.cfg = cfg
        self.emb = _TimestepInner(cfg)
        self.linear = nn.Linear(cfg.hidden_size, 6 * cfg.hidden_size)

    def forward(self, timestep, resolution=None, aspect_ratio=None):
        """-> (the 6 x hidden modulations, the embedded timestep), as
        diffusers' AdaLayerNormSingle: the final norm takes the latter."""
        emb = self.emb(_features(timestep), resolution, aspect_ratio)
        return linear(self.linear, F.silu(emb), self.cfg.dtype), emb


class CaptionProjection(nn.Module):
    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.linear_1 = nn.Linear(cfg.caption_channels, cfg.hidden_size)
        self.linear_2 = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, caption):
        x = F.gelu(linear(self.linear_1, caption, self.dtype), approximate="tanh")
        return linear(self.linear_2, x, self.dtype)


class _PatchProj(nn.Module):
    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.dtype = cfg.dtype
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_size, p, stride=p)

    def forward(self, latents):   # NHWC -> NHWC
        return conv(self.proj, latents.permute(0, 3, 1, 2), self.dtype).permute(0, 2, 3, 1)


class PixArtTransformer2D(nn.Module):
    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.cfg = cfg
        self.pos_embed = _PatchProj(cfg)
        self.adaln_single = AdaLNSingle(cfg)
        self.caption_projection = CaptionProjection(cfg)
        self.transformer_blocks = nn.ModuleList(PixArtBlock(cfg) for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(torch.zeros(2, cfg.hidden_size))
        p = cfg.patch_size
        self.proj_out = nn.Linear(cfg.hidden_size, p * p * cfg.out_channels)

    def forward(
            self,
            latents: torch.Tensor,    # [B, H, W, 4]
            timestep: torch.Tensor,   # [B] int in [0, 1000)
            context: torch.Tensor,    # [B, S, caption_channels] (T5)
            resolution: torch.Tensor | None = None,    # [B, 2] (h, w) px
            aspect_ratio: torch.Tensor | None = None,  # [B, 1] h / w
    ) -> torch.Tensor:
        """-> [B, H, W, out_channels] fp32: eps, then the variance values."""
        c = self.cfg
        b = latents.shape[0]
        p = c.patch_size
        x = self.pos_embed(latents.to(c.dtype))
        gh, gw = x.shape[1], x.shape[2]
        x = x.reshape(b, gh * gw, c.hidden_size)
        pos = sincos_pos_embed(c.hidden_size, gh, gw, base_size=c.sample_size // p)
        x = x + torch.as_tensor(pos, device=x.device).to(c.dtype)[None]

        t6, embedded_t = self.adaln_single(timestep.float(), resolution, aspect_ratio)
        ctx = self.caption_projection(context)
        for block in self.transformer_blocks:
            x = block(x, ctx, t6)

        mods = self.scale_shift_table[None] + embedded_t.float()[:, None]
        shift, scale = mods[:, 0], mods[:, 1]
        x = plain_layer_norm(x, c.dtype) * (1 + scale[:, None]) + shift[:, None]
        x = linear(self.proj_out, x, torch.float32)
        x = x.reshape(b, gh, gw, p, p, c.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * p, gw * p, c.out_channels)
