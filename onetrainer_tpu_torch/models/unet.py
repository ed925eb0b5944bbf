"""UNet2DCondition for SD 1.5/2.x and SDXL, text-to-image and the
9-channel inpainting configs (the 5-channel SD 2.0 depth config is not
ported).

Counterpart of onetrainer_tpu/models/unet.py. Public layout is the
reference's: NHWC `sample` in, NHWC fp32 noise prediction out; convolutions
run NCHW inside. Parameters are fp32 and every op computes in `cfg.dtype`
(bf16 by default), cast per op. Module names follow diffusers
(`down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q`), so the
reference's `io/torch_flax.py` maps a flax tree onto `state_dict()` keys
one to one. Weights are plain `nn.Linear`/`nn.Conv2d`; LoRA adapters
attach to them (peft/lora.py) and `models/layers.py` applies them.

Gradient checkpointing (`cfg.gradient_checkpointing`) follows the
reference's remat policies with `torch.utils.checkpoint` (non-reentrant):
"tx_only" (the reference's SDXL default) recomputes each
BasicTransformerBlock in the backward and saves resnet activations; "full"
recomputes resnets too. The reference's other policies ("tx_attn", "dots",
"dots_nb", "attn", "dots_nb_attn", "depth") save chosen matmul or
attention outputs inside a remat region, which has no counterpart here
yet: they raise NotImplementedError.

Numerics kept from the reference: GEGLU's gate uses the tanh-approximate
gelu (flax's `nn.gelu` default); GroupNorm eps is 1e-6 in Transformer2D
and 1e-5 in resnets and `conv_norm_out`; `conv_out` computes in fp32;
upsampling is nearest x2; downsampling is a stride-2 conv with padding 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from onetrainer_tpu_torch.models.layers import conv, group_norm, layer_norm, linear
from onetrainer_tpu_torch.ops.attention import attention


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    # True = block has cross-attention transformers
    cross_attn_blocks: tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    transformer_layers_per_block: tuple[int, ...] = (1, 1, 1, 1)
    num_heads: tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    addition_embed_dim: int | None = None        # SDXL: 256
    addition_pooled_dim: int | None = None       # SDXL: 1280 (TE2 pooled)
    addition_time_ids: int = 6                   # SDXL micro-conditioning ids
    gradient_checkpointing: bool = False
    remat_policy: str = "full"                   # "full" or "tx_only"
    dtype: torch.dtype = torch.bfloat16


_REMAT_POLICIES = ("full", "tx_only")


def _maybe_checkpoint(fn, enabled: bool, *args):
    """fn(*args), recomputed in the backward when `enabled` and autograd
    records (a no-grad or inference call runs it plainly)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _checkpoint_resnets(cfg: UNetConfig) -> bool:
    return cfg.gradient_checkpointing and cfg.remat_policy == "full"


def sd15_unet_config(**overrides) -> UNetConfig:
    return UNetConfig(**overrides)


def sd15_inpaint_unet_config(**overrides) -> UNetConfig:
    """SD 1.5 inpainting: 4 noisy + 1 mask + 4 conditioning-latent channels."""
    return UNetConfig(in_channels=9, **overrides)


def sd21_unet_config(**overrides) -> UNetConfig:
    kwargs = dict(
        num_heads=(5, 10, 20, 20),
        cross_attention_dim=1024,
        use_linear_projection=True,
    )
    kwargs.update(overrides)
    return UNetConfig(**kwargs)


def sd21_inpaint_unet_config(**overrides) -> UNetConfig:
    """SD 2.0 inpainting: SD 2.x's UNet with 9 input channels."""
    return sd21_unet_config(in_channels=9, **overrides)


def sdxl_unet_config(**overrides) -> UNetConfig:
    kwargs = dict(
        block_out_channels=(320, 640, 1280),
        cross_attn_blocks=(False, True, True),
        transformer_layers_per_block=(1, 2, 10),
        num_heads=(5, 10, 20),
        cross_attention_dim=2048,
        use_linear_projection=True,
        addition_embed_dim=256,
        addition_pooled_dim=1280,
    )
    kwargs.update(overrides)
    return UNetConfig(**kwargs)


def sdxl_inpaint_unet_config(**overrides) -> UNetConfig:
    return sdxl_unet_config(in_channels=9, **overrides)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers Timesteps semantics), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return linear(self.linear_2, F.silu(linear(self.linear_1, x, self.dtype)),
                      self.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.GroupNorm(32, in_channels, eps=1e-5)
        self.conv1 = _conv3(in_channels, out_channels)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = nn.GroupNorm(32, out_channels, eps=1e-5)
        self.conv2 = _conv3(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):   # x NCHW
        dt = self.dtype
        h = conv(self.conv1, F.silu(group_norm(self.norm1, x, dt)), dt)
        h = h + linear(self.time_emb_proj, F.silu(temb), dt)[:, :, None, None]
        h = conv(self.conv2, F.silu(group_norm(self.norm2, h, dt)), dt)
        if self.conv_shortcut is not None:
            x = conv(self.conv_shortcut, x, dt)
        return x.to(dt) + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        dt = self.dtype
        context = x if context is None else context
        out = attention(linear(self.to_q, x, dt), linear(self.to_k, context, dt),
                        linear(self.to_v, context, dt), self.num_heads)
        return linear(self.to_out[0], out, dt)


class GEGLU(nn.Module):
    def __init__(self, dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(dim, out_dim * 2)

    def forward(self, x):
        x, gate = linear(self.proj, x, self.dtype).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        # diffusers layout: net.0 = GEGLU, net.1 = dropout, net.2 = Linear
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, dtype), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return linear(self.net[2], self.net[0](x), self.dtype)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, dtype)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x, context):
        dt = self.dtype
        x = x + self.attn1(layer_norm(self.norm1, x, dt))
        x = x + self.attn2(layer_norm(self.norm2, x, dt), context)
        return x + self.ff(layer_norm(self.norm3, x, dt))


class Transformer2D(nn.Module):
    def __init__(self, channels: int, context_dim: int, num_heads: int,
                 num_layers: int, use_linear_projection: bool,
                 dtype: torch.dtype, gradient_checkpointing: bool = False):
        super().__init__()
        self.dtype = dtype
        self.use_linear_projection = use_linear_projection
        self.gradient_checkpointing = gradient_checkpointing
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        proj = (nn.Linear if use_linear_projection
                else (lambda i, o: nn.Conv2d(i, o, 1)))
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, context_dim, num_heads, dtype)
            for _ in range(num_layers))
        self.proj_out = proj(channels, channels)

    def forward(self, x, context):   # x NCHW
        dt = self.dtype
        b, c, h, w = x.shape
        residual = x
        x = group_norm(self.norm, x, dt)
        if self.use_linear_projection:
            x = linear(self.proj_in, x.permute(0, 2, 3, 1).reshape(b, h * w, c), dt)
        else:
            x = conv(self.proj_in, x, dt).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = _maybe_checkpoint(block, self.gradient_checkpointing, x, context)
        if self.use_linear_projection:
            x = linear(self.proj_out, x, dt).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = conv(self.proj_out, x.reshape(b, h, w, c).permute(0, 3, 1, 2), dt)
        return x + residual.to(dt)


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = _conv3(channels, channels, stride=2)

    def forward(self, x):
        return conv(self.conv, x, self.dtype)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = _conv3(channels, channels)

    def forward(self, x):
        return conv(self.conv, F.interpolate(x, scale_factor=2, mode="nearest"),
                    self.dtype)


class DownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, block_index: int, in_channels: int):
        super().__init__()
        out_ch = cfg.block_out_channels[block_index]
        temb_dim = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if i == 0 else out_ch, out_ch, temb_dim, cfg.dtype)
            for i in range(cfg.layers_per_block))
        self.attentions = None
        if cfg.cross_attn_blocks[block_index]:
            self.attentions = nn.ModuleList(
                Transformer2D(out_ch, cfg.cross_attention_dim,
                              cfg.num_heads[block_index],
                              cfg.transformer_layers_per_block[block_index],
                              cfg.use_linear_projection, cfg.dtype,
                              cfg.gradient_checkpointing)
                for _ in range(cfg.layers_per_block))
        self.downsamplers = None
        if block_index != len(cfg.block_out_channels) - 1:
            self.downsamplers = nn.ModuleList([Downsample(out_ch, cfg.dtype)])
        self.checkpoint_resnets = _checkpoint_resnets(cfg)

    def forward(self, x, temb, context):
        hidden_states = []
        for i, resnet in enumerate(self.resnets):
            x = _maybe_checkpoint(resnet, self.checkpoint_resnets, x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            hidden_states.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            hidden_states.append(x)
        return x, hidden_states


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        temb_dim = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList(ResnetBlock(ch, ch, temb_dim, cfg.dtype)
                                     for _ in range(2))
        self.attentions = nn.ModuleList([Transformer2D(
            ch, cfg.cross_attention_dim, cfg.num_heads[-1],
            cfg.transformer_layers_per_block[-1], cfg.use_linear_projection,
            cfg.dtype, cfg.gradient_checkpointing)])
        self.checkpoint_resnets = _checkpoint_resnets(cfg)

    def forward(self, x, temb, context):
        ckpt = self.checkpoint_resnets
        x = _maybe_checkpoint(self.resnets[0], ckpt, x, temb)
        x = self.attentions[0](x, context)
        return _maybe_checkpoint(self.resnets[1], ckpt, x, temb)


class UpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, block_index: int,
                 resnet_in_channels: list[int]):
        super().__init__()
        n = len(cfg.block_out_channels)
        out_ch = cfg.block_out_channels[n - 1 - block_index]
        mirror = n - 1 - block_index   # the down block this one mirrors
        temb_dim = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList(ResnetBlock(cin, out_ch, temb_dim, cfg.dtype)
                                     for cin in resnet_in_channels)
        self.attentions = None
        if cfg.cross_attn_blocks[mirror]:
            self.attentions = nn.ModuleList(
                Transformer2D(out_ch, cfg.cross_attention_dim,
                              cfg.num_heads[mirror],
                              cfg.transformer_layers_per_block[mirror],
                              cfg.use_linear_projection, cfg.dtype,
                              cfg.gradient_checkpointing)
                for _ in resnet_in_channels)
        self.upsamplers = None
        if block_index != n - 1:
            self.upsamplers = nn.ModuleList([Upsample(out_ch, cfg.dtype)])
        self.checkpoint_resnets = _checkpoint_resnets(cfg)

    def forward(self, x, skips, temb, context):
        for i, resnet in enumerate(self.resnets):
            x = _maybe_checkpoint(
                resnet, self.checkpoint_resnets,
                torch.cat([x, skips.pop().to(x.dtype)], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        if cfg.gradient_checkpointing and cfg.remat_policy not in _REMAT_POLICIES:
            raise NotImplementedError(
                f"remat policy {cfg.remat_policy!r} is not ported yet "
                f"(ported: {', '.join(_REMAT_POLICIES)})")
        self.cfg = cfg
        boc = cfg.block_out_channels
        ch0 = boc[0]
        time_dim = ch0 * 4
        self.time_embedding = TimestepEmbedding(ch0, time_dim, cfg.dtype)
        self.add_embedding = None
        if cfg.addition_embed_dim is not None:
            self.add_embedding = TimestepEmbedding(
                cfg.addition_pooled_dim
                + cfg.addition_time_ids * cfg.addition_embed_dim,
                time_dim, cfg.dtype)
        self.conv_in = _conv3(cfg.in_channels, ch0)

        # channel bookkeeping of the skip connections, in forward order
        skip_channels = [ch0]
        self.down_blocks = nn.ModuleList()
        in_ch = ch0
        for i, out_ch in enumerate(boc):
            self.down_blocks.append(DownBlock(cfg, i, in_ch))
            skip_channels += [out_ch] * cfg.layers_per_block
            if i != len(boc) - 1:
                skip_channels.append(out_ch)
            in_ch = out_ch
        self.mid_block = MidBlock(cfg)
        self.up_blocks = nn.ModuleList()
        for i, out_ch in enumerate(reversed(boc)):
            resnet_in = []
            for j in range(cfg.layers_per_block + 1):
                resnet_in.append((in_ch if j == 0 else out_ch) + skip_channels.pop())
            self.up_blocks.append(UpBlock(cfg, i, resnet_in))
            in_ch = out_ch
        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=1e-5)
        self.conv_out = _conv3(ch0, cfg.out_channels)

    def forward(
            self,
            sample: torch.Tensor,                 # [B, H, W, C_in] NHWC
            timesteps: torch.Tensor,              # [B] int or float
            encoder_hidden_states: torch.Tensor,  # [B, S, cross_dim]
            added_text_embeds: torch.Tensor | None = None,  # SDXL pooled TE2 [B, 1280]
            added_time_ids: torch.Tensor | None = None,     # SDXL [B, 6]
    ) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        temb = self.time_embedding(
            timestep_embedding(timesteps, cfg.block_out_channels[0]))
        if self.add_embedding is not None:
            time_ids_emb = timestep_embedding(
                added_time_ids.reshape(-1), cfg.addition_embed_dim).reshape(
                added_time_ids.shape[0],
                cfg.addition_time_ids * cfg.addition_embed_dim)
            add_emb = torch.cat([added_text_embeds.float(), time_ids_emb], dim=-1)
            temb = temb + self.add_embedding(add_emb)

        context = encoder_hidden_states.to(dt)
        x = conv(self.conv_in, sample.permute(0, 3, 1, 2), dt)
        skips = [x]
        for block in self.down_blocks:
            x, hidden = block(x, temb, context)
            skips.extend(hidden)
        x = self.mid_block(x, temb, context)
        for block in self.up_blocks:
            x = block(x, skips, temb, context)
        x = F.silu(group_norm(self.conv_norm_out, x, dt))
        x = conv(self.conv_out, x, torch.float32)
        return x.permute(0, 2, 3, 1)
