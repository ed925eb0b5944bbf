"""Stable Diffusion 3 / 3.5 MMDiT.

Counterpart of onetrainer_tpu/models/sd3.py (weight-parity contract with
`diffusers.SD3Transformer2DModel`): patchified 16-channel latents, joint
(text + image) attention blocks with AdaLN-Zero, a last block that is
context-pre-only, a learned position table centre-cropped to the latent
grid, and SD3.5's RMS q/k norms behind `qk_norm`. Like the reference it
has no dual attention (SD3.5-medium's `attn2`): the loader refuses such
checkpoints (io/sd3_checkpoints.py, ROADMAP F9).

Public layout is the reference's: NHWC latents in, NHWC fp32 velocity out.
Parameters are fp32 and every op computes in `cfg.dtype`, cast per op;
`proj_out` computes in fp32. The joint attention puts the text rows first,
then the image rows, through `ops/attention.py:dot_product_attention`, so
on the card it runs K1 (forward) and K2/K3 (backward) on the ragged joint
sequence (154 + 4096 = 4250 tokens at 1024x1024).

Gradient checkpointing (`cfg.gradient_checkpointing`) runs the policy
`cfg.remat_policy` per block (models/remat.py): "full" recomputes the
block, "dots_nb_attn" (the reference's SD3 default) recomputes the halves
around the attention and keeps the weight matmuls' outputs and the
attention's residuals.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.flux import (
    AdaLayerNormZero, AdaNormContinuous, GELUProj, MLPEmbedder, RMSNorm, plain_layer_norm,
)
from onetrainer_tpu_torch.models.layers import conv, linear
from onetrainer_tpu_torch.models.remat import DIT_POLICIES, checkpointed
from onetrainer_tpu_torch.models.unet import timestep_embedding
from onetrainer_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class SD3Config:
    sample_size: int = 128           # latent grid (128 = 1024px)
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    num_heads: int = 24
    head_dim: int = 64
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: bool = False            # SD3.5
    gradient_checkpointing: bool = False
    remat_policy: str = "full"       # "full" or "dots_nb_attn"
    dtype: torch.dtype = torch.bfloat16

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim


def sd3_medium_config(**overrides) -> SD3Config:
    return SD3Config(**overrides)


def sd35_medium_config(**overrides) -> SD3Config:
    kwargs = dict(qk_norm=True, pos_embed_max_size=384)
    kwargs.update(overrides)
    return SD3Config(**kwargs)


def sd35_large_config(**overrides) -> SD3Config:
    kwargs = dict(num_layers=38, num_heads=38, qk_norm=True)
    kwargs.update(overrides)
    return SD3Config(**kwargs)


class PatchEmbed(nn.Module):
    """diffusers PatchEmbed: a p x p stride-p conv, plus the learned
    position table centre-cropped to the latent grid."""

    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_size, p, stride=p)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.pos_embed_max_size ** 2, cfg.hidden_size))

    def forward(self, latents):   # [B, H, W, C] NHWC
        c = self.cfg
        x = conv(self.proj, latents.permute(0, 3, 1, 2), c.dtype)
        b, _, gh, gw = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, gh * gw, c.hidden_size)
        m = c.pos_embed_max_size
        top, left = (m - gh) // 2, (m - gw) // 2
        pos = self.pos_embed.reshape(1, m, m, c.hidden_size)[
            :, top:top + gh, left:left + gw].reshape(1, gh * gw, c.hidden_size)
        return x + pos.to(c.dtype), (gh, gw)


class SD3JointAttention(nn.Module):
    def __init__(self, cfg: SD3Config, context_pre_only: bool):
        super().__init__()
        self.cfg = cfg
        hidden = inner = cfg.hidden_size
        self.to_q = nn.Linear(hidden, inner)
        self.to_k = nn.Linear(hidden, inner)
        self.to_v = nn.Linear(hidden, inner)
        self.add_q_proj = nn.Linear(hidden, inner)
        self.add_k_proj = nn.Linear(hidden, inner)
        self.add_v_proj = nn.Linear(hidden, inner)
        if cfg.qk_norm:
            self.norm_q = RMSNorm(cfg.head_dim, cfg.dtype)
            self.norm_k = RMSNorm(cfg.head_dim, cfg.dtype)
            self.norm_added_q = RMSNorm(cfg.head_dim, cfg.dtype)
            self.norm_added_k = RMSNorm(cfg.head_dim, cfg.dtype)
        self.to_out = nn.ModuleList([nn.Linear(inner, hidden)])
        self.to_add_out = None if context_pre_only else nn.Linear(inner, hidden)

    def qkv(self, img_n, txt_n):
        """-> q, k, v [B, S_txt + S_img, H, d]: text rows first."""
        c = self.cfg
        dt = c.dtype

        def heads(layer, x):
            return linear(layer, x, dt).reshape(x.shape[0], x.shape[1], c.num_heads,
                                                c.head_dim)

        q_i, k_i, v_i = (heads(m, img_n) for m in (self.to_q, self.to_k, self.to_v))
        q_t, k_t, v_t = (heads(m, txt_n) for m in
                         (self.add_q_proj, self.add_k_proj, self.add_v_proj))
        if c.qk_norm:
            q_i, k_i = self.norm_q(q_i), self.norm_k(k_i)
            q_t, k_t = self.norm_added_q(q_t), self.norm_added_k(k_t)
        return (torch.cat([q_t, q_i], dim=1), torch.cat([k_t, k_i], dim=1),
                torch.cat([v_t, v_i], dim=1))

    def out(self, attn, s_txt: int):
        """attn [B, S, H, d] -> (out_img, out_txt or None)."""
        dt = self.cfg.dtype
        attn = attn.reshape(attn.shape[0], attn.shape[1], self.cfg.hidden_size)
        out_img = linear(self.to_out[0], attn[:, s_txt:], dt)
        out_txt = None if self.to_add_out is None else \
            linear(self.to_add_out, attn[:, :s_txt], dt)
        return out_img, out_txt

    def forward(self, img_n, txt_n):
        return self.out(dot_product_attention(*self.qkv(img_n, txt_n)), txt_n.shape[1])


class SD3FF(nn.Module):
    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.dtype = cfg.dtype
        # diffusers layout: net.0 = GELU(proj), net.1 = dropout, net.2 = Linear
        self.net = nn.ModuleList([GELUProj(cfg.hidden_size, cfg.dtype), nn.Identity(),
                                  nn.Linear(4 * cfg.hidden_size, cfg.hidden_size)])

    def forward(self, x):
        return linear(self.net[2], self.net[0](x), self.dtype)


def _modulate(x, shift, scale, dtype):
    return plain_layer_norm(x, dtype) * (1 + scale[:, None]) + shift[:, None]


class JointTransformerBlock(nn.Module):
    def __init__(self, cfg: SD3Config, context_pre_only: bool = False):
        super().__init__()
        self.cfg = cfg
        self.context_pre_only = context_pre_only
        hidden = cfg.hidden_size
        self.norm1 = AdaLayerNormZero(hidden, cfg.dtype)
        self.norm1_context = (AdaNormContinuous(hidden, cfg.dtype) if context_pre_only
                              else AdaLayerNormZero(hidden, cfg.dtype))
        self.attn = SD3JointAttention(cfg, context_pre_only)
        self.ff = SD3FF(cfg)
        self.ff_context = None if context_pre_only else SD3FF(cfg)

    def _pre(self, img, txt, temb):
        """The half before the attention: the AdaLN modulations and q, k, v."""
        img_n, *img_mod = self.norm1(img, temb)
        if self.context_pre_only:
            txt_n, txt_mod = self.norm1_context(txt, temb), []
        else:
            txt_n, *txt_mod = self.norm1_context(txt, temb)
        q, k, v = self.attn.qkv(img_n, txt_n)
        return (q, k, v, *img_mod, *txt_mod)

    def _post(self, attn, img, txt, img_gate, img_shift_mlp, img_scale_mlp, img_gate_mlp,
              *txt_mod):
        """The half after the attention: the output projections, the gated
        residuals and the feed-forwards."""
        dt = self.cfg.dtype
        out_img, out_txt = self.attn.out(attn, txt.shape[1])
        img = img + img_gate[:, None] * out_img
        img = img + img_gate_mlp[:, None] * self.ff(
            _modulate(img, img_shift_mlp, img_scale_mlp, dt))
        if not self.context_pre_only:
            txt_gate, txt_shift_mlp, txt_scale_mlp, txt_gate_mlp = txt_mod
            txt = txt + txt_gate[:, None] * out_txt
            txt = txt + txt_gate_mlp[:, None] * self.ff_context(
                _modulate(txt, txt_shift_mlp, txt_scale_mlp, dt))
        return img, txt

    def _plain(self, img, txt, temb):
        q, k, v, *mod = self._pre(img, txt, temb)
        return self._post(dot_product_attention(q, k, v), img, txt, *mod)

    def forward(self, img, txt, temb):
        c = self.cfg
        if not c.gradient_checkpointing:
            return self._plain(img, txt, temb)
        if c.remat_policy == "full":
            return checkpointed(self._plain, img, txt, temb)
        # dots_nb_attn: the attention stays outside the recomputed halves
        q, k, v, *mod = checkpointed(self._pre, img, txt, temb, save_dots=True)
        attn = dot_product_attention(q, k, v)
        return checkpointed(self._post, attn, img, txt, *mod, save_dots=True)


class TimeTextEmbedSD3(nn.Module):
    def __init__(self, cfg: SD3Config):
        super().__init__()
        self.timestep_embedder = MLPEmbedder(256, cfg.hidden_size, cfg.dtype)
        self.text_embedder = MLPEmbedder(cfg.pooled_projection_dim, cfg.hidden_size,
                                         cfg.dtype)

    def forward(self, timestep, pooled):
        t_emb = timestep_embedding(timestep, 256, flip_sin_to_cos=True,
                                   downscale_freq_shift=0)
        return self.timestep_embedder(t_emb) + self.text_embedder(pooled.float())


class SD3Transformer2D(nn.Module):
    def __init__(self, cfg: SD3Config):
        super().__init__()
        if cfg.gradient_checkpointing and cfg.remat_policy not in DIT_POLICIES:
            raise NotImplementedError(
                f"remat policy {cfg.remat_policy!r} is not ported yet "
                f"(ported: {', '.join(DIT_POLICIES)})")
        self.cfg = cfg
        self.pos_embed = PatchEmbed(cfg)
        self.time_text_embed = TimeTextEmbedSD3(cfg)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, cfg.caption_projection_dim)
        self.transformer_blocks = nn.ModuleList(
            JointTransformerBlock(cfg, context_pre_only=(i == cfg.num_layers - 1))
            for i in range(cfg.num_layers))
        self.norm_out = AdaNormContinuous(cfg.hidden_size, cfg.dtype)
        self.proj_out = nn.Linear(cfg.hidden_size, cfg.patch_size ** 2 * cfg.out_channels)

    def forward(
            self,
            latents: torch.Tensor,    # [B, H, W, 16] NHWC
            timestep: torch.Tensor,   # [B] in [0, 1000)
            pooled: torch.Tensor,     # [B, 2048] (clip_l ++ clip_g pooled)
            context: torch.Tensor,    # [B, S, 4096] (clip padded ++ t5)
    ) -> torch.Tensor:
        c = self.cfg
        b = latents.shape[0]
        img, (gh, gw) = self.pos_embed(latents)
        temb = self.time_text_embed(timestep.float(), pooled)
        txt = linear(self.context_embedder, context.to(c.dtype), c.dtype)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, temb)
        img = self.norm_out(img, temb)
        img = linear(self.proj_out, img, torch.float32)
        # unpatchify
        p = c.patch_size
        img = img.reshape(b, gh, gw, p, p, c.out_channels).permute(0, 1, 3, 2, 4, 5)
        return img.reshape(b, gh * p, gw * p, c.out_channels)


def sd3_text_context(clip_l_hidden, clip_g_hidden, t5_states, clip_l_pooled, clip_g_pooled):
    """SD3 conditioning assembly (reference: BaseStableDiffusion3Setup.py:
    238-281): channel-concat the CLIP hidden states, zero-pad to the T5
    width, sequence-concat with T5; pooled = concat of both CLIP pooled.
    -> (context [B, S_clip + S_t5, 4096], pooled [B, 2048])."""
    clip = torch.cat([clip_l_hidden, clip_g_hidden], dim=-1)
    clip = F.pad(clip, (0, t5_states.shape[-1] - clip.shape[-1]))
    dtype = torch.promote_types(clip.dtype, t5_states.dtype)
    context = torch.cat([clip.to(dtype), t5_states.to(dtype)], dim=1)
    pooled = torch.cat([clip_l_pooled, clip_g_pooled], dim=-1)
    return context, pooled
