"""HunyuanVideo transformer: a 3D dual- then single-stream DiT over video
latents, with the Llama token refiner.

Counterpart of onetrainer_tpu/models/hunyuan_video.py (weight-parity
contract with `diffusers.HunyuanVideoTransformer3DModel`, which shares
FLUX's block naming): video latents [B, T, H, W, 16] patchify (1, 2, 2)
into tokens through a dense layer over 2x2-packed channels (the
checkpoint's conv3d kernel reshapes to it at load, io/hunyuan_checkpoints);
3D RoPE over (t, y, x) with axes (16, 56, 56) and theta 256 on the image
tokens only; the text tokens ride behind the image tokens, and a kv keep
mask [ones(image) | text mask] drops the padded text keys in every joint
attention (`ops/attention.py` hands it to K1-K3 as their -1e30 kv bias;
a padded text query still attends the kept keys). The token refiner runs
self-attention over the Llama states (77 tokens: below K1's floor, so
PyTorch's attention, as the reference's goes to XLA), conditioned on the
timestep and the mask-mean of those states.

The FLUX port's blocks serve as the reference imports them
(models/flux.py). The reference's scan-over-layers layout and its
sequence-parallel hooks are not ported (no mesh: they are no-ops). The
timestep features follow the reference exactly, which scales the
transformer's timestep and guidance by 1000 inside `TimeTextEmbed` on top
of the caller's scale (ROADMAP F11).

Gradient checkpointing runs the reference's HunyuanVideo policy, "full"
(models/remat.py:HUNYUAN_POLICY): each block is one recomputed segment.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.flux import (
    AdaLayerNormZero, AdaLayerNormZeroSingle, AdaNormContinuous, GeluMLP, JointAttention,
    MLPEmbedder, SingleAttention, TimeTextEmbed, _heads, _modulate, apply_rope, rope_tables,
)
from onetrainer_tpu_torch.models.layers import layer_norm, linear
from onetrainer_tpu_torch.models.remat import HUNYUAN_POLICY, checkpointed
from onetrainer_tpu_torch.models.unet import timestep_embedding
from onetrainer_tpu_torch.ops.attention import dot_product_attention

# the Llama prompt template and its crop (reference: HunyuanVideoModel.py
# DEFAULT_PROMPT_TEMPLATE, DEFAULT_PROMPT_TEMPLATE_CROP_START)
PROMPT_TEMPLATE_CROP_START = 95
DEFAULT_PROMPT_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: 1. The main content and theme of the "
    "video.2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects.3. Actions, events, behaviors temporal "
    "relationships, physical movement changes of the objects.4. background "
    "environment, light, style and atmosphere.5. camera angles, movements, "
    "and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
)


@dataclass(frozen=True)
class HunyuanVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 20
    num_single_layers: int = 40
    num_refiner_layers: int = 2
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    text_embed_dim: int = 4096        # Llama
    pooled_projection_dim: int = 768  # CLIP-L pooled
    guidance_embeds: bool = True
    axes_dims_rope: tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 256.0
    patch_size: int = 2
    patch_size_t: int = 1
    gradient_checkpointing: bool = False
    remat_policy: str = HUNYUAN_POLICY
    dtype: torch.dtype = torch.bfloat16


def hunyuan_video_config(**overrides) -> HunyuanVideoConfig:
    return HunyuanVideoConfig(**overrides)


# -- packing and positions --------------------------------------------------------------

def pack_video_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T*(H/2)*(W/2), C*4] (patch 1x2x2, channel-major)."""
    b, t, h, w, c = latents.shape
    x = latents.reshape(b, t, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 6, 3, 5)
    return x.reshape(b, t * (h // 2) * (w // 2), c * 4)


def unpack_video_latents(packed: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    b, _, c4 = packed.shape
    c = c4 // 4
    x = packed.reshape(b, t, h // 2, w // 2, c, 2, 2).permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(b, t, h, w, c)


def prepare_video_ids(t: int, height: int, width: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """[T*(H/2)*(W/2), 3] fp32 (t, y, x) position ids."""
    h2, w2 = height // 2, width // 2
    ids = torch.zeros((t, h2, w2, 3), dtype=torch.float32, device=device)
    ids[..., 0] = torch.arange(t, dtype=torch.float32, device=device)[:, None, None]
    ids[..., 1] = torch.arange(h2, dtype=torch.float32, device=device)[None, :, None]
    ids[..., 2] = torch.arange(w2, dtype=torch.float32, device=device)[None, None, :]
    return ids.reshape(t * h2 * w2, 3)


# -- the token refiner ---------------------------------------------------------------

class _RefinerAttention(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden_size
        self.to_q = nn.Linear(hidden, hidden)
        self.to_k = nn.Linear(hidden, hidden)
        self.to_v = nn.Linear(hidden, hidden)
        self.to_out = nn.ModuleList([nn.Linear(hidden, hidden)])

    def forward(self, h, mask):
        c = self.cfg
        b, s, _ = h.shape

        def heads(layer):
            return linear(layer, h, c.dtype).reshape(b, s, c.num_heads, -1)
        keep = mask[:, None, None, :].to(torch.bool) if mask is not None else None
        out = dot_product_attention(heads(self.to_q), heads(self.to_k), heads(self.to_v),
                                    mask=keep).reshape(b, s, -1)
        return linear(self.to_out[0], out, c.dtype)


class _SiluProj(nn.Module):
    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(hidden, 4 * hidden)

    def forward(self, x):
        return F.silu(linear(self.proj, x, self.dtype))


class _RefinerFF(nn.Module):
    """diffusers FeedForward(activation="linear-silu"): net.0 = SiLU(proj),
    net.2 = Linear."""

    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.net = nn.ModuleList([_SiluProj(hidden, dtype), nn.Identity(),
                                  nn.Linear(4 * hidden, hidden)])

    def forward(self, x):
        return linear(self.net[2], self.net[0](x), self.dtype)


class _GateLinear(nn.Module):
    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(hidden, 2 * hidden)

    def forward(self, temb):
        return linear(self.linear, F.silu(temb), self.dtype)


class TokenRefinerBlock(nn.Module):
    """Self-attention and MLP with timestep/pooled gating over the Llama
    states (diffusers HunyuanVideoIndividualTokenRefinerBlock)."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.dtype = cfg.dtype
        hidden = cfg.hidden_size
        self.norm_out = _GateLinear(hidden, cfg.dtype)
        self.norm1 = nn.LayerNorm(hidden, eps=1e-6)
        self.attn = _RefinerAttention(cfg)
        self.norm2 = nn.LayerNorm(hidden, eps=1e-6)
        self.ff = _RefinerFF(hidden, cfg.dtype)

    def forward(self, x, temb, mask):
        gate_msa, gate_mlp = self.norm_out(temb).chunk(2, dim=-1)
        x = x + gate_msa * self.attn(layer_norm(self.norm1, x, self.dtype), mask)
        return x + gate_mlp * self.ff(layer_norm(self.norm2, x, self.dtype))


class _RefinerTimeText(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.timestep_embedder = MLPEmbedder(256, cfg.hidden_size, cfg.dtype)
        self.text_embedder = MLPEmbedder(cfg.text_embed_dim, cfg.hidden_size, cfg.dtype)

    def forward(self, timestep, pooled):
        t_emb = timestep_embedding(timestep, 256, flip_sin_to_cos=True,
                                   downscale_freq_shift=0)
        return self.timestep_embedder(t_emb.to(self.dtype)) \
            + self.text_embedder(pooled.to(self.dtype))


class _RefinerStack(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.refiner_blocks = nn.ModuleList(TokenRefinerBlock(cfg)
                                            for _ in range(cfg.num_refiner_layers))

    def forward(self, x, temb, mask):
        for block in self.refiner_blocks:
            x = block(x, temb, mask)
        return x


class TokenRefiner(nn.Module):
    """Llama-context refiner conditioned on the timestep and the
    mask-mean-pooled text states (diffusers HunyuanVideoTokenRefiner)."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.time_text_embed = _RefinerTimeText(cfg)
        self.proj_in = nn.Linear(cfg.text_embed_dim, cfg.hidden_size)
        self.token_refiner = _RefinerStack(cfg)

    def forward(self, text_states, timestep, mask):
        if mask is None:
            pooled = text_states.mean(dim=1)
        else:
            m = mask.float()[..., None]
            pooled = (text_states.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        temb = self.time_text_embed(timestep, pooled)
        x = linear(self.proj_in, text_states.to(self.dtype), self.dtype)
        return self.token_refiner(x, temb[:, None, :], mask)


# -- the joint blocks ----------------------------------------------------------------

def _keep_mask(keep: torch.Tensor | None) -> torch.Tensor | None:
    """[B, S] keep -> the kv-only [B, 1, 1, S] attention mask."""
    return None if keep is None else keep[:, None, None, :]


class HunyuanJointAttention(JointAttention):
    """Joint attention over [image rows | text rows]: RoPE on the image
    rows only, the padded text keys dropped by the keep mask (diffusers
    HunyuanVideoAttnProcessor2_0)."""

    def qkv(self, img_n, txt_n, rope):
        c = self.cfg
        cos, sin = rope
        q_i = apply_rope(self.norm_q(_heads(self.to_q, img_n, c)), cos, sin)
        k_i = apply_rope(self.norm_k(_heads(self.to_k, img_n, c)), cos, sin)
        q_t = self.norm_added_q(_heads(self.add_q_proj, txt_n, c))
        k_t = self.norm_added_k(_heads(self.add_k_proj, txt_n, c))
        return (torch.cat([q_i, q_t], dim=1), torch.cat([k_i, k_t], dim=1),
                torch.cat([_heads(self.to_v, img_n, c), _heads(self.add_v_proj, txt_n, c)],
                          dim=1))

    def out(self, attn, s_img: int):
        dt = self.cfg.dtype
        attn = attn.reshape(attn.shape[0], attn.shape[1], -1)
        return (linear(self.to_out[0], attn[:, :s_img], dt),
                linear(self.to_add_out, attn[:, s_img:], dt))


class HunyuanDoubleBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = AdaLayerNormZero(cfg.hidden_size, cfg.dtype)
        self.norm1_context = AdaLayerNormZero(cfg.hidden_size, cfg.dtype)
        self.attn = HunyuanJointAttention(cfg)
        self.ff = GeluMLP(cfg.hidden_size, cfg.dtype)
        self.ff_context = GeluMLP(cfg.hidden_size, cfg.dtype)

    def plain(self, img, txt, temb, rope, keep):
        dt = self.cfg.dtype
        img_n, img_gate, img_shift_mlp, img_scale_mlp, img_gate_mlp = self.norm1(img, temb)
        txt_n, txt_gate, txt_shift_mlp, txt_scale_mlp, txt_gate_mlp = \
            self.norm1_context(txt, temb)
        q, k, v = self.attn.qkv(img_n, txt_n, rope)
        out_img, out_txt = self.attn.out(
            dot_product_attention(q, k, v, mask=_keep_mask(keep)), img.shape[1])
        img = img + img_gate[:, None] * out_img
        txt = txt + txt_gate[:, None] * out_txt
        img = img + img_gate_mlp[:, None] * self.ff(
            _modulate(img, img_shift_mlp, img_scale_mlp, dt))
        txt = txt + txt_gate_mlp[:, None] * self.ff_context(
            _modulate(txt, txt_shift_mlp, txt_scale_mlp, dt))
        return img, txt

    def forward(self, img, txt, temb, rope, keep):
        if self.cfg.gradient_checkpointing:
            return checkpointed(self.plain, img, txt, temb, rope, keep)
        return self.plain(img, txt, temb, rope, keep)


class HunyuanSingleAttention(SingleAttention):
    def qkv(self, normed, rope, s_img: int):
        """q, k, v [B, S, H, d], q and k rotated on the image prefix only."""
        c = self.cfg
        cos, sin = rope
        q = self.norm_q(_heads(self.to_q, normed, c))
        k = self.norm_k(_heads(self.to_k, normed, c))
        q = torch.cat([apply_rope(q[:, :s_img], cos, sin), q[:, s_img:]], dim=1)
        k = torch.cat([apply_rope(k[:, :s_img], cos, sin), k[:, s_img:]], dim=1)
        return q, k, _heads(self.to_v, normed, c)


class HunyuanSingleBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden_size
        self.norm = AdaLayerNormZeroSingle(hidden, cfg.dtype)
        self.attn = HunyuanSingleAttention(cfg)
        self.proj_mlp = nn.Linear(hidden, 4 * hidden)
        self.proj_out = nn.Linear(hidden + 4 * hidden, hidden)

    def plain(self, x, temb, rope, keep, s_img: int):
        dt = self.cfg.dtype
        normed, gate = self.norm(x, temb)
        attn = dot_product_attention(*self.attn.qkv(normed, rope, s_img),
                                     mask=_keep_mask(keep))
        mlp = F.gelu(linear(self.proj_mlp, normed, dt), approximate="tanh")
        out = linear(self.proj_out,
                     torch.cat([attn.reshape(x.shape[0], x.shape[1], -1), mlp], dim=-1), dt)
        return x + gate[:, None] * out

    def forward(self, x, temb, rope, keep, s_img: int):
        if self.cfg.gradient_checkpointing:
            return checkpointed(self.plain, x, temb, rope, keep, s_img)
        return self.plain(x, temb, rope, keep, s_img)


class _XEmbedder(nn.Module):
    """The patchify projection: a dense layer over the packed channels."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.proj = nn.Linear(cfg.in_channels * cfg.patch_size ** 2 * cfg.patch_size_t,
                              cfg.hidden_size)

    def forward(self, packed):
        return linear(self.proj, packed, self.dtype)


class HunyuanVideoTransformer3D(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        if cfg.gradient_checkpointing and cfg.remat_policy != HUNYUAN_POLICY:
            raise NotImplementedError(
                f"remat policy {cfg.remat_policy!r} is not ported for HunyuanVideo "
                f"(ported: {HUNYUAN_POLICY!r})")
        self.cfg = cfg
        self.x_embedder = _XEmbedder(cfg)
        self.context_embedder = TokenRefiner(cfg)
        self.time_text_embed = TimeTextEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(
            HunyuanDoubleBlock(cfg) for _ in range(cfg.num_layers))
        self.single_transformer_blocks = nn.ModuleList(
            HunyuanSingleBlock(cfg) for _ in range(cfg.num_single_layers))
        self.norm_out = AdaNormContinuous(cfg.hidden_size, cfg.dtype)
        self.proj_out = nn.Linear(
            cfg.hidden_size, cfg.patch_size ** 2 * cfg.patch_size_t * cfg.out_channels)

    def forward(
            self,
            latents: torch.Tensor,                # [B, T, H, W, 16]
            timestep: torch.Tensor,               # [B] in [0, 1000)
            text_states: torch.Tensor,            # [B, S_txt, 4096] Llama (cropped)
            text_mask: torch.Tensor | None,       # [B, S_txt]
            pooled: torch.Tensor,                 # [B, 768] CLIP pooled
            guidance: torch.Tensor | None = None,  # [B] (x1000 by the caller)
    ) -> torch.Tensor:
        """-> the flow prediction [B, T, H, W, 16], fp32."""
        c = self.cfg
        b, t, h, w, _ = latents.shape
        timestep = timestep.float()
        img = self.x_embedder(pack_video_latents(latents))
        txt = self.context_embedder(text_states, timestep, text_mask)
        if guidance is None:
            guidance = torch.full((b,), 1000.0, dtype=torch.float32, device=latents.device)
        temb = self.time_text_embed(timestep, guidance.float(), pooled)
        rope = rope_tables(prepare_video_ids(t, h, w, latents.device), c.axes_dims_rope,
                           c.rope_theta)
        s_img = img.shape[1]
        keep = None
        if text_mask is not None:
            keep = torch.cat([torch.ones((b, s_img), dtype=torch.bool, device=img.device),
                              text_mask.to(torch.bool)], dim=1)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, temb, rope, keep)
        x = torch.cat([img, txt], dim=1)   # image rows first
        for block in self.single_transformer_blocks:
            x = block(x, temb, rope, keep, s_img)
        img = self.norm_out(x[:, :s_img], temb)
        return unpack_video_latents(linear(self.proj_out, img, torch.float32), t, h, w)
