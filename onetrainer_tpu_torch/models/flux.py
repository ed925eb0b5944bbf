"""FLUX.1 rectified-flow DiT, and the blocks SD3's MMDiT shares.

Counterpart of onetrainer_tpu/models/flux.py (weight-parity contract with
`diffusers.FluxTransformer2DModel`, dev and fill): double-stream blocks (image and
text joint attention, AdaLN-Zero) followed by single-stream blocks, 3-axis
RoPE on interleaved pairs, the guidance embedding and 2x2 latent packing.
The shared blocks (`RMSNorm`, `AdaLayerNormZero`, `AdaNormContinuous`,
`GELUProj`, `MLPEmbedder`) serve models/sd3.py too. Module and parameter
names follow diffusers (`norm1.linear`, `ff.net.0.proj`, `linear_1`,
`attn.norm_added_q`), so the port's copy of the reference's key maps loads
a flax tree strictly. The reference's scan-over-layers layout is not
ported: the blocks run in a loop.

Parameters are fp32 unless the caller casts them (a 12B transformer is
built in bf16 and quantized); each op computes in `cfg.dtype`, cast per
op (models/layers.py), and `proj_out` in fp32. The affine-free layer
norms take their statistics in fp32 and cast the result to `dtype`, as
flax's `nn.LayerNorm(dtype=...)` does. Text rows come first in the joint
sequence, then the image rows, and the RoPE ids follow the same order;
`apply_rope` rotates in fp32 and casts back, so q and k reach
`ops/attention.py:dot_product_attention` contiguous: on the card K1
(forward) and K2/K3 (backward) take the ragged joint sequence (77 + 4096
= 4173 tokens at 1024x1024) in the d=128 slot.

Gradient checkpointing (`cfg.gradient_checkpointing`) runs the policy
`cfg.remat_policy` per block (models/remat.py): "full" (the reference's
FLUX default) recomputes the block, "dots_nb_attn" recomputes the halves
around the attention and keeps the weight matmuls' outputs and the
attention's residuals.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.layers import linear
from onetrainer_tpu_torch.models.remat import DIT_POLICIES, checkpointed
from onetrainer_tpu_torch.models.unet import timestep_embedding
from onetrainer_tpu_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64            # packed: 16 latent channels x 2x2
    out_channels: int = 64
    num_layers: int = 19             # double-stream blocks
    num_single_layers: int = 38
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    joint_attention_dim: int = 4096  # T5 width
    pooled_projection_dim: int = 768  # CLIP-L pooled
    guidance_embeds: bool = True
    axes_dims_rope: tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    gradient_checkpointing: bool = False
    remat_policy: str = "full"       # "full" or "dots_nb_attn" (models/remat.py)
    dtype: torch.dtype = torch.bfloat16


def flux_dev_config(**overrides) -> FluxConfig:
    return FluxConfig(**overrides)


def flux_fill_config(**overrides) -> FluxConfig:
    """FLUX.1-fill: the packed input is the noisy latent (64), the
    conditioning latent (64) and the 8x8-shuffled pixel mask (256); the
    output stays 64 wide."""
    return FluxConfig(in_channels=384, **overrides)


# -- latent packing ---------------------------------------------------------------------

def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] NHWC -> [B, H/2*W/2, C*4] (2x2 patches, channel-major)."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(packed: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H/2*W/2, C*4] -> [B, H, W, C]."""
    b, _, c4 = packed.shape
    c = c4 // 4
    x = packed.reshape(b, height // 2, width // 2, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, height, width, c)


def prepare_latent_image_ids(height: int, width: int,
                             device: torch.device | str = "cpu") -> torch.Tensor:
    """[H/2*W/2, 3] fp32 (0, y, x) position ids of the packed latent grid."""
    h2, w2 = height // 2, width // 2
    ids = torch.zeros((h2, w2, 3), dtype=torch.float32, device=device)
    ids[..., 1] = torch.arange(h2, dtype=torch.float32, device=device)[:, None]
    ids[..., 2] = torch.arange(w2, dtype=torch.float32, device=device)[None, :]
    return ids.reshape(h2 * w2, 3)


def rope_tables(ids: torch.Tensor, axes_dims: tuple[int, ...],
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """ids [S, 3] -> (cos, sin) [S, head_dim] fp32, each angle repeated on
    its interleaved (real, imaginary) pair."""
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dims):
        exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim
        freqs = 1.0 / (theta ** exponent)
        angles = ids[:, axis:axis + 1].float() * freqs[None, :]
        cos_parts.append(torch.repeat_interleave(torch.cos(angles), 2, dim=-1))
        sin_parts.append(torch.repeat_interleave(torch.sin(angles), 2, dim=-1))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] with interleaved (real, imaginary) pairs on D, rotated
    in fp32 and cast back to x's dtype."""
    x32 = x.float()
    x_rot = torch.stack([-x32[..., 1::2], x32[..., ::2]], dim=-1).reshape(x32.shape)
    out = x32 * cos[None, :, None, :] + x_rot * sin[None, :, None, :]
    return out.to(x.dtype)


def plain_layer_norm(x: torch.Tensor, dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without scale or bias over the last axis, fp32 statistics."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(dtype)


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + 1e-6) * weight in fp32, cast to `dtype` (the
    reference names the weight 'scale'; the key maps carry it as
    diffusers' 'weight')."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        x = x / torch.sqrt(x.pow(2).mean(dim=-1, keepdim=True) + 1e-6)
        return (x * self.weight.float()).to(self.dtype)


class MLPEmbedder(nn.Module):
    """diffusers TimestepEmbedding / PixArtAlphaTextProjection shape."""

    def __init__(self, in_dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear_1 = nn.Linear(in_dim, hidden)
        self.linear_2 = nn.Linear(hidden, hidden)

    def forward(self, x):
        return linear(self.linear_2, F.silu(linear(self.linear_1, x, self.dtype)),
                      self.dtype)


class AdaLayerNormZero(nn.Module):
    """-> (normed * (1 + scale_msa) + shift_msa, gate_msa, shift_mlp,
    scale_mlp, gate_mlp); the six chunks in diffusers' order."""

    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(hidden, 6 * hidden)

    def forward(self, x, temb):
        emb = linear(self.linear, F.silu(temb), self.dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = emb.chunk(6, dim=-1)
        out = plain_layer_norm(x, self.dtype) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return out, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaNormContinuous(nn.Module):
    """normed * (1 + scale) + shift, with (scale, shift) in that order."""

    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(hidden, 2 * hidden)

    def forward(self, x, temb):
        emb = linear(self.linear, F.silu(temb), self.dtype)
        scale, shift = emb.chunk(2, dim=-1)
        return plain_layer_norm(x, self.dtype) * (1 + scale[:, None]) + shift[:, None]


class GELUProj(nn.Module):
    """diffusers GELU(approximate="tanh"): proj to 4x hidden, then gelu."""

    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(hidden, 4 * hidden)

    def forward(self, x):
        return F.gelu(linear(self.proj, x, self.dtype), approximate="tanh")


class TimeTextEmbed(nn.Module):
    """t * 1000 and guidance * 1000 through sinusoidal features and their
    MLPs, plus the pooled CLIP embedding's (entering in fp32)."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.timestep_embedder = MLPEmbedder(256, cfg.hidden_size, cfg.dtype)
        self.guidance_embedder = MLPEmbedder(256, cfg.hidden_size, cfg.dtype) \
            if cfg.guidance_embeds else None
        self.text_embedder = MLPEmbedder(cfg.pooled_projection_dim, cfg.hidden_size,
                                         cfg.dtype)

    def forward(self, timestep, guidance, pooled):
        def features(t):
            return timestep_embedding(t * 1000.0, 256, flip_sin_to_cos=True,
                                      downscale_freq_shift=0)
        emb = self.timestep_embedder(features(timestep))
        if self.guidance_embedder is not None:
            emb = emb + self.guidance_embedder(features(guidance))
        return emb + self.text_embedder(pooled.float())


class AdaLayerNormZeroSingle(nn.Module):
    """-> (normed * (1 + scale_msa) + shift_msa, gate_msa)."""

    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(hidden, 3 * hidden)

    def forward(self, x, temb):
        emb = linear(self.linear, F.silu(temb), self.dtype)
        shift_msa, scale_msa, gate_msa = emb.chunk(3, dim=-1)
        out = plain_layer_norm(x, self.dtype) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return out, gate_msa


def _heads(layer: nn.Linear, x: torch.Tensor, cfg: FluxConfig) -> torch.Tensor:
    return linear(layer, x, cfg.dtype).reshape(x.shape[0], x.shape[1], cfg.num_heads,
                                               cfg.head_dim)


class JointAttention(nn.Module):
    """Double-stream joint attention (diffusers' FluxAttnProcessor layout:
    to_q/k/v for the image stream, add_*_proj for the text, RMS q/k norms)."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        hidden, inner, d = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.head_dim
        self.to_q = nn.Linear(hidden, inner)
        self.to_k = nn.Linear(hidden, inner)
        self.to_v = nn.Linear(hidden, inner)
        self.add_q_proj = nn.Linear(hidden, inner)
        self.add_k_proj = nn.Linear(hidden, inner)
        self.add_v_proj = nn.Linear(hidden, inner)
        self.norm_q = RMSNorm(d, cfg.dtype)
        self.norm_k = RMSNorm(d, cfg.dtype)
        self.norm_added_q = RMSNorm(d, cfg.dtype)
        self.norm_added_k = RMSNorm(d, cfg.dtype)
        self.to_out = nn.ModuleList([nn.Linear(inner, hidden)])
        self.to_add_out = nn.Linear(inner, hidden)

    def qkv(self, img_n, txt_n, rope):
        """-> q, k, v [B, S_txt + S_img, H, d]: text rows first, q and k
        rotated."""
        c = self.cfg
        q_i = self.norm_q(_heads(self.to_q, img_n, c))
        k_i = self.norm_k(_heads(self.to_k, img_n, c))
        v_i = _heads(self.to_v, img_n, c)
        q_t = self.norm_added_q(_heads(self.add_q_proj, txt_n, c))
        k_t = self.norm_added_k(_heads(self.add_k_proj, txt_n, c))
        v_t = _heads(self.add_v_proj, txt_n, c)
        cos, sin = rope
        return (apply_rope(torch.cat([q_t, q_i], dim=1), cos, sin),
                apply_rope(torch.cat([k_t, k_i], dim=1), cos, sin),
                torch.cat([v_t, v_i], dim=1))

    def out(self, attn, s_txt: int):
        """attn [B, S, H, d] -> (out_img, out_txt)."""
        dt = self.cfg.dtype
        attn = attn.reshape(attn.shape[0], attn.shape[1], -1)
        return (linear(self.to_out[0], attn[:, s_txt:], dt),
                linear(self.to_add_out, attn[:, :s_txt], dt))


class SingleAttention(nn.Module):
    """The single-stream blocks' attention: q, k, v with RMS norms and RoPE,
    no output projection (the block's proj_out takes it)."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        hidden, inner = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        self.to_q = nn.Linear(hidden, inner)
        self.to_k = nn.Linear(hidden, inner)
        self.to_v = nn.Linear(hidden, inner)
        self.norm_q = RMSNorm(cfg.head_dim, cfg.dtype)
        self.norm_k = RMSNorm(cfg.head_dim, cfg.dtype)

    def qkv(self, normed, rope):
        c = self.cfg
        cos, sin = rope
        q = apply_rope(self.norm_q(_heads(self.to_q, normed, c)), cos, sin)
        k = apply_rope(self.norm_k(_heads(self.to_k, normed, c)), cos, sin)
        return q, k, _heads(self.to_v, normed, c)


class GeluMLP(nn.Module):
    """diffusers FeedForward(activation="gelu-approximate"): net.0 =
    GELU(proj), net.1 = dropout, net.2 = Linear."""

    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.net = nn.ModuleList([GELUProj(hidden, dtype), nn.Identity(),
                                  nn.Linear(4 * hidden, hidden)])

    def forward(self, x):
        return linear(self.net[2], self.net[0](x), self.dtype)


def _modulate(x, shift, scale, dtype):
    return plain_layer_norm(x, dtype) * (1 + scale[:, None]) + shift[:, None]


def _run_block(block, rope, *args):
    """A block under its config's checkpoint policy: plainly, recomputed
    whole ("full"), or with the attention between two recomputed halves
    that keep their weight matmuls' outputs ("dots_nb_attn")."""
    c = block.cfg
    if not c.gradient_checkpointing:
        return block.plain(rope, *args)
    if c.remat_policy == "full":
        return checkpointed(block.plain, rope, *args)
    q, k, v, *rest = checkpointed(block.pre, rope, *args, save_dots=True)
    attn = dot_product_attention(q, k, v)
    return checkpointed(block.post, attn, *args, *rest, save_dots=True)


class FluxDoubleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = AdaLayerNormZero(cfg.hidden_size, cfg.dtype)
        self.norm1_context = AdaLayerNormZero(cfg.hidden_size, cfg.dtype)
        self.attn = JointAttention(cfg)
        self.ff = GeluMLP(cfg.hidden_size, cfg.dtype)
        self.ff_context = GeluMLP(cfg.hidden_size, cfg.dtype)

    def pre(self, rope, img, txt, temb):
        """The half before the attention: the AdaLN modulations and q, k, v."""
        img_n, *img_mod = self.norm1(img, temb)
        txt_n, *txt_mod = self.norm1_context(txt, temb)
        return (*self.attn.qkv(img_n, txt_n, rope), *img_mod, *txt_mod)

    def post(self, attn, img, txt, temb, img_gate, img_shift_mlp, img_scale_mlp,
             img_gate_mlp, txt_gate, txt_shift_mlp, txt_scale_mlp, txt_gate_mlp):
        """The half after it: the output projections, the gated residuals
        and the feed-forwards."""
        dt = self.cfg.dtype
        out_img, out_txt = self.attn.out(attn, txt.shape[1])
        img = img + img_gate[:, None] * out_img
        txt = txt + txt_gate[:, None] * out_txt
        img = img + img_gate_mlp[:, None] * self.ff(
            _modulate(img, img_shift_mlp, img_scale_mlp, dt))
        txt = txt + txt_gate_mlp[:, None] * self.ff_context(
            _modulate(txt, txt_shift_mlp, txt_scale_mlp, dt))
        return img, txt

    def plain(self, rope, img, txt, temb):
        q, k, v, *mod = self.pre(rope, img, txt, temb)
        return self.post(dot_product_attention(q, k, v), img, txt, temb, *mod)

    def forward(self, img, txt, temb, rope):
        return _run_block(self, rope, img, txt, temb)


class FluxSingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden_size
        self.norm = AdaLayerNormZeroSingle(hidden, cfg.dtype)
        self.attn = SingleAttention(cfg)
        self.proj_mlp = nn.Linear(hidden, 4 * hidden)
        self.proj_out = nn.Linear(hidden + 4 * hidden, hidden)

    def pre(self, rope, x, temb):
        normed, gate = self.norm(x, temb)
        return (*self.attn.qkv(normed, rope), normed, gate)

    def post(self, attn, x, temb, normed, gate):
        dt = self.cfg.dtype
        mlp = F.gelu(linear(self.proj_mlp, normed, dt), approximate="tanh")
        attn = attn.reshape(attn.shape[0], attn.shape[1], -1)
        out = linear(self.proj_out, torch.cat([attn, mlp], dim=-1), dt)
        return x + gate[:, None] * out

    def plain(self, rope, x, temb):
        q, k, v, *rest = self.pre(rope, x, temb)
        return self.post(dot_product_attention(q, k, v), x, temb, *rest)

    def forward(self, x, temb, rope):
        return _run_block(self, rope, x, temb)


class FluxTransformer2D(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        if cfg.gradient_checkpointing and cfg.remat_policy not in DIT_POLICIES:
            raise NotImplementedError(
                f"remat policy {cfg.remat_policy!r} is not ported yet "
                f"(ported: {', '.join(DIT_POLICIES)})")
        self.cfg = cfg
        self.x_embedder = nn.Linear(cfg.in_channels, cfg.hidden_size)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, cfg.hidden_size)
        self.time_text_embed = TimeTextEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(
            FluxDoubleBlock(cfg) for _ in range(cfg.num_layers))
        self.single_transformer_blocks = nn.ModuleList(
            FluxSingleBlock(cfg) for _ in range(cfg.num_single_layers))
        self.norm_out = AdaNormContinuous(cfg.hidden_size, cfg.dtype)
        self.proj_out = nn.Linear(cfg.hidden_size, cfg.out_channels)

    def forward(
            self,
            packed_latents: torch.Tensor,   # [B, S_img, in_channels]
            timestep: torch.Tensor,         # [B] in [0, 1]
            pooled: torch.Tensor,           # [B, 768] CLIP pooled
            t5_states: torch.Tensor,        # [B, S_txt, 4096]
            img_ids: torch.Tensor,          # [S_img, 3]
            txt_ids: torch.Tensor | None = None,   # [S_txt, 3] (zeros)
            guidance: torch.Tensor | None = None,  # [B]
    ) -> torch.Tensor:
        """-> the packed velocity [B, S_img, out_channels], fp32."""
        c = self.cfg
        if txt_ids is None:
            txt_ids = torch.zeros((t5_states.shape[1], 3), dtype=torch.float32,
                                  device=img_ids.device)
        if guidance is None:
            guidance = torch.ones_like(timestep)
        img = linear(self.x_embedder, packed_latents.to(c.dtype), c.dtype)
        txt = linear(self.context_embedder, t5_states.to(c.dtype), c.dtype)
        temb = self.time_text_embed(timestep.float(), guidance.float(), pooled)
        rope = rope_tables(torch.cat([txt_ids, img_ids], dim=0), c.axes_dims_rope,
                           c.rope_theta)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, temb, rope)
        x = torch.cat([txt, img], dim=1)
        for block in self.single_transformer_blocks:
            x = block(x, temb, rope)
        img = self.norm_out(x[:, txt.shape[1]:], temb)
        return linear(self.proj_out, img, torch.float32)
