"""Stable Cascade stage-C prior.

Counterpart of onetrainer_tpu/models/cascade.py (key-exact with diffusers'
StableCascadeUNet prior layout): the conditioning tokens are [the pooled
CLIP-G projection mapped to `clip_seq` tokens | the text states | the image
embedding], each mapped to `c_cond` and layer-normed; two levels of
flattened [ResBlock, TimestepBlock, AttnBlock] triples run down
(`down_blocks.{level}.{3j+k}`) and up (`up_blocks.0` the deeper level), the
level transition a LayerNorm and a 1x1 conv (`down_downscalers.1.1.
blocks.0`, `up_upscalers.0.1.blocks.1`; a resize only with
`switch_level`, off in the released prior, which runs at the 24x24 latent
grid throughout); the timestep blocks add the `sca` and `crp`
embeddings' maps; the up path's first block of level 0 concatenates the
down path's level-0 output; `clf.1` gives (a, b) and eps = (x_in - a) /
(|1 - b| + 1e-5). `CascadePriorConfig`'s defaults are the released stage C
(c_hidden 2048, 32 d=64 heads, blocks (8, 24): 3.6e9 parameters). NHWC,
dtypes and checkpointing as models/wuerstchen.py's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from onetrainer_tpu_torch.models.layers import linear
from onetrainer_tpu_torch.models.resize import resize
from onetrainer_tpu_torch.models.wuerstchen import (
    WAttnBlock, WResBlock, WTimestepBlock, gen_r_embedding, layer_norm_no_affine, nhwc_conv,
    run_triple,
)


@dataclass(frozen=True)
class CascadePriorConfig:
    c_in: int = 16
    c_hidden: tuple[int, ...] = (2048, 2048)
    nhead: tuple[int, ...] = (32, 32)
    blocks: tuple[int, ...] = (8, 24)          # per level (down); up mirrors
    c_cond: int = 2048
    c_r: int = 64
    clip_text_in: int = 1280
    clip_text_pooled_in: int = 1280
    clip_image_in: int = 768
    clip_seq: int = 4                          # pooled -> N cond tokens
    patch_size: int = 1
    switch_level: tuple[bool, ...] = (False,)  # bilinear resize at transition
    timestep_conditioning: tuple[str, ...] = ("sca", "crp")
    gradient_checkpointing: bool = False
    dtype: torch.dtype = torch.bfloat16


def pixel_unshuffle(x: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC pixel-unshuffle with torch's channel order (c, ph, pw)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // p, w // p, c * p * p)


def pixel_shuffle(x: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC pixel-shuffle; input channels ordered (c, ph, pw) as torch's."""
    b, h, w, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, h, w, c, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * p, w * p, c)


class UpDownBlock(nn.Module):
    """UpDownBlock2d: a 1x1 conv (`blocks.0` going down, conv first;
    `blocks.1` going up, resize first) and a bilinear x0.5 / x2 resize when
    `resize`."""

    def __init__(self, c_in: int, c_out: int, up: bool, resize_level: bool,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.up = up
        self.resize_level = resize_level
        conv = nn.Conv2d(c_in, c_out, 1)
        self.blocks = nn.ModuleList([nn.Identity(), conv] if up else [conv, nn.Identity()])

    def _interp(self, h):
        if not self.resize_level:
            return h
        factor = 2 if self.up else 0.5
        size = (int(h.shape[1] * factor), int(h.shape[2] * factor))
        return resize(h.float(), size, "bilinear").to(h.dtype)

    def forward(self, h):
        if self.up:
            return nhwc_conv(self.blocks[1], self._interp(h), self.dtype)
        return self._interp(nhwc_conv(self.blocks[0], h, self.dtype))


class _NormThen(nn.ModuleList):
    """[LayerNorm (no affine, no parameters), module]: the keys .1.*."""

    def __init__(self, module: nn.Module):
        super().__init__([nn.Identity(), module])

    def forward(self, h):
        return self[1](layer_norm_no_affine(h))


def _level(c: CascadePriorConfig, level: int, first_skip: int = 0) -> nn.ModuleList:
    ch = c.c_hidden[level]
    blocks = []
    for j in range(c.blocks[level]):
        blocks += [WResBlock(ch, first_skip if j == 0 else 0, dtype=c.dtype),
                   WTimestepBlock(ch, c.c_r, c.timestep_conditioning, dtype=c.dtype),
                   WAttnBlock(ch, c.c_cond, c.nhead[level], dtype=c.dtype)]
    return nn.ModuleList(blocks)


class StableCascadePrior(nn.Module):
    def __init__(self, cfg: CascadePriorConfig):
        super().__init__()
        self.cfg = cfg
        c, dt, p = cfg, cfg.dtype, cfg.patch_size
        self.clip_txt_pooled_mapper = nn.Linear(c.clip_text_pooled_in, c.c_cond * c.clip_seq)
        self.clip_txt_mapper = nn.Linear(c.clip_text_in, c.c_cond)
        self.clip_img_mapper = nn.Linear(c.clip_image_in, c.c_cond)
        self.embedding = nn.ModuleList([nn.Identity(),
                                        nn.Conv2d(c.c_in * p * p, c.c_hidden[0], 1)])
        self.down_blocks = nn.ModuleList([_level(c, 0), _level(c, 1)])
        self.down_downscalers = nn.ModuleList([nn.Identity(), _NormThen(UpDownBlock(
            c.c_hidden[0], c.c_hidden[1], False, c.switch_level[0], dt))])
        self.up_blocks = nn.ModuleList([_level(c, 1), _level(c, 0, first_skip=c.c_hidden[0])])
        self.up_upscalers = nn.ModuleList([_NormThen(UpDownBlock(
            c.c_hidden[1], c.c_hidden[0], True, c.switch_level[0], dt)), nn.Identity()])
        self.clf = nn.ModuleList([nn.Identity(), nn.Conv2d(c.c_hidden[0], c.c_in * p * p * 2, 1)])

    def _run_level(self, blocks, h, t_embeds, clip, first_skip=None):
        for i in range(0, len(blocks), 3):
            h = run_triple(blocks, i, h, t_embeds, clip, self.cfg.gradient_checkpointing,
                           skip=first_skip if i == 0 else None)
        return h

    def forward(self, x, r, clip_text, clip_text_pooled=None, clip_img=None, sca=None,
                crp=None):
        """x [B, H, W, 16], r [B] continuous timestep, clip_text
        [B, S, 1280], clip_text_pooled [B, 1280] or [B, 1, 1280], clip_img
        [B, S_img, 768] (zeros when None, as in training) -> eps, fp32."""
        c, dt = self.cfg, self.cfg.dtype
        b = x.shape[0]
        x_in = x.float()
        if clip_text_pooled is None:
            clip_text_pooled = torch.zeros((b, c.clip_text_pooled_in), dtype=x.dtype,
                                           device=x.device)
        if clip_img is None:
            clip_img = torch.zeros((b, 1, c.clip_image_in), dtype=x.dtype, device=x.device)
        if clip_text_pooled.dim() == 2:
            clip_text_pooled = clip_text_pooled[:, None]

        pooled = linear(self.clip_txt_pooled_mapper, clip_text_pooled.to(dt), dt)
        pooled = pooled.reshape(b, clip_text_pooled.shape[1] * c.clip_seq, c.c_cond)
        txt = linear(self.clip_txt_mapper, clip_text.to(dt), dt)
        img = linear(self.clip_img_mapper, clip_img.to(dt), dt)
        clip = layer_norm_no_affine(torch.cat([pooled, txt, img], dim=1))

        t_embeds = [gen_r_embedding(r, c.c_r).to(dt)]
        for value in (sca, crp)[:len(c.timestep_conditioning)]:
            cond_r = value if value is not None else torch.zeros_like(r)
            t_embeds.append(gen_r_embedding(cond_r, c.c_r).to(dt))

        p = c.patch_size
        h = x.to(dt)
        if p > 1:
            h = pixel_unshuffle(h, p)
        h = layer_norm_no_affine(nhwc_conv(self.embedding[1], h, dt))

        h = self._run_level(self.down_blocks[0], h, t_embeds, clip)
        skip0 = h
        h = self.down_downscalers[1](h)
        h = self._run_level(self.down_blocks[1], h, t_embeds, clip)
        h = self._run_level(self.up_blocks[0], h, t_embeds, clip)
        h = self.up_upscalers[0](h)
        h = self._run_level(self.up_blocks[1], h, t_embeds, clip, first_skip=skip0)

        out = nhwc_conv(self.clf[1], layer_norm_no_affine(h), torch.float32)
        if p > 1:
            out = pixel_shuffle(out, p)
        a, bpred = out.float().chunk(2, dim=-1)
        return (x_in - a) / ((1.0 - bpred).abs() + 1e-5)
