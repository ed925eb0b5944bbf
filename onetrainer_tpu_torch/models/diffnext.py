"""Würstchen v2 stage-B decoder (DiffNeXt).

Counterpart of onetrainer_tpu/models/diffnext.py (the diffusers
`WuerstchenDiffNeXt` the reference samples through): a ConvNeXt-style UNet
over a pixel-unshuffled 4-channel latent. Each level repeats its
`level_config` pattern `blocks[i]` times (C a ResBlockStageB, T a
TimestepBlock, A an AttnBlock over the mapped decoder-CLIP states); levels
in `inject_effnet` feed every ResBlock the prior's 16-channel latent,
resized to the level's grid and mapped by a 1x1 conv (`effnet_mappers.{i}`,
the up path's from index `len(c_hidden)`); the up path's first ResBlock of
each level after the first concatenates the down path's output of that
level in front of the effnet skip; the head gives (a, b) and
noise = (x_in - a) / (sigmoid(b) (1 - 2e) + e).

The effnet resize is `jax.image.resize`'s "bicubic" (Keys' a = -0.5,
half-pixel centres, antialiased when it shrinks: models/resize.py), as the
reference's; OneTrainer's diffusers model takes torch's bicubic with
`align_corners=True` (ROADMAP F26). NHWC and dtypes as
models/wuerstchen.py's. The down and up convs are `down_blocks.{i}.0.1`
(2x2, stride 2) and `up_blocks.{ui}.{n}.1` (a 2x2 stride-2 transposed
conv, torch's [in, out, kh, kw] weight).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.cascade import pixel_shuffle, pixel_unshuffle
from onetrainer_tpu_torch.models.layers import linear
from onetrainer_tpu_torch.models.resize import resize
from onetrainer_tpu_torch.models.wuerstchen import (
    WAttnBlock, WResBlock, WTimestepBlock, gen_r_embedding, layer_norm_no_affine, nhwc_conv,
)


@dataclass(frozen=True)
class DiffNeXtConfig:
    c_in: int = 4
    c_out: int = 4
    c_r: int = 64
    patch_size: int = 2
    c_cond: int = 1024
    c_hidden: tuple = (320, 640, 1280, 1280)
    nhead: tuple = (-1, 10, 20, 20)
    blocks: tuple = (4, 4, 14, 4)
    level_config: tuple = ("CT", "CTA", "CTA", "CTA")
    inject_effnet: tuple = (False, True, True, True)
    effnet_embd: int = 16
    clip_embd: int = 1024
    kernel_size: int = 3
    dtype: torch.dtype = torch.bfloat16


class WuerstchenDiffNeXt(nn.Module):
    def __init__(self, cfg: DiffNeXtConfig):
        super().__init__()
        self.cfg = cfg
        c, dt, n = cfg, cfg.dtype, len(cfg.c_hidden)
        p = c.patch_size
        self.clip_mapper = nn.Linear(c.clip_embd, c.c_cond)
        self.embedding = nn.ModuleList([nn.Identity(), nn.Conv2d(c.c_in * p * p, c.c_hidden[0], 1)])

        def level(i: int, first_skip: int = 0) -> list:
            out = []
            for b in range(c.blocks[i]):
                for k, kind in enumerate(c.level_config[i]):
                    if kind == "C":
                        skip = (c.c_hidden[i] if c.inject_effnet[i] else 0) \
                            + (first_skip if b == 0 and k == 0 else 0)
                        out.append(WResBlock(c.c_hidden[i], skip, c.kernel_size, dt))
                    elif kind == "T":
                        out.append(WTimestepBlock(c.c_hidden[i], c.c_r, dtype=dt))
                    else:
                        out.append(WAttnBlock(c.c_hidden[i], c.c_cond, c.nhead[i], dt))
            return out

        down = []
        for i in range(n):
            blocks = level(i)
            if i > 0:
                blocks = [nn.ModuleList([nn.Identity(), nn.Conv2d(
                    c.c_hidden[i - 1], c.c_hidden[i], 2, stride=2)])] + blocks
            down.append(nn.ModuleList(blocks))
        self.down_blocks = nn.ModuleList(down)
        up = []
        for ui, i in enumerate(reversed(range(n))):
            blocks = level(i, c.c_hidden[i] if ui > 0 else 0)
            if i > 0:
                blocks.append(nn.ModuleList([nn.Identity(), nn.ConvTranspose2d(
                    c.c_hidden[i], c.c_hidden[i - 1], 2, stride=2)]))
            up.append(nn.ModuleList(blocks))
        self.up_blocks = nn.ModuleList(up)
        levels = list(range(n)) + list(reversed(range(n)))
        self.effnet_mappers = nn.ModuleList(
            nn.Conv2d(c.effnet_embd, c.c_hidden[i], 1) if c.inject_effnet[i] else nn.Identity()
            for i in levels)
        self.clf = nn.ModuleList([nn.Identity(), nn.Conv2d(c.c_hidden[0],
                                                           2 * c.c_out * p * p, 1)])

    def _effnet_skip(self, effnet, spatial, mapper_index):
        resized = resize(effnet.float(), spatial, "bicubic")
        return nhwc_conv(self.effnet_mappers[mapper_index], resized.to(self.cfg.dtype),
                         self.cfg.dtype)

    def _run_level(self, blocks, h, i, r_embed, clip, effnet, mapper_index, first_skip=None):
        c = self.cfg
        effnet_c = None
        first = True
        for block in blocks:
            if isinstance(block, WResBlock):
                skip = None
                if c.inject_effnet[i]:
                    if effnet_c is None:
                        effnet_c = self._effnet_skip(effnet, tuple(h.shape[1:3]), mapper_index)
                    skip = effnet_c
                if first and first_skip is not None:
                    skip = first_skip if skip is None else torch.cat(
                        [first_skip.to(skip.dtype), skip], dim=-1)
                h = block(h, skip)
            elif isinstance(block, WTimestepBlock):
                h = block(h, r_embed)
            else:
                h = block(h, clip)
            first = False
        return h

    def forward(self, x: torch.Tensor, r: torch.Tensor, effnet: torch.Tensor,
                clip: torch.Tensor | None = None, eps: float = 1e-3) -> torch.Tensor:
        """x [B, H, W, 4] noisy stage-B latent, r [B] continuous timestep,
        effnet [B, h, w, 16] the prior's output, clip [B, S, clip_embd]
        -> the noise prediction, fp32."""
        c, dt, n = self.cfg, self.cfg.dtype, len(self.cfg.c_hidden)
        x_in = x.float()
        r_embed = (gen_r_embedding(r, c.c_r).to(dt),)
        if clip is not None:
            clip = layer_norm_no_affine(linear(self.clip_mapper, clip.to(dt), dt))
        h = pixel_unshuffle(x.to(dt), c.patch_size)
        h = layer_norm_no_affine(nhwc_conv(self.embedding[1], h, dt))

        level_outputs = []
        for i in range(n):
            blocks = list(self.down_blocks[i])
            if i > 0:
                down = blocks.pop(0)
                h = nhwc_conv(down[1], layer_norm_no_affine(h), dt)
            h = self._run_level(blocks, h, i, r_embed, clip, effnet, i)
            level_outputs.insert(0, h)

        h = level_outputs[0]
        for ui, i in enumerate(reversed(range(n))):
            blocks = list(self.up_blocks[ui])
            upscaler = blocks.pop() if i > 0 else None
            h = self._run_level(blocks, h, i, r_embed, clip, effnet, n + ui,
                                level_outputs[ui] if ui > 0 else None)
            if upscaler is not None:
                t = upscaler[1]
                y = F.conv_transpose2d(layer_norm_no_affine(h).permute(0, 3, 1, 2).to(dt),
                                       t.weight.to(dt), t.bias.to(dt), t.stride)
                h = y.permute(0, 2, 3, 1)

        out = nhwc_conv(self.clf[1], layer_norm_no_affine(h).float(), torch.float32)
        out = pixel_shuffle(out, c.patch_size)
        a, b = out.chunk(2, dim=-1)
        b = torch.sigmoid(b) * (1.0 - 2.0 * eps) + eps
        return (x_in - a) / b
