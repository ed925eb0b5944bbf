"""Würstchen v2 prior and the EfficientNetV2-S latent encoder.

Counterpart of onetrainer_tpu/models/wuerstchen.py (weight-parity
contract with diffusers' `WuerstchenPrior` and torchvision's
efficientnet_v2 features behind OneTrainer's 1x1 mapper): the prior is a
ConvNeXt-style residual net over 16-channel EfficientNet latents
(image / 42.67: a x0.75 resize, then the backbone's stride 32),
conditioned on CLIP text states through `[ResBlock, TimestepBlock,
AttnBlock]` triples, and predicts eps through the (x_in - a) /
(|1 - b| + 1e-5) head. Module and parameter names follow diffusers
(`blocks.0.depthwise`, `blocks.0.channelwise.0`, `blocks.0.channelwise.2.
gamma`, `blocks.1.mapper`, `blocks.2.kv_mapper.1`, `blocks.2.attention.
to_q`, `cond_mapper.0`, `out.1`) and the encoder's torchvision's
(`backbone.0.0`, `backbone.1.0.block.0.0`, `backbone.4.0.block.2.fc1`,
`mapper.0`), so checkpoints load as they are stored.

The reference runs NHWC; so do these modules' inputs, outputs and
channel-wise ops. Each convolution takes a permuted view of the NHWC
tensor (NCHW in shape, channels-last in memory) and hands its result back
the same way, so the permutes move no data where the backend computes
channels-last. A depthwise convolution is `groups=c`, the reference's
`feature_group_count`; LoRA skips it on both sides (peft/lora.py). The
attention goes through ops/attention.py:attention: the prior's d=64 heads
over 576 query and 576 + 77 key rows take K1-K3 on the card. GELU is the
tanh approximation, flax's default. Parameters are fp32 unless the caller
casts them; each op computes in `cfg.dtype` (models/layers.py), the head
in fp32. Under `gradient_checkpointing` each block is one recomputed
segment, as the reference's remat per block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.layers import conv, linear
from onetrainer_tpu_torch.models.remat import checkpointed
from onetrainer_tpu_torch.ops.attention import attention


@dataclass(frozen=True)
class WuerstchenPriorConfig:
    c_in: int = 16
    c: int = 1536
    c_cond: int = 1024
    c_r: int = 64
    depth: int = 32
    nhead: int = 24
    gradient_checkpointing: bool = False
    dtype: torch.dtype = torch.bfloat16


def layer_norm_no_affine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """WuerstchenLayerNorm: channels-last LayerNorm without scale or bias,
    fp32 statistics, the input's dtype out."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def nhwc_conv(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer` (a Conv2d, through models/layers.py:conv) on an NHWC tensor."""
    return conv(layer, x.permute(0, 3, 1, 2), dtype).permute(0, 2, 3, 1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class GlobalResponseNorm(nn.Module):
    """ConvNeXt-v2 GRN over channels-last input (diffusers' gamma/beta
    [1, 1, 1, dim])."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        xf = x.float()
        agg = torch.linalg.vector_norm(xf, dim=(1, 2), keepdim=True)
        stand = agg / (agg.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (xf * stand) + self.beta + x).to(x.dtype)


def channelwise(c_in: int, c: int, hidden: int | None = None) -> nn.ModuleList:
    """diffusers' channelwise MLP: Linear `hidden` (4c by default), GELU,
    GRN, Dropout, Linear c (the parameterless slots as Identity, so the
    keys are .0, .2, .4)."""
    hidden = hidden or c * 4
    return nn.ModuleList([nn.Linear(c_in, hidden), nn.Identity(), GlobalResponseNorm(hidden),
                          nn.Identity(), nn.Linear(hidden, c)])


def run_channelwise(layers: nn.ModuleList, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    h = gelu(linear(layers[0], h, dtype))
    return linear(layers[4], layers[2](h), dtype)


class WResBlock(nn.Module):
    """depthwise k x k, LN (no affine), [concat skip], the channelwise MLP,
    residual: diffusers' prior ResBlock, Stable Cascade's SDCascadeResBlock
    and DiffNeXt's ResBlockStageB (`c_skip` the skip's channels)."""

    def __init__(self, c: int, c_skip: int = 0, kernel_size: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.depthwise = nn.Conv2d(c, c, kernel_size, padding=kernel_size // 2, groups=c)
        self.channelwise = channelwise(c + c_skip, c)

    def forward(self, x, skip=None):
        h = layer_norm_no_affine(nhwc_conv(self.depthwise, x, self.dtype))
        if skip is not None:
            h = torch.cat([h, skip.to(h.dtype)], dim=-1)
        return run_channelwise(self.channelwise, h, self.dtype) + x


class WTimestepBlock(nn.Module):
    """x * (1 + a) + b, (a, b) a linear map of the timestep embedding,
    plus one map per extra conditioning (Stable Cascade's `mapper_sca`,
    `mapper_crp`)."""

    def __init__(self, c: int, c_r: int = 64, conds: tuple[str, ...] = (),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conds = conds
        self.mapper = nn.Linear(c_r, c * 2)
        for cond in conds:
            setattr(self, f"mapper_{cond}", nn.Linear(c_r, c * 2))

    def forward(self, x, r_embeds):
        ab = linear(self.mapper, r_embeds[0], self.dtype)
        for i, cond in enumerate(self.conds):
            ab = ab + linear(getattr(self, f"mapper_{cond}"), r_embeds[i + 1], self.dtype)
        a, b = ab.chunk(2, dim=-1)
        return x * (1 + a[:, None, None, :]) + b[:, None, None, :]


class WAttention(nn.Module):
    """diffusers `Attention` subset: to_q/to_k/to_v with bias, to_out.0."""

    def __init__(self, c: int, nhead: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.nhead = nhead
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, q_in, kv_in):
        dt = self.dtype
        out = attention(linear(self.to_q, q_in, dt), linear(self.to_k, kv_in, dt),
                        linear(self.to_v, kv_in, dt), self.nhead)
        return linear(self.to_out[0], out, dt)


class WAttnBlock(nn.Module):
    """Self plus cross attention: the normed spatial tokens attend over
    [themselves, the mapped conditioning tokens]."""

    def __init__(self, c: int, c_cond: int, nhead: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kv_mapper = nn.ModuleList([nn.Identity(), nn.Linear(c_cond, c)])
        self.attention = WAttention(c, nhead, dtype)

    def forward(self, x, c_embed):
        b, h, w, c = x.shape
        q = layer_norm_no_affine(x).reshape(b, h * w, c)
        kv_text = linear(self.kv_mapper[1], F.silu(c_embed), self.dtype)
        kv = torch.cat([q, kv_text.to(q.dtype)], dim=1)
        return x + self.attention(q, kv).reshape(b, h, w, c)


def gen_r_embedding(r: torch.Tensor, c_r: int, max_positions: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [B, c_r] fp32 of the continuous timestep r in
    [0, 1] (diffusers' WuerstchenPrior.gen_r_embedding)."""
    r = r.float() * max_positions
    half = c_r // 2
    emb = math.log(max_positions) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=r.device) * -emb)
    emb = r[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if c_r % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def run_triple(blocks, i: int, x, r_embeds, clip, checkpointing: bool, skip=None):
    """One [ResBlock, TimestepBlock, AttnBlock] triple starting at
    `blocks[i]`, each block one recomputed segment under `checkpointing`."""
    def call(block, *args):
        return checkpointed(block, *args) if checkpointing else block(*args)
    x = call(blocks[i], x) if skip is None else call(blocks[i], x, skip)
    x = call(blocks[i + 1], x, r_embeds)
    return call(blocks[i + 2], x, clip)


class WuerstchenPrior(nn.Module):
    def __init__(self, cfg: WuerstchenPriorConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.projection = nn.Conv2d(cfg.c_in, cfg.c, 1)
        self.cond_mapper = nn.ModuleList([nn.Linear(cfg.c_cond, cfg.c), nn.Identity(),
                                          nn.Linear(cfg.c, cfg.c)])
        blocks = []
        for _ in range(cfg.depth):
            blocks += [WResBlock(cfg.c, dtype=dt), WTimestepBlock(cfg.c, cfg.c_r, dtype=dt),
                       WAttnBlock(cfg.c, cfg.c, cfg.nhead, dtype=dt)]
        self.blocks = nn.ModuleList(blocks)
        self.out = nn.ModuleList([nn.Identity(), nn.Conv2d(cfg.c, cfg.c_in * 2, 1)])

    def forward(self, x: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 16] noisy effnet latent, r [B] continuous timestep,
        c [B, S, c_cond] text states -> the eps prediction, fp32."""
        cfg = self.cfg
        dt = cfg.dtype
        x_in = x.float()
        x = nhwc_conv(self.projection, x.to(dt), dt)
        ce = F.leaky_relu(linear(self.cond_mapper[0], c.to(dt), dt), 0.2)
        ce = linear(self.cond_mapper[2], ce, dt)
        r_embed = (gen_r_embedding(r, cfg.c_r).to(dt),)
        for i in range(0, len(self.blocks), 3):
            x = run_triple(self.blocks, i, x, r_embed, ce, cfg.gradient_checkpointing)
        out = nhwc_conv(self.out[1], layer_norm_no_affine(x), torch.float32)
        a, b = out.float().chunk(2, dim=-1)
        return (x_in - a) / ((1.0 - b).abs() + 1e-5)


# -- EfficientNetV2-S encoder (the Würstchen "VAE") ---------------------------------

# (expand_ratio, kernel, stride, in_ch, out_ch, layers, use_se)
_EFFNET_V2_S = (
    (1, 3, 1, 24, 24, 2, False),
    (4, 3, 2, 24, 48, 4, False),
    (4, 3, 2, 48, 64, 4, False),
    (4, 3, 2, 64, 128, 6, True),
    (6, 3, 1, 128, 160, 9, True),
    (6, 3, 2, 160, 256, 15, True),
)
_EFFNET_V2_L = (
    (1, 3, 1, 32, 32, 4, False),
    (4, 3, 2, 32, 64, 7, False),
    (4, 3, 2, 64, 96, 7, False),
    (4, 3, 2, 96, 192, 10, True),
    (6, 3, 1, 192, 224, 19, True),
    (6, 3, 2, 224, 384, 25, True),
    (6, 3, 1, 384, 640, 7, True),
)


@dataclass(frozen=True)
class EffnetConfig:
    variant: str = "efficientnet_v2_s"   # the reference's default
    c_latent: int = 16
    dtype: torch.dtype = torch.bfloat16

    @property
    def stages(self):
        return _EFFNET_V2_L if self.variant == "efficientnet_v2_l" else _EFFNET_V2_S

    @property
    def stem_channels(self):
        return self.stages[0][3]

    @property
    def head_channels(self):
        return 1280


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm: (x - running_mean) / sqrt(running_var + eps)
    * weight + bias in fp32, the input's dtype out (torch's BatchNorm2d
    keys; the encoder is always frozen)."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):   # NHWC
        y = (x.float() - self.running_mean.float()) / torch.sqrt(self.running_var.float() + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class ConvNormAct(nn.ModuleList):
    """torchvision's Conv2dNormActivation: conv (no bias), BatchNorm
    [, SiLU] (keys .0 and .1)."""

    def __init__(self, c_in: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__([nn.Conv2d(c_in, features, kernel, stride, (kernel - 1) // 2,
                                    groups=groups, bias=False), FrozenBatchNorm(features)])
        self.dtype = dtype
        self.act = act

    def forward(self, x):
        x = self[1](nhwc_conv(self[0], x, self.dtype))
        return F.silu(x) if self.act else x


class SqueezeExcitation(nn.Module):
    def __init__(self, features: int, squeeze: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Conv2d(features, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, features, 1)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        s = nhwc_conv(self.fc2, F.silu(nhwc_conv(self.fc1, s, self.dtype)), self.dtype)
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """torchvision's MBConv (`use_se`) or FusedMBConv, its layers in `block`
    (expand, depthwise, SE at index 2, project; fused: expand k x k,
    project)."""

    def __init__(self, expand: int, kernel: int, stride: int, in_ch: int, out_ch: int,
                 use_se: bool, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        mid = in_ch * expand
        if not use_se:
            layers = [ConvNormAct(in_ch, mid, kernel, stride, dtype=dtype),
                      ConvNormAct(mid, out_ch, 1, 1, act=False, dtype=dtype)] if expand != 1 \
                else [ConvNormAct(in_ch, out_ch, kernel, stride, dtype=dtype)]
        else:
            layers = [ConvNormAct(in_ch, mid, 1, 1, dtype=dtype)] if expand != 1 else []
            layers += [ConvNormAct(mid, mid, kernel, stride, groups=mid, dtype=dtype),
                       SqueezeExcitation(mid, max(in_ch // 4, 1), dtype),
                       ConvNormAct(mid, out_ch, 1, 1, act=False, dtype=dtype)]
        self.block = nn.ModuleList(layers)

    def forward(self, x):
        h = x
        for layer in self.block:
            h = layer(h)
        return h + x if self.residual else h


class WuerstchenEffnetEncoder(nn.Module):
    """torchvision efficientnet_v2 features, then a 1x1 mapper conv and
    BatchNorm (OneTrainer's WuerstchenEfficientNetEncoder): an
    ImageNet-normalized NHWC image -> [B, H/32, W/32, 16]."""

    def __init__(self, cfg: EffnetConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        stages = [ConvNormAct(3, cfg.stem_channels, 3, 2, dtype=dt)]
        for expand, kernel, stride, in_ch, out_ch, layers, use_se in cfg.stages:
            stages.append(nn.ModuleList(
                MBConv(expand, kernel, stride if i == 0 else 1, in_ch if i == 0 else out_ch,
                       out_ch, use_se, dt) for i in range(layers)))
        stages.append(ConvNormAct(cfg.stages[-1][4], cfg.head_channels, 1, 1, dtype=dt))
        self.backbone = nn.ModuleList(stages)
        self.mapper = nn.ModuleList([nn.Conv2d(cfg.head_channels, cfg.c_latent, 1, bias=False),
                                     FrozenBatchNorm(cfg.c_latent, eps=1e-5)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = self.backbone[0](x.to(dt))
        for stage in self.backbone[1:-1]:
            for block in stage:
                x = block(x)
        x = self.backbone[-1](x)
        return self.mapper[1](nhwc_conv(self.mapper[0], x, dt))
