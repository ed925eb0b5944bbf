"""The FLUX.1 DiT blocks that SD3's MMDiT shares.

Counterpart of the shared blocks of onetrainer_tpu/models/flux.py:
`RMSNorm`, `AdaLayerNormZero`, `AdaNormContinuous`, `GELUProj` and
`MLPEmbedder` (the ones onetrainer_tpu/models/sd3.py imports). FLUX's own
transformer is not ported yet. Module and parameter names follow
diffusers (`norm1.linear`, `net.0.proj`, `linear_1`), so the port's copy of
the reference's key maps loads a flax tree strictly. Parameters are fp32;
each op computes in `dtype`, cast per op (models/layers.py). The
affine-free layer norms take their statistics in fp32 and cast the result
to `dtype`, as flax's `nn.LayerNorm(dtype=...)` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.layers import linear


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
