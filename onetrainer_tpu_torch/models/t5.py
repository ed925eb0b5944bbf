"""T5 (v1.1) encoder stack, the SD3 (and FLUX) text encoder.

Counterpart of onetrainer_tpu/models/t5.py. Module and parameter names
follow `transformers.T5EncoderModel` (`shared`, `encoder.block.0.layer.0.
SelfAttention.q`, `encoder.block.0.layer.1.DenseReluDense.wi_0`), so the
port's copy of the reference's T5 key map loads a flax tree strictly. RMS
layer norms, the relative position bias of the first block shared by
every block, the gated-gelu feed-forward, no biases anywhere.

Numerics kept from the reference: attention without the 1/sqrt(d) scale,
its logits and softmax in fp32 (the reference's attention here is a plain
einsum, outside any kernel, and so is the port's); the probabilities cast
to the compute dtype before they weight v; the tanh-approximate gelu;
parameters fp32, every op in `cfg.dtype`. `layer_skip` > 0 runs only the
first num_layers - skip blocks and re-applies the final layer norm (the
reference's encode_t5 semantics).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.clip import embed_tokens
from onetrainer_tpu_torch.models.layers import linear


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.bfloat16


def t5_xxl_config(**overrides) -> T5Config:
    return T5Config(**overrides)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        x = x / torch.sqrt(x.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (self.weight.float() * x).to(self.dtype)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional buckets: half for negative positions, exact below
    num_buckets/4, logarithmic up to max_distance (fp32, as the reference)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / log_ratio
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.relative_attention_bias = (
            nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)
            if has_relative_bias else None)

    def position_bias(self, s: int, device) -> torch.Tensor:
        """[1, H, S, S] fp32 bias from the bucket table."""
        c = self.cfg
        pos = torch.arange(s, device=device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], c.relative_attention_num_buckets,
            c.relative_attention_max_distance)
        return self.relative_attention_bias.weight.float()[buckets.long()].permute(2, 0, 1)[None]

    def forward(self, x, position_bias):
        c = self.cfg
        dt = c.dtype
        b, s, _ = x.shape
        if self.relative_attention_bias is not None:
            position_bias = self.position_bias(s, x.device)
        qh = linear(self.q, x, dt).reshape(b, s, c.num_heads, c.d_kv)
        kh = linear(self.k, x, dt).reshape(b, s, c.num_heads, c.d_kv)
        vh = linear(self.v, x, dt).reshape(b, s, c.num_heads, c.d_kv)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
        if position_bias is not None:
            logits = logits + position_bias.float()
        weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        weights = weights / weights.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(dt), vh)
        return linear(self.o, out.reshape(b, s, c.num_heads * c.d_kv), dt), position_bias


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.dtype = cfg.dtype
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        dt = self.dtype
        h = F.gelu(linear(self.wi_0, h, dt), approximate="tanh") * linear(self.wi_1, h, dt)
        return linear(self.wo, h, dt)


class _FeedForwardLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_relative_bias),
                                    _FeedForwardLayer(cfg)])

    def forward(self, x, position_bias):
        attn, ff = self.layer
        out, position_bias = attn.SelfAttention(attn.layer_norm(x), position_bias)
        x = x + out
        return x + ff.DenseReluDense(ff.layer_norm(x)), position_bias


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, has_relative_bias=(i == 0))
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)

    def forward(self, input_ids: torch.Tensor, extra_embeddings: torch.Tensor | None = None,
                layer_skip: int = 0) -> torch.Tensor:
        """[B, S] token ids -> [B, S, d_model] in the compute dtype.
        `extra_embeddings` [N, d_model] are trained vectors appended past
        the vocabulary (ids >= vocab_size index them)."""
        x = embed_tokens(input_ids, self.shared.weight, extra_embeddings).to(self.cfg.dtype)
        position_bias = None
        run_blocks = max(self.cfg.num_layers - max(int(layer_skip), 0), 1)
        for block in self.encoder.block[:run_blocks]:
            x, position_bias = block(x, position_bias)
        return self.encoder.final_layer_norm(x)
