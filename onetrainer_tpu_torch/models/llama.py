"""Llama text encoder, HunyuanVideo's primary conditioning model.

Counterpart of onetrainer_tpu/models/llama.py: the Llama-3 decoder stack
used as an encoder (grouped-query attention with RoPE on rotated halves,
RMS norms, the SiLU-gated MLP). Module and parameter names follow
`transformers.LlamaModel` (`embed_tokens`, `layers.0.self_attn.q_proj`,
`layers.0.mlp.gate_proj`, `layers.0.input_layernorm`, `norm`), so the
port's copy of the reference's key map loads a flax tree strictly.

Numerics kept from the reference: parameters fp32 unless the caller casts
them, each dense op in `cfg.dtype`; RoPE in fp32, cast back; the
attention a plain fp32 einsum (the reference leaves it to XLA, outside
any kernel, and so does the port) with the causal and padding mask as a
-1e9 fill before the softmax; the norms' statistics in fp32. The encoder
returns the hidden state before each layer and the post-norm output, the
transformers convention that `encode_llama_text` indexes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.clip import embed_tokens
from onetrainer_tpu_torch.models.layers import linear


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128320
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_length: int = 256
    dtype: torch.dtype = torch.bfloat16


def llama3_8b_config(**overrides) -> LlamaConfig:
    return LlamaConfig(**overrides)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D] rotated by positions [B, S] on its two halves (the
    Llama/Gemma layout), in fp32, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions.float()[:, :, None] * freqs[None, None]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LlamaRMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.q_proj = nn.Linear(c.hidden_size, c.num_heads * c.head_dim, bias=False)
        self.k_proj = nn.Linear(c.hidden_size, c.num_kv_heads * c.head_dim, bias=False)
        self.v_proj = nn.Linear(c.hidden_size, c.num_kv_heads * c.head_dim, bias=False)
        self.o_proj = nn.Linear(c.num_heads * c.head_dim, c.hidden_size, bias=False)

    def forward(self, x, mask):
        c = self.cfg
        dt = c.dtype
        b, s, _ = x.shape
        q = linear(self.q_proj, x, dt).reshape(b, s, c.num_heads, c.head_dim)
        k = linear(self.k_proj, x, dt).reshape(b, s, c.num_kv_heads, c.head_dim)
        v = linear(self.v_proj, x, dt).reshape(b, s, c.num_kv_heads, c.head_dim)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q, k = rope(q, positions, c.rope_theta), rope(k, positions, c.rope_theta)
        groups = c.num_heads // c.num_kv_heads
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * c.head_dim ** -0.5
        logits = logits.masked_fill(~mask, -1e9)
        probs = F.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
        return linear(self.o_proj, out.reshape(b, s, c.num_heads * c.head_dim).to(dt), dt)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        dt = self.dtype
        h = F.silu(linear(self.gate_proj, x, dt)) * linear(self.up_proj, x, dt)
        return linear(self.down_proj, h, dt)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.input_layernorm(x), mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaEncoder(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                extra_embeddings: torch.Tensor | None = None) -> dict:
        """[B, S] token ids (and their [B, S] keep mask) -> {"hidden_states":
        the state before each layer and the post-norm output,
        "last_hidden_state": that output}, in the compute dtype.
        `extra_embeddings` [N, hidden] are trained vectors appended past the
        vocabulary (ids >= vocab_size index them)."""
        x = embed_tokens(input_ids, self.embed_tokens.weight, extra_embeddings).to(self.cfg.dtype)
        s = input_ids.shape[1]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.to(torch.bool)[:, None, None, :]
        hidden_states = []
        for layer in self.layers:
            hidden_states.append(x)
            x = layer(x, mask)
        final = self.norm(x)
        hidden_states.append(final)
        return {"hidden_states": hidden_states, "last_hidden_state": final}


def encode_llama_text(outputs: dict, layer_skip: int = 0, default_layer: int = -3,
                      crop_start: int | None = None) -> torch.Tensor:
    """hidden_states[default_layer - layer_skip], cropped past the prompt
    template (HunyuanVideo: layer -3, crop 95)."""
    states = outputs["hidden_states"]
    picked = states[len(states) + default_layer - layer_skip]
    if crop_start is not None:
        picked = picked[:, crop_start:]
    return picked
