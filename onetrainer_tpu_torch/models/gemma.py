"""Gemma-2 text encoder, Sana's conditioning model.

Counterpart of onetrainer_tpu/models/gemma.py (reference:
modules/model/util/gemma_util.py, transformers Gemma2Model): the decoder
stack used as an encoder, with grouped-query attention and RoPE on rotated
halves (models/llama.py:rope), attention-logit soft-capping
(cap * tanh(logits / cap)), the `query_pre_attn_scalar` softmax scale,
sandwich RMS norms that scale by (1 + weight), the tanh-GELU-gated MLP and
the final norm. Module and parameter names follow transformers
(`embed_tokens`, `layers.0.self_attn.q_proj`, `layers.0.mlp.gate_proj`,
`layers.0.pre_feedforward_layernorm`, `norm`).

Numerics kept from the reference: parameters fp32 unless the caller casts
them, each dense op in `cfg.dtype`; the embeddings scaled by
sqrt(hidden) rounded to that dtype; RoPE in fp32, cast back; the attention
a plain fp32 einsum with the causal and padding mask as a -1e9 fill
before the softmax (as T5's and Llama's: it runs outside any kernel); the
norms' statistics in fp32. The encoder returns the hidden state before
each layer and the post-norm output (the transformers convention
`encode_gemma_text` indexes); a layer-skipped state takes the final norm
through `apply_gemma_final_norm`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.clip import embed_tokens
from onetrainer_tpu_torch.models.layers import linear
from onetrainer_tpu_torch.models.llama import rope


@dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    rope_theta: float = 10000.0
    attn_logit_softcapping: float = 50.0
    query_pre_attn_scalar: float = 256.0
    rms_norm_eps: float = 1e-6
    max_length: int = 300
    dtype: torch.dtype = torch.bfloat16


def gemma2_2b_config(**overrides) -> Gemma2Config:
    return Gemma2Config(**overrides)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


class GemmaRMSNorm(nn.Module):
    """RMS norm scaling by (1 + weight); the weight starts at zero."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return _rms_norm(x, self.weight, self.eps)


class Gemma2Attention(nn.Module):
    def __init__(self, cfg: Gemma2Config):
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
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * c.query_pre_attn_scalar ** -0.5
        if c.attn_logit_softcapping:
            cap = c.attn_logit_softcapping
            logits = cap * torch.tanh(logits / cap)
        logits = logits.masked_fill(~mask, -1e9)
        probs = F.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
        return linear(self.o_proj, out.reshape(b, s, c.num_heads * c.head_dim).to(dt), dt)


class Gemma2MLP(nn.Module):
    def __init__(self, cfg: Gemma2Config):
        super().__init__()
        self.dtype = cfg.dtype
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        dt = self.dtype
        h = F.gelu(linear(self.gate_proj, x, dt), approximate="tanh") * linear(self.up_proj, x, dt)
        return linear(self.down_proj, h, dt)


class Gemma2Layer(nn.Module):
    def __init__(self, cfg: Gemma2Config):
        super().__init__()
        dim, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = GemmaRMSNorm(dim, eps)
        self.self_attn = Gemma2Attention(cfg)
        self.post_attention_layernorm = GemmaRMSNorm(dim, eps)
        self.pre_feedforward_layernorm = GemmaRMSNorm(dim, eps)
        self.mlp = Gemma2MLP(cfg)
        self.post_feedforward_layernorm = GemmaRMSNorm(dim, eps)

    def forward(self, x, mask):
        x = x + self.post_attention_layernorm(self.self_attn(self.input_layernorm(x), mask))
        return x + self.post_feedforward_layernorm(self.mlp(self.pre_feedforward_layernorm(x)))


class Gemma2Encoder(nn.Module):
    def __init__(self, cfg: Gemma2Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Gemma2Layer(cfg) for _ in range(cfg.num_layers))
        self.norm = GemmaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                extra_embeddings: torch.Tensor | None = None) -> dict:
        """[B, S] token ids (and their [B, S] keep mask) -> {"hidden_states":
        the state before each layer and the post-norm output,
        "last_hidden_state": that output}, in the compute dtype.
        `extra_embeddings` [N, hidden] are trained vectors appended past the
        vocabulary (ids >= vocab_size index them)."""
        c = self.cfg
        x = embed_tokens(input_ids, self.embed_tokens.weight, extra_embeddings).to(c.dtype)
        x = x * torch.tensor(c.hidden_size ** 0.5, dtype=c.dtype, device=x.device)
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


def encode_gemma_text(outputs: dict, layer_skip: int = 0) -> torch.Tensor:
    """hidden_states[-1 - layer_skip]; [-1] is the post-norm output
    (reference: gemma_util.encode_gemma; an earlier layer takes the final
    norm through `apply_gemma_final_norm`)."""
    states = outputs["hidden_states"]
    return states[len(states) - 1 - layer_skip]


def apply_gemma_final_norm(text_encoder: Gemma2Encoder, x: torch.Tensor,
                           eps: float = 1e-6) -> torch.Tensor:
    """The encoder's final RMS norm on a layer-skipped hidden state
    (reference: gemma_util.encode_gemma:26-28)."""
    return _rms_norm(x, text_encoder.norm.weight, eps)
