"""CLIP / OpenCLIP text encoders.

Counterpart of onetrainer_tpu/models/clip.py. Module and parameter names
follow `transformers.CLIPTextModelWithProjection` (`text_model.encoder.
layers.0.self_attn.q_proj.weight`, `text_projection.weight`), so the
reference's `io/torch_flax.py` CLIP key map loads a flax tree strictly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from onetrainer_tpu_torch.models.layers import layer_norm, linear
from onetrainer_tpu_torch.ops.attention import attention


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"      # SD2/SDXL-G: "gelu"
    projection_dim: int | None = None   # SDXL TE2: 1280
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.bfloat16


def clip_vit_l_config(**overrides) -> CLIPTextConfig:
    """SD1.5 / SDXL TE1 / SD3 clip_l."""
    return CLIPTextConfig(**overrides)


def open_clip_vit_bigg_config(**overrides) -> CLIPTextConfig:
    """SDXL TE2 / SD3 clip_g (with projection)."""
    kwargs = dict(hidden_size=1280, intermediate_size=5120, num_layers=32,
                  num_heads=20, hidden_act="gelu", projection_dim=1280)
    kwargs.update(overrides)
    return CLIPTextConfig(**kwargs)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)   # exact (erf) gelu, as the reference's approximate=False


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x, mask):
        dt = self.cfg.dtype
        out = attention(linear(self.q_proj, x, dt), linear(self.k_proj, x, dt),
                        linear(self.v_proj, x, dt), self.cfg.num_heads, mask=mask)
        return linear(self.out_proj, out, dt)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        dt = self.cfg.dtype
        return linear(self.fc2, _act(self.cfg.hidden_act, linear(self.fc1, x, dt)), dt)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        dt = self.cfg.dtype
        x = x + self.self_attn(layer_norm(self.layer_norm1, x, dt), mask)
        return x + self.mlp(layer_norm(self.layer_norm2, x, dt))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """Returns all hidden states so callers can layer-skip.

    `extra_embeddings` — optional [N, hidden] trained vectors appended to
    the token embedding table (textual inversion); token ids >= vocab_size
    index into it."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)
        self.text_projection = (nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                          bias=False)
                                if cfg.projection_dim is not None else None)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                extra_embeddings: torch.Tensor | None = None) -> dict:
        c = self.cfg
        tm = self.text_model
        b, s = input_ids.shape
        table = tm.embeddings.token_embedding.weight
        if extra_embeddings is not None:
            table = torch.cat([table, extra_embeddings.to(table.dtype)], dim=0)
        x = F.embedding(input_ids.long(), table)
        x = (x + tm.embeddings.position_embedding.weight[None, :s]).to(c.dtype)

        # causal mask (CLIP text is causal), combined with padding
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=x.device))[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].to(torch.bool)

        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
            hidden_states.append(x)
        final = layer_norm(tm.final_layer_norm, x, c.dtype)

        # pooled output: hidden state at the first eos token per row
        eos = torch.argmax((input_ids == c.eos_token_id).to(torch.int32), dim=1)
        pooled = final[torch.arange(b, device=x.device), eos]
        if self.text_projection is not None:
            pooled = linear(self.text_projection, pooled.float(), torch.float32)
        return {
            "hidden_states": hidden_states,   # embeddings + every layer output
            "last_hidden_state": final,
            "pooled_output": pooled,
        }


def encode_clip_text(outputs: dict, layer_skip: int = 0) -> torch.Tensor:
    """Pick the hidden state `layer_skip` layers before the end; SDXL reads
    the penultimate layer (layer_skip=1)."""
    states = outputs["hidden_states"]
    return states[len(states) - 1 - layer_skip]
