"""Load / save Sana checkpoints in the diffusers directory layout.

Counterpart of onetrainer_tpu/io/sana_checkpoints.py (reference:
modules/modelLoader/sana/SanaModelLoader.py): transformer/
(SanaTransformer2DModel), vae/ (AutoencoderDC), text_encoder/ (Gemma-2),
tokenizer/, scheduler/.

The numpy key maps are the port's copies of the reference's
(`sana_state_dict_to_flax` and the others): the tests carry the
reference's flax trees into the port through them (io/weights.py). The
port's modules carry diffusers' and transformers' key names, so each
component's tensors load as they are stored, Gemma's `model.` prefix (a
Gemma2ForCausalLM file) dropped with its `lm_head`, and the caption
projection's keys of a file the reference wrote renamed to diffusers'
(`sana_transformer_state_dict`, ROADMAP F20). The DC-AE keys are
the reference's flax tree's, which round-trip within both packages (a
diffusers AutoencoderDC file may lay its blocks out differently: the
reference's own note). Whether the self- and cross-attention projections
carry biases is read from the transformer's first block, as the
reference's loader does. The saver writes every component, one file each
(the reference's writes only the transformer and Gemma, so a directory it
writes lacks the DC-AE's weights).
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import torch

from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
from onetrainer_tpu_torch.io.sd3_checkpoints import copy_component_files
from onetrainer_tpu_torch.io.sd_checkpoints import (
    _cast, _meta, _tokenizer_dir, load_component,
)
from onetrainer_tpu_torch.io.torch_flax import flax_params_to_torch, torch_state_dict_to_flax
from onetrainer_tpu_torch.models.dcae import DCAEConfig
from onetrainer_tpu_torch.models.gemma import Gemma2Config
from onetrainer_tpu_torch.models.sana import SanaConfig

_COMPONENTS = ("transformer", "vae", "text_encoder", "tokenizer", "scheduler")


# -- the reference's key maps (numpy) ------------------------------------------------

_SANA_RENAMES = [
    ("patch_embed.proj.", "patch_embed_proj."),
    ("time_embed.emb.timestep_embedder.", "time_embed_emb_timestep_embedder."),
    ("time_embed.linear.", "time_embed_linear."),
    ("caption_projection.linear_1.", "caption_projection_linear_1."),
    ("caption_projection.linear_2.", "caption_projection_linear_2."),
]


def sana_torch_key_map(key: str) -> str:
    for torch_prefix, flax_prefix in _SANA_RENAMES:
        if key.startswith(torch_prefix):
            return flax_prefix + key[len(torch_prefix):]
    return key


def sana_flax_key_map(key: str) -> str:
    for torch_prefix, flax_prefix in _SANA_RENAMES:
        if key.startswith(flax_prefix):
            return torch_prefix + key[len(flax_prefix):]
    return key


def sana_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    # scale_shift_table leaves pass through the generic converter untouched
    # (2D, leaf name is neither 'weight' nor 'bias')
    return torch_state_dict_to_flax(state_dict, key_map=sana_torch_key_map)


def sana_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    return flax_params_to_torch(params, key_map=sana_flax_key_map)


_GEMMA_EMBEDDING_PATHS = frozenset({("embed_tokens",)})


def gemma_torch_key_map(key: str) -> str | None:
    if key.startswith("model."):
        key = key[len("model."):]
    return key


def gemma_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    return torch_state_dict_to_flax(
        state_dict, key_map=gemma_torch_key_map,
        embedding_paths=_GEMMA_EMBEDDING_PATHS)


def gemma_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    return flax_params_to_torch(
        params, embedding_paths=_GEMMA_EMBEDDING_PATHS)


def dcae_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    return torch_state_dict_to_flax(state_dict)


def dcae_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    return flax_params_to_torch(params)


# -- the port's modules <-> the files ------------------------------------------------

# the caption projection's layers as the reference's flax-to-torch map names
# them: its flax module `caption_projection_linear_1` splits back into
# `caption_projection_linear.1` (ROADMAP F20), where diffusers has
# `caption_projection.linear_1`
_REFERENCE_CAPTION_KEYS = {f"caption_projection_linear.{i}.": f"caption_projection.linear_{i}."
                           for i in (1, 2)}


def sana_transformer_state_dict(state_dict: dict | None) -> dict | None:
    """A Sana transformer's tensors as the port's module names them (the
    diffusers keys): the caption projection's keys of a file the reference
    wrote renamed to diffusers', every other key as it is."""
    if state_dict is None:
        return None
    out = {}
    for key, value in state_dict.items():
        for ref, ours in _REFERENCE_CAPTION_KEYS.items():
            if key.startswith(ref):
                key = ours + key[len(ref):]
        out[key] = value
    return out


def gemma_state_dict(state_dict: dict | None) -> dict | None:
    """A Gemma file's tensors as the port's Gemma2Encoder names them: the
    `model.` prefix of a Gemma2ForCausalLM file stripped, its `lm_head`
    dropped."""
    if state_dict is None:
        return None
    return {k.removeprefix("model."): v for k, v in state_dict.items()
            if not k.startswith("lm_head.")}


# -- configs ---------------------------------------------------------------------------

def sana_config_from_diffusers(config: dict, dtype=torch.bfloat16,
                               gradient_checkpointing=False) -> SanaConfig:
    return SanaConfig(
        in_channels=config.get("in_channels", 32),
        out_channels=config.get("out_channels", 32),
        num_layers=config.get("num_layers", 20),
        num_attention_heads=config.get("num_attention_heads", 70),
        attention_head_dim=config.get("attention_head_dim", 32),
        num_cross_attention_heads=config.get("num_cross_attention_heads", 20),
        cross_attention_head_dim=config.get("cross_attention_head_dim", 112),
        caption_channels=config.get("caption_channels", 2304),
        mlp_ratio=config.get("mlp_ratio", 2.5),
        patch_size=config.get("patch_size", 1),
        gradient_checkpointing=gradient_checkpointing,
        dtype=dtype,
    )


def gemma_config_from_transformers(config: dict, dtype=torch.bfloat16) -> Gemma2Config:
    return Gemma2Config(
        vocab_size=config.get("vocab_size", 256000),
        hidden_size=config.get("hidden_size", 2304),
        intermediate_size=config.get("intermediate_size", 9216),
        num_layers=config.get("num_hidden_layers", 26),
        num_heads=config.get("num_attention_heads", 8),
        num_kv_heads=config.get("num_key_value_heads", 4),
        head_dim=config.get("head_dim", 256),
        rope_theta=config.get("rope_theta", 10000.0),
        attn_logit_softcapping=config.get("attn_logit_softcapping", 50.0),
        query_pre_attn_scalar=config.get("query_pre_attn_scalar", 256.0),
        dtype=dtype,
    )


def dcae_config_from_diffusers(config: dict, dtype=torch.bfloat16) -> DCAEConfig:
    enc = tuple(config.get("encoder_block_out_channels",
                           (128, 256, 512, 512, 1024, 1024)))
    dec = tuple(config.get("decoder_block_out_channels", enc))
    n = len(enc)
    return DCAEConfig(
        in_channels=config.get("in_channels", 3),
        latent_channels=config.get("latent_channels", 32),
        encoder_block_out_channels=enc,
        decoder_block_out_channels=dec,
        encoder_layers_per_block=tuple(
            config.get("encoder_layers_per_block", (2, 2, 2, 3, 3, 3))[:n]),
        decoder_layers_per_block=tuple(
            config.get("decoder_layers_per_block", (3, 3, 3, 3, 3, 3))[:n]),
        vit_stages=tuple(
            "Sana" in str(t) or "ViT" in str(t)
            for t in config.get("encoder_block_types",
                                ["ResBlock"] * 3 + ["EfficientViTBlock"] * 3)),
        attention_head_dim=config.get("attention_head_dim", 32),
        scaling_factor=config.get("scaling_factor", 0.41407),
        dtype=dtype,
    )


# -- load / save ---------------------------------------------------------------------

def load_sana_diffusers(base_dir: str, weight_dtype=torch.float32,
                        compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                        device: torch.device | str = "cuda") -> dict:
    """Load a diffusers Sana directory: configs and state dicts on `device`
    (floats in `weight_dtype`), in the port's module layout, and the
    tokenizer dir."""
    tcfg, transformer = load_component(base_dir, "transformer", device, weight_dtype)
    vcfg, vae = load_component(base_dir, "vae", device, weight_dtype)
    gcfg, te = load_component(base_dir, "text_encoder", device, weight_dtype)
    tconfig = sana_config_from_diffusers(tcfg or {}, compute_dtype, gradient_checkpointing)
    transformer = sana_transformer_state_dict(transformer)
    if transformer is not None:
        tconfig = replace(
            tconfig, qkv_bias="transformer_blocks.0.attn1.to_q.bias" in transformer,
            cross_qkv_bias="transformer_blocks.0.attn2.to_q.bias" in transformer)
    return {
        "transformer_config": tconfig,
        "vae_config": dcae_config_from_diffusers(vcfg or {}, compute_dtype),
        "te_config": gemma_config_from_transformers(gcfg or {}, compute_dtype),
        "transformer": transformer,
        "vae": vae,
        "text_encoder": gemma_state_dict(te),
        "tokenizer_dir": _tokenizer_dir(base_dir, "tokenizer"),
        "prediction_type": "flow",
    }


def save_sana_diffusers(base_dir: str, model, transformer: dict, vae: dict | None,
                        te: dict | None, save_dtype=torch.float32,
                        metadata: dict | None = None, source_dir: str | None = None):
    """Write a diffusers-layout Sana checkpoint from state dicts, one
    safetensors file per component present; each component's non-weight
    files (config.json, tokenizer files) are copied from `source_dir` when
    given."""
    copy_component_files(source_dir, base_dir, _COMPONENTS)
    meta = _meta(metadata)
    for name, stem, sd in (("transformer", "diffusion_pytorch_model", transformer),
                           ("vae", "diffusion_pytorch_model", vae),
                           ("text_encoder", "model", te)):
        if sd is None:
            continue
        os.makedirs(os.path.join(base_dir, name), exist_ok=True)
        save_safetensors(os.path.join(base_dir, name, f"{stem}.safetensors"),
                         _cast(sd, save_dtype), meta)
