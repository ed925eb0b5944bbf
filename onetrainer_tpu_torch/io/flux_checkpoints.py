"""Load / save FLUX checkpoints in the diffusers directory layout.

Counterpart of onetrainer_tpu/io/flux_checkpoints.py (reference:
modules/modelLoader/flux/FluxModelLoader.py,
modules/modelSaver/flux/FluxModelSaver.py): transformer/
(FluxTransformer2DModel; FLUX.1-dev ships it as three shards behind an
index), vae/ (16 channels), text_encoder/ (CLIP-L), text_encoder_2/
(T5-XXL, two shards), tokenizer/, tokenizer_2/, scheduler/. The port's
modules carry diffusers' and transformers' key names, so each component's
tensors load as they are stored (T5's tied `encoder.embed_tokens.weight`
copy is dropped, as the reference's key map drops it); the savers write
one file per component, as the reference's do. The transformer is built
with the reference's FLUX checkpoint policy (models/remat.py:
FLUX_POLICY), its input width read from the config: 64 for FLUX.1-dev,
384 for FLUX.1-fill. The BFL single file is io/single_file.py's.
"""

from __future__ import annotations

import os
from dataclasses import replace

import torch

from onetrainer_tpu_torch.io.sd3_checkpoints import (
    copy_component_files, t5_config_from_transformers, t5_state_dict,
)
from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
from onetrainer_tpu_torch.io.sd_checkpoints import (
    _cast, _meta, _tokenizer_dir, clip_config_from_transformers, load_component,
    vae_config_from_diffusers,
)
from onetrainer_tpu_torch.models.flux import FluxConfig
from onetrainer_tpu_torch.models.remat import FLUX_POLICY

_COMPONENTS = ("transformer", "vae", "text_encoder", "text_encoder_2", "tokenizer",
               "tokenizer_2", "scheduler")


def flux_config_from_diffusers(config: dict, dtype=torch.bfloat16,
                               gradient_checkpointing=False) -> FluxConfig:
    return FluxConfig(
        in_channels=config.get("in_channels", 64),
        out_channels=config.get("out_channels") or config.get("in_channels", 64),
        num_layers=config.get("num_layers", 19),
        num_single_layers=config.get("num_single_layers", 38),
        hidden_size=config.get("num_attention_heads", 24)
        * config.get("attention_head_dim", 128),
        num_heads=config.get("num_attention_heads", 24),
        head_dim=config.get("attention_head_dim", 128),
        joint_attention_dim=config.get("joint_attention_dim", 4096),
        pooled_projection_dim=config.get("pooled_projection_dim", 768),
        guidance_embeds=config.get("guidance_embeds", True),
        axes_dims_rope=tuple(config.get("axes_dims_rope", (16, 56, 56))),
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=FLUX_POLICY,
        dtype=dtype,
    )


def load_flux_diffusers(base_dir: str, weight_dtype=torch.float32,
                        compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                        device: torch.device | str = "cuda") -> dict:
    """Load a diffusers FLUX directory: configs and state dicts on `device`
    (floats in `weight_dtype`; sharded components through their index),
    tokenizer dirs."""
    tcfg_json, transformer = load_component(base_dir, "transformer", device, weight_dtype)
    vae_cfg_json, vae = load_component(base_dir, "vae", device, weight_dtype)
    te_cfg_json, te = load_component(base_dir, "text_encoder", device, weight_dtype)
    te2_cfg_json, te2 = load_component(base_dir, "text_encoder_2", device, weight_dtype)
    vae_cfg = vae_config_from_diffusers(vae_cfg_json or {}, compute_dtype)
    if vae_cfg_json is None:
        vae_cfg = replace(vae_cfg, latent_channels=16, scaling_factor=0.3611,
                          shift_factor=0.1159)
    return {
        "transformer_config": flux_config_from_diffusers(
            tcfg_json or {}, compute_dtype, gradient_checkpointing),
        "vae_config": vae_cfg,
        "te_config": clip_config_from_transformers(te_cfg_json or {}, compute_dtype),
        "te2_config": t5_config_from_transformers(te2_cfg_json or {}, compute_dtype),
        "transformer": transformer,
        "vae": vae,
        "text_encoder": te,
        "text_encoder_2": t5_state_dict(te2),
        "tokenizer_dir": _tokenizer_dir(base_dir, "tokenizer"),
        "tokenizer_2_dir": _tokenizer_dir(base_dir, "tokenizer_2"),
        "prediction_type": "flow",
    }


def save_flux_diffusers(base_dir: str, model, transformer: dict, vae: dict, te: dict,
                        te2: dict, save_dtype=torch.float32, metadata: dict | None = None,
                        source_dir: str | None = None):
    """Write a diffusers-layout FLUX checkpoint from state dicts, one
    safetensors file per component; each component's non-weight files
    (config.json, tokenizer files) are copied from `source_dir` when
    given."""
    copy_component_files(source_dir, base_dir, _COMPONENTS)
    meta = _meta(metadata)
    for name, stem, sd in (("transformer", "diffusion_pytorch_model", transformer),
                           ("vae", "diffusion_pytorch_model", vae),
                           ("text_encoder", "model", te), ("text_encoder_2", "model", te2)):
        os.makedirs(os.path.join(base_dir, name), exist_ok=True)
        save_safetensors(os.path.join(base_dir, name, f"{stem}.safetensors"),
                         _cast(sd, save_dtype), meta)
