"""Load / save PixArt checkpoints in the diffusers directory layout.

Counterpart of onetrainer_tpu/io/pixart_checkpoints.py (reference:
modules/modelLoader/pixartAlpha/PixArtAlphaModelLoader.py): transformer/
(PixArtTransformer2DModel), vae/ (the SD-shaped VAE), text_encoder/
(T5-XXL), tokenizer/, scheduler/. The port's modules carry diffusers' and
transformers' key names, so each component's tensors load as they are
stored (T5's tied `encoder.embed_tokens.weight` copy is dropped, as the
reference's key map drops it); the saver writes one file per component,
as the reference's does. A config without `use_additional_conditions`
turns the micro-conditions on for sample size 128 (PixArt-α at 1024 px),
as diffusers does. The original-repo single file is io/single_file.py's.
"""

from __future__ import annotations

import os

import torch

from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
from onetrainer_tpu_torch.io.sd3_checkpoints import (
    copy_component_files, t5_config_from_transformers, t5_state_dict,
)
from onetrainer_tpu_torch.io.sd_checkpoints import (
    _cast, _meta, _tokenizer_dir, load_component, vae_config_from_diffusers,
)
from onetrainer_tpu_torch.models.pixart import PixArtConfig

_COMPONENTS = ("transformer", "vae", "text_encoder", "tokenizer", "scheduler")


def pixart_config_from_diffusers(config: dict, dtype=torch.bfloat16,
                                 gradient_checkpointing=False) -> PixArtConfig:
    return PixArtConfig(
        sample_size=config.get("sample_size", 64),
        patch_size=config.get("patch_size", 2),
        in_channels=config.get("in_channels", 4),
        out_channels=config.get("out_channels", 8),
        num_layers=config.get("num_layers", 28),
        num_heads=config.get("num_attention_heads", 16),
        head_dim=config.get("attention_head_dim", 72),
        cross_attention_dim=config.get("cross_attention_dim", 4096),
        caption_channels=config.get("caption_channels", 4096),
        # diffusers: use_additional_conditions defaults to sample_size==128
        # (alpha-1024 micro-conditions); sigma configs set it False
        use_additional_conditions=(
            config["use_additional_conditions"]
            if config.get("use_additional_conditions") is not None
            else config.get("sample_size", 64) == 128),
        gradient_checkpointing=gradient_checkpointing,
        dtype=dtype,
    )


def load_pixart_diffusers(base_dir: str, weight_dtype=torch.float32,
                          compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                          device: torch.device | str = "cuda") -> dict:
    """Load a diffusers PixArt directory: configs and state dicts on
    `device` (floats in `weight_dtype`), the tokenizer dir."""
    tcfg, transformer = load_component(base_dir, "transformer", device, weight_dtype)
    vcfg, vae = load_component(base_dir, "vae", device, weight_dtype)
    te_cfg, te = load_component(base_dir, "text_encoder", device, weight_dtype)
    return {
        "transformer_config": pixart_config_from_diffusers(
            tcfg or {}, compute_dtype, gradient_checkpointing),
        "vae_config": vae_config_from_diffusers(vcfg or {}, compute_dtype),
        "te_config": t5_config_from_transformers(te_cfg or {}, compute_dtype),
        "transformer": transformer,
        "vae": vae,
        "text_encoder": t5_state_dict(te),
        "tokenizer_dir": _tokenizer_dir(base_dir, "tokenizer"),
        "prediction_type": "epsilon",
    }


def save_pixart_diffusers(base_dir: str, model, transformer: dict, vae: dict, te: dict,
                          save_dtype=torch.float32, metadata: dict | None = None,
                          source_dir: str | None = None):
    """Write a diffusers-layout PixArt checkpoint from state dicts, one
    safetensors file per component; each component's non-weight files
    (config.json, tokenizer files) are copied from `source_dir` when
    given."""
    copy_component_files(source_dir, base_dir, _COMPONENTS)
    meta = _meta(metadata)
    for name, stem, sd in (("transformer", "diffusion_pytorch_model", transformer),
                           ("vae", "diffusion_pytorch_model", vae),
                           ("text_encoder", "model", te)):
        os.makedirs(os.path.join(base_dir, name), exist_ok=True)
        save_safetensors(os.path.join(base_dir, name, f"{stem}.safetensors"),
                         _cast(sd, save_dtype), meta)
