"""Load / save SD3 checkpoints in the diffusers directory layout.

Counterpart of onetrainer_tpu/io/sd3_checkpoints.py (reference:
modules/modelLoader/stableDiffusion3/StableDiffusion3ModelLoader.py,
modules/modelSaver/stableDiffusion3/*): transformer/, vae/, text_encoder/
(CLIP-L, projected), text_encoder_2/ (CLIP-G, projected), text_encoder_3/
(T5), tokenizer*/. The port's modules carry diffusers' and transformers'
key names, so each component's tensors load as they are stored (T5's tied
`encoder.embed_tokens.weight` copy is dropped, as the reference's key map
drops it). Every component loads in the transformer's (`prior`) weight
dtype, as the reference's loader does.

SD3.5-medium's dual attention (`dual_attention_layers`, the blocks'
`attn2`) is not in the reference's model, whose loader reads those
weights and never uses them; the port refuses such a checkpoint instead
of dropping them (ROADMAP F9). The SAI single file is io/single_file.py's.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import replace

import torch

from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
from onetrainer_tpu_torch.io.sd_checkpoints import (
    _cast, _meta, _tokenizer_dir, clip_config_from_transformers, load_component,
    vae_config_from_diffusers,
)
from onetrainer_tpu_torch.io.torch_flax import t5_torch_key_map
from onetrainer_tpu_torch.models.remat import SD3_POLICY
from onetrainer_tpu_torch.models.sd3 import SD3Config
from onetrainer_tpu_torch.models.t5 import T5Config

_COMPONENTS = ("transformer", "vae", "text_encoder", "text_encoder_2", "text_encoder_3",
               "tokenizer", "tokenizer_2", "tokenizer_3", "scheduler")


def sd3_config_from_diffusers(config: dict, dtype=torch.bfloat16,
                              gradient_checkpointing=False) -> SD3Config:
    if config.get("dual_attention_layers"):
        raise NotImplementedError(
            "SD3.5 dual attention (dual_attention_layers "
            f"{list(config['dual_attention_layers'])}) is not in the reference model "
            "(ROADMAP F9)")
    return SD3Config(
        sample_size=config.get("sample_size", 128),
        patch_size=config.get("patch_size", 2),
        in_channels=config.get("in_channels", 16),
        out_channels=config.get("out_channels", 16),
        num_layers=config.get("num_layers", 24),
        num_heads=config.get("num_attention_heads", 24),
        head_dim=config.get("attention_head_dim", 64),
        joint_attention_dim=config.get("joint_attention_dim", 4096),
        caption_projection_dim=config.get("caption_projection_dim", 1536),
        pooled_projection_dim=config.get("pooled_projection_dim", 2048),
        pos_embed_max_size=config.get("pos_embed_max_size", 192),
        qk_norm=config.get("qk_norm") == "rms_norm",
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=SD3_POLICY,
        dtype=dtype,
    )


def t5_config_from_transformers(config: dict, dtype=torch.bfloat16) -> T5Config:
    return T5Config(
        vocab_size=config.get("vocab_size", 32128),
        d_model=config.get("d_model", 4096),
        d_kv=config.get("d_kv", 64),
        d_ff=config.get("d_ff", 10240),
        num_layers=config.get("num_layers", 24),
        num_heads=config.get("num_heads", 64),
        relative_attention_num_buckets=config.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=config.get("relative_attention_max_distance", 128),
        dtype=dtype,
    )


def t5_state_dict(state_dict: dict | None) -> dict | None:
    """A T5 encoder's tensors without the ones the reference's key map
    drops (the tied `encoder.embed_tokens.weight` copy)."""
    if state_dict is None:
        return None
    return {k: v for k, v in state_dict.items() if t5_torch_key_map(k) is not None}


def copy_component_files(source_dir: str | None, base_dir: str, components) -> None:
    """Create `base_dir` and copy each component's non-weight files
    (config.json, tokenizer files) from `source_dir`, when given."""
    os.makedirs(base_dir, exist_ok=True)
    if not source_dir:
        return
    for name in components:
        src = os.path.join(source_dir, name)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(base_dir, name)
        os.makedirs(dst, exist_ok=True)
        for f in os.listdir(src):
            path = os.path.join(src, f)
            if os.path.isfile(path) and not f.endswith((".safetensors", ".bin",
                                                        ".index.json")):
                shutil.copy2(path, os.path.join(dst, f))


def _refuse_dual_attention(state_dict: dict) -> None:
    dual = sorted(k for k in state_dict if ".attn2." in k)
    if dual:
        raise NotImplementedError(
            f"SD3.5 dual attention ({len(dual)} attn2 tensors, e.g. {dual[0]}) is not "
            "in the reference model (ROADMAP F9)")


def load_sd3_diffusers(base_dir: str, weight_dtype=torch.float32,
                       compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                       device: torch.device | str = "cuda") -> dict:
    """Load a diffusers SD3 directory: configs and state dicts on `device`
    (floats in `weight_dtype`), tokenizer dirs. A dual-attention config or
    `attn2` weights raise (F9)."""
    tcfg_json, transformer = load_component(base_dir, "transformer", device, weight_dtype)
    transformer_config = sd3_config_from_diffusers(tcfg_json or {}, compute_dtype,
                                                   gradient_checkpointing)
    if transformer is not None:
        _refuse_dual_attention(transformer)
    vae_cfg_json, vae = load_component(base_dir, "vae", device, weight_dtype)
    te_cfg_json, te = load_component(base_dir, "text_encoder", device, weight_dtype)
    te2_cfg_json, te2 = load_component(base_dir, "text_encoder_2", device, weight_dtype)
    te3_cfg_json, te3 = load_component(base_dir, "text_encoder_3", device, weight_dtype)
    te3 = t5_state_dict(te3)

    def with_projection(cfg_json, default_dim):
        cfg = clip_config_from_transformers(cfg_json or {}, compute_dtype)
        if cfg.projection_dim is None:
            cfg = replace(cfg, projection_dim=(cfg_json or {}).get("projection_dim",
                                                                   default_dim))
        return cfg

    vae_cfg = vae_config_from_diffusers(vae_cfg_json or {}, compute_dtype)
    if vae_cfg_json is None:
        vae_cfg = replace(vae_cfg, latent_channels=16, scaling_factor=1.5305,
                          shift_factor=0.0609)
    return {
        "transformer_config": transformer_config,
        "vae_config": vae_cfg,
        "te_config": with_projection(te_cfg_json, 768),
        "te2_config": with_projection(te2_cfg_json, 1280),
        "te3_config": t5_config_from_transformers(te3_cfg_json or {}, compute_dtype),
        "transformer": transformer,
        "vae": vae,
        "text_encoder": te,
        "text_encoder_2": te2,
        "text_encoder_3": te3,
        "tokenizer_dir": _tokenizer_dir(base_dir, "tokenizer"),
        "tokenizer_2_dir": _tokenizer_dir(base_dir, "tokenizer_2"),
        "tokenizer_3_dir": _tokenizer_dir(base_dir, "tokenizer_3"),
        "prediction_type": "flow",
    }


def save_sd3_diffusers(base_dir: str, model, transformer: dict, vae: dict, te: dict,
                       te2: dict, te3: dict | None, save_dtype=torch.float32,
                       metadata: dict | None = None, source_dir: str | None = None):
    """Write a diffusers-layout SD3 checkpoint from state dicts; each
    component's non-weight files (config.json, tokenizer files) are copied
    from `source_dir` when given."""
    copy_component_files(source_dir, base_dir, _COMPONENTS)
    meta = _meta(metadata)
    parts = [("transformer", "diffusion_pytorch_model", transformer),
             ("vae", "diffusion_pytorch_model", vae), ("text_encoder", "model", te),
             ("text_encoder_2", "model", te2)]
    if te3 is not None:
        parts.append(("text_encoder_3", "model", te3))
    for name, stem, sd in parts:
        os.makedirs(os.path.join(base_dir, name), exist_ok=True)
        save_safetensors(os.path.join(base_dir, name, f"{stem}.safetensors"),
                         _cast(sd, save_dtype), meta)
