"""Load / save HunyuanVideo checkpoints in the diffusers directory layout.

Counterpart of onetrainer_tpu/io/hunyuan_checkpoints.py (reference:
modules/modelLoader/hunyuanVideo/HunyuanVideoModelLoader.py): transformer/
(HunyuanVideoTransformer3DModel), vae/ (the causal video VAE),
text_encoder/ (LlamaModel), text_encoder_2/ (CLIPTextModel), tokenizer/,
tokenizer_2/; any component may be sharded behind an index.

The numpy key maps are the port's copies of the reference's
(`hunyuan_state_dict_to_flax` and the others): the tests carry the
reference's flax trees into the port through them (io/weights.py). The
port's modules carry diffusers' and transformers' key names, so each
component's tensors load as they are stored, with two changes the
reference's maps make too: the transformer's `x_embedder.proj.weight`, a
conv3d kernel [dim, C, 1, 2, 2] on disk, is the port's dense weight
[dim, 4C] (`hunyuan_transformer_state_dict`; the saver reshapes it back),
and Llama's `model.` prefix (a LlamaForCausalLM file) is dropped, with its
`lm_head` (an encoder has no head). The saver writes every component, one
file each (the reference's writes only the transformer and Llama; a
directory it writes lacks the VAE's and CLIP's weights).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
from onetrainer_tpu_torch.io.sd3_checkpoints import copy_component_files
from onetrainer_tpu_torch.io.sd_checkpoints import (
    _cast, _meta, _tokenizer_dir, clip_config_from_transformers, load_component,
)
from onetrainer_tpu_torch.io.torch_flax import flax_params_to_torch, torch_state_dict_to_flax
from onetrainer_tpu_torch.models.hunyuan_video import HunyuanVideoConfig
from onetrainer_tpu_torch.models.llama import LlamaConfig
from onetrainer_tpu_torch.models.remat import HUNYUAN_POLICY
from onetrainer_tpu_torch.models.video_vae import VideoVAEConfig

_COMPONENTS = ("transformer", "vae", "text_encoder", "text_encoder_2", "tokenizer",
               "tokenizer_2", "scheduler")
_X_EMBEDDER = "x_embedder.proj.weight"
_LLAMA_EMBEDDING_PATHS = frozenset({("embed_tokens",)})


# -- the reference's key maps (numpy) ------------------------------------------------

def hunyuan_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    sd = dict(state_dict)
    key = "x_embedder.proj.weight"
    if key in sd and np.asarray(sd[key]).ndim == 5:
        w = np.asarray(sd[key])                 # [dim, C, 1, 2, 2]
        sd[key] = w.reshape(w.shape[0], -1)     # -> [dim, C*4] (c-major, 2x2)
    return torch_state_dict_to_flax(sd)


def hunyuan_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    sd = flax_params_to_torch(params)
    key = "x_embedder.proj.weight"
    if key in sd:
        w = np.asarray(sd[key])                 # [dim, C*4]
        sd[key] = w.reshape(w.shape[0], -1, 1, 2, 2)
    return sd


def llama_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    def key_map(key):
        return key[len("model."):] if key.startswith("model.") else key
    return torch_state_dict_to_flax(state_dict, key_map=key_map,
                                    embedding_paths=_LLAMA_EMBEDDING_PATHS)


def llama_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    return flax_params_to_torch(params, embedding_paths=_LLAMA_EMBEDDING_PATHS)


def video_vae_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    return torch_state_dict_to_flax(state_dict)


def video_vae_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    return flax_params_to_torch(params)


# -- the port's modules <-> the files ------------------------------------------------

def hunyuan_transformer_state_dict(state_dict: dict) -> dict:
    """A diffusers transformer's tensors as the port's module holds them:
    the patchify conv3d kernel [dim, C, 1, 2, 2] as a dense weight
    [dim, 4C] (c-major, then the 2x2 patch, as pack_video_latents packs).
    Tensors or numpy arrays."""
    sd = dict(state_dict)
    w = sd.get(_X_EMBEDDER)
    if w is not None and w.ndim == 5:
        sd[_X_EMBEDDER] = w.reshape(w.shape[0], -1)
    return sd


def hunyuan_diffusers_state_dict(state_dict: dict) -> dict:
    """The port's transformer tensors in the diffusers layout (the inverse
    of `hunyuan_transformer_state_dict`)."""
    sd = dict(state_dict)
    w = sd.get(_X_EMBEDDER)
    if w is not None and w.ndim == 2:
        sd[_X_EMBEDDER] = w.reshape(w.shape[0], -1, 1, 2, 2)
    return sd


def llama_state_dict(state_dict: dict | None) -> dict | None:
    """A Llama file's tensors as the port's LlamaEncoder names them: the
    `model.` prefix of a LlamaForCausalLM file stripped, its `lm_head`
    dropped."""
    if state_dict is None:
        return None
    return {k.removeprefix("model."): v for k, v in state_dict.items()
            if not k.startswith("lm_head.")}


# -- configs ---------------------------------------------------------------------------

def hunyuan_config_from_diffusers(config: dict, dtype=torch.bfloat16,
                                  gradient_checkpointing=False) -> HunyuanVideoConfig:
    return HunyuanVideoConfig(
        in_channels=config.get("in_channels", 16),
        out_channels=config.get("out_channels", 16),
        num_layers=config.get("num_layers", 20),
        num_single_layers=config.get("num_single_layers", 40),
        num_refiner_layers=config.get("num_refiner_layers", 2),
        hidden_size=config.get("num_attention_heads", 24)
        * config.get("attention_head_dim", 128),
        num_heads=config.get("num_attention_heads", 24),
        head_dim=config.get("attention_head_dim", 128),
        text_embed_dim=config.get("text_embed_dim", 4096),
        pooled_projection_dim=config.get("pooled_projection_dim", 768),
        guidance_embeds=config.get("guidance_embeds", True),
        axes_dims_rope=tuple(config.get("rope_axes_dim", (16, 56, 56))),
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=HUNYUAN_POLICY,
        dtype=dtype,
    )


def llama_config_from_transformers(config: dict, dtype=torch.bfloat16) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=config.get("vocab_size", 128320),
        hidden_size=config.get("hidden_size", 4096),
        intermediate_size=config.get("intermediate_size", 14336),
        num_layers=config.get("num_hidden_layers", 32),
        num_heads=config.get("num_attention_heads", 32),
        num_kv_heads=config.get("num_key_value_heads", 8),
        head_dim=config.get("head_dim",
                            config.get("hidden_size", 4096)
                            // config.get("num_attention_heads", 32)),
        rope_theta=config.get("rope_theta", 500000.0),
        rms_norm_eps=config.get("rms_norm_eps", 1e-5),
        dtype=dtype,
    )


def video_vae_config_from_diffusers(config: dict, dtype=torch.bfloat16) -> VideoVAEConfig:
    return VideoVAEConfig(
        in_channels=config.get("in_channels", 3),
        latent_channels=config.get("latent_channels", 16),
        block_out_channels=tuple(config.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=config.get("layers_per_block", 2),
        temporal_compression=config.get("temporal_compression_ratio", 4),
        spatial_compression=config.get("spatial_compression_ratio", 8),
        scaling_factor=config.get("scaling_factor", 0.476986),
        dtype=dtype,
    )


# -- load / save ---------------------------------------------------------------------

def load_hunyuan_diffusers(base_dir: str, weight_dtype=torch.float32,
                           compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                           device: torch.device | str = "cuda") -> dict:
    """Load a diffusers HunyuanVideo directory: configs and state dicts on
    `device` (floats in `weight_dtype`; sharded components through their
    index), in the port's module layout, and the tokenizer dirs."""
    tcfg, transformer = load_component(base_dir, "transformer", device, weight_dtype)
    vcfg, vae = load_component(base_dir, "vae", device, weight_dtype)
    lcfg, te = load_component(base_dir, "text_encoder", device, weight_dtype)
    ccfg, te2 = load_component(base_dir, "text_encoder_2", device, weight_dtype)
    return {
        "transformer_config": hunyuan_config_from_diffusers(
            tcfg or {}, compute_dtype, gradient_checkpointing),
        "vae_config": video_vae_config_from_diffusers(vcfg or {}, compute_dtype),
        "te_config": llama_config_from_transformers(lcfg or {}, compute_dtype),
        "te2_config": clip_config_from_transformers(ccfg or {}, compute_dtype),
        "transformer": None if transformer is None
        else hunyuan_transformer_state_dict(transformer),
        "vae": vae,
        "text_encoder": llama_state_dict(te),
        "text_encoder_2": te2,
        "tokenizer_dir": _tokenizer_dir(base_dir, "tokenizer"),
        "tokenizer_2_dir": _tokenizer_dir(base_dir, "tokenizer_2"),
        "prediction_type": "flow",
    }


def save_hunyuan_diffusers(base_dir: str, model, transformer: dict, vae: dict, te: dict,
                           te2: dict, save_dtype=torch.float32, metadata: dict | None = None,
                           source_dir: str | None = None):
    """Write a diffusers-layout HunyuanVideo checkpoint from the port's state
    dicts, one safetensors file per component; each component's non-weight
    files (config.json, tokenizer files) are copied from `source_dir` when
    given."""
    copy_component_files(source_dir, base_dir, _COMPONENTS)
    meta = _meta(metadata)
    for name, stem, sd in (
            ("transformer", "diffusion_pytorch_model", hunyuan_diffusers_state_dict(transformer)),
            ("vae", "diffusion_pytorch_model", vae), ("text_encoder", "model", te),
            ("text_encoder_2", "model", te2)):
        os.makedirs(os.path.join(base_dir, name), exist_ok=True)
        save_safetensors(os.path.join(base_dir, name, f"{stem}.safetensors"),
                         _cast(sd, save_dtype), meta)
