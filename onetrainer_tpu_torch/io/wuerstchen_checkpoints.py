"""Load / save Würstchen v2 and Stable Cascade checkpoints.

Counterpart of onetrainer_tpu/io/wuerstchen_checkpoints.py (reference:
modules/modelLoader/wuerstchen/WuerstchenModelLoader.py,
modules/modelSaver/wuerstchen/WuerstchenModelSaver.py). The prior
directory (warp-ai/wuerstchen-prior's layout) holds prior/, text_encoder/
and tokenizer/; the EfficientNet encoder is a separate safetensors file
with torchvision's keys (`backbone.*`, `mapper.*`); the decoder directory
(warp-ai/wuerstchen's: decoder/, vqgan/, text_encoder/, tokenizer/) serves
sampling only. The port's modules carry diffusers', transformers' and
torchvision's key names, so each component loads as it is stored (BatchNorm's
`num_batches_tracked` and the VQGAN's unused codebook `vquantizer.*`
dropped, a channelwise MLP without its Dropout slot renamed, as the
reference's key maps do). `effnet_flax_key_map` is the port's copy of the
reference's map from its flax module paths to torchvision's keys
(io/weights.py carries the reference's trees with it). Stable Cascade's
stage_c single file is io/single_file.py's.
"""

from __future__ import annotations

import json
import os
import re

import torch

from onetrainer_tpu_torch.io.safetensors_io import load_safetensors, save_safetensors
from onetrainer_tpu_torch.io.sd3_checkpoints import copy_component_files
from onetrainer_tpu_torch.io.sd_checkpoints import (
    _cast, _meta, _tokenizer_dir, clip_config_from_transformers, load_component,
)
from onetrainer_tpu_torch.models.cascade import CascadePriorConfig
from onetrainer_tpu_torch.models.diffnext import DiffNeXtConfig
from onetrainer_tpu_torch.models.paella_vq import PaellaVQConfig
from onetrainer_tpu_torch.models.wuerstchen import EffnetConfig, WuerstchenPriorConfig


def prior_config_from_diffusers(config: dict, dtype=torch.bfloat16,
                                gradient_checkpointing=False):
    """A prior config.json -> Stable Cascade's config (a StableCascadeUNet)
    or Würstchen v2's."""
    if "block_out_channels" in config or "down_num_layers_per_block" in config \
            or str(config.get("_class_name", "")) == "StableCascadeUNet":
        hidden = tuple(config.get("block_out_channels", (2048, 2048)))
        return CascadePriorConfig(
            c_in=config.get("in_channels", 16),
            c_hidden=hidden,
            nhead=tuple(config.get("num_attention_heads", (32, 32))),
            blocks=tuple(config.get("down_num_layers_per_block", (8, 24))),
            c_cond=config.get("c_cond", hidden[0]),
            clip_text_in=config.get("clip_text_in_channels", 1280),
            clip_text_pooled_in=config.get("clip_text_pooled_in_channels", 1280),
            clip_image_in=config.get("clip_image_in_channels", 768),
            patch_size=config.get("patch_size", 1),
            gradient_checkpointing=gradient_checkpointing,
            dtype=dtype,
        )
    return WuerstchenPriorConfig(
        c_in=config.get("c_in", 16),
        c=config.get("c", 1536),
        c_cond=config.get("c_cond", 1024),
        c_r=config.get("c_r", 64),
        depth=config.get("depth", 32),
        nhead=config.get("nhead", 24),
        gradient_checkpointing=gradient_checkpointing,
        dtype=dtype,
    )


# -- EfficientNet encoder: the reference's flax paths -> torchvision's keys ---------

def effnet_flax_key_map(key: str) -> str:
    """The reference's effnet flax path (in split_int_tokens form, e.g.
    'stage1.0.block0.conv.weight') -> torchvision's key. The SE module
    always sits at torch index block.2 (after expand + depthwise)."""
    key = key.replace("stem.conv.", "backbone.0.0.")
    key = key.replace("stem.norm.", "backbone.0.1.")
    key = re.sub(r"^stage(\d+)\.(\d+)\.se\.fc([12])\.",
                 r"backbone.\1.\2.block.2.fc\3.", key)
    key = re.sub(r"^stage(\d+)\.(\d+)\.block(\d+)\.conv\.",
                 r"backbone.\1.\2.block.\3.0.", key)
    key = re.sub(r"^stage(\d+)\.(\d+)\.block(\d+)\.norm\.",
                 r"backbone.\1.\2.block.\3.1.", key)
    key = key.replace("head.conv.", "backbone.7.0.")
    key = key.replace("head.norm.", "backbone.7.1.")
    key = key.replace("mapper_conv.", "mapper.0.")
    key = key.replace("mapper_norm.", "mapper.1.")
    return key


def effnet_state_dict(sd: dict) -> dict:
    """An effnet file's tensors as the port's encoder takes them."""
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def load_effnet(effnet_path: str | None, device, dtype) -> dict | None:
    """The EfficientNet encoder's state dict (floats in `dtype`), or None
    without a file."""
    if not effnet_path or not os.path.isfile(effnet_path):
        return None
    return effnet_state_dict(load_safetensors(effnet_path, device, dtype))


def load_wuerstchen_diffusers(base_dir: str, effnet_path: str | None = None,
                              weight_dtype=torch.float32, compute_dtype=torch.bfloat16,
                              gradient_checkpointing=False,
                              device: torch.device | str = "cuda") -> dict:
    """A prior directory and the effnet file -> configs and state dicts on
    `device` (floats in `weight_dtype`; the effnet None without a file)."""
    prior_cfg, prior = load_component(base_dir, "prior", device, weight_dtype)
    te_cfg, te = load_component(base_dir, "text_encoder", device, weight_dtype)
    return {
        "prior_config": prior_config_from_diffusers(prior_cfg or {}, compute_dtype,
                                                    gradient_checkpointing),
        "te_config": clip_config_from_transformers(te_cfg or {}, compute_dtype),
        "effnet_config": EffnetConfig(dtype=compute_dtype),
        "prior": prior,
        "text_encoder": te,
        "effnet": load_effnet(effnet_path, device, weight_dtype),
        "tokenizer_dir": _tokenizer_dir(base_dir, "tokenizer"),
        "prediction_type": "epsilon",
    }


def save_wuerstchen_diffusers(base_dir: str, model, prior: dict, te: dict | None,
                              save_dtype=torch.float32, metadata: dict | None = None,
                              source_dir: str | None = None) -> None:
    """Write the prior and the text encoder in the prior directory's layout,
    each component's non-weight files copied from `source_dir` when given
    (the reference's saver writes neither the effnet nor a decoder)."""
    copy_component_files(source_dir, base_dir, ("prior", "text_encoder", "tokenizer",
                                                "scheduler"))
    meta = _meta(metadata)
    parts = [("prior", "diffusion_pytorch_model", prior)]
    if te is not None:
        parts.append(("text_encoder", "model", te))
    for name, stem, sd in parts:
        os.makedirs(os.path.join(base_dir, name), exist_ok=True)
        save_safetensors(os.path.join(base_dir, name, f"{stem}.safetensors"),
                         _cast(sd, save_dtype), meta)


# -- the decoder stage (DiffNeXt, the Paella VQGAN, the decoder's CLIP) -------------

def diffnext_config_from_diffusers(config: dict, dtype=torch.bfloat16) -> DiffNeXtConfig:
    return DiffNeXtConfig(
        c_in=config.get("c_in", 4),
        c_out=config.get("c_out", 4),
        c_r=config.get("c_r", 64),
        patch_size=config.get("patch_size", 2),
        c_cond=config.get("c_cond", 1024),
        c_hidden=tuple(config.get("c_hidden", (320, 640, 1280, 1280))),
        nhead=tuple(config.get("nhead", (-1, 10, 20, 20))),
        blocks=tuple(config.get("blocks", (4, 4, 14, 4))),
        level_config=tuple(config.get("level_config", ("CT", "CTA", "CTA", "CTA"))),
        inject_effnet=tuple(config.get("inject_effnet", (False, True, True, True))),
        effnet_embd=config.get("effnet_embd", 16),
        clip_embd=config.get("clip_embd", 1024),
        kernel_size=config.get("kernel_size", 3),
        dtype=dtype,
    )


def paella_vq_config_from_diffusers(config: dict, dtype=torch.float32) -> PaellaVQConfig:
    return PaellaVQConfig(
        in_channels=config.get("in_channels", 3),
        out_channels=config.get("out_channels", 3),
        up_down_scale_factor=config.get("up_down_scale_factor", 2),
        levels=config.get("levels", 2),
        bottleneck_blocks=config.get("bottleneck_blocks", 12),
        embed_dim=config.get("embed_dim", 384),
        latent_channels=config.get("latent_channels", 4),
        scale_factor=config.get("scale_factor", 0.3764),
        dtype=dtype,
    )


def paella_vq_key_map(key: str) -> str | None:
    """The quantizer's codebook is unused (decoding never quantizes); a
    channelwise MLP without the Dropout slot is renamed."""
    if key.startswith("vquantizer."):
        return None
    return key.replace("channelwise.3.weight", "channelwise.4.weight") \
              .replace("channelwise.3.bias", "channelwise.4.bias")


def paella_vq_state_dict(sd: dict) -> dict:
    out = {}
    for key, value in sd.items():
        key = paella_vq_key_map(key)
        if key is not None:
            out[key] = value
    return out


def load_wuerstchen_decoder(decoder_dir: str, weight_dtype=torch.float32,
                            compute_dtype=torch.bfloat16,
                            device: torch.device | str = "cuda") -> dict:
    """The decoder stage of a Würstchen decoder directory: DiffNeXt (floats
    in `weight_dtype`), the VQGAN (fp32) and the decoder's CLIP text encoder
    (None without one), with their configs; attach with
    models/wuerstchen_model.py:attach_decoder."""
    dec_cfg, decoder = load_component(decoder_dir, "decoder", device, weight_dtype)
    vq_cfg, vqgan = load_component(decoder_dir, "vqgan", device, torch.float32)
    te_cfg, te = load_component(decoder_dir, "text_encoder", device, weight_dtype)
    return {
        "decoder_config": diffnext_config_from_diffusers(dec_cfg or {}, compute_dtype),
        "vqgan_config": paella_vq_config_from_diffusers(vq_cfg or {}),
        "decoder_te_config": clip_config_from_transformers(te_cfg, compute_dtype)
        if te_cfg else None,
        "decoder": decoder,
        "vqgan": None if vqgan is None else paella_vq_state_dict(vqgan),
        "decoder_text_encoder": te,
        "decoder_tokenizer_dir": _tokenizer_dir(decoder_dir, "tokenizer"),
    }


def save_wuerstchen_decoder(decoder_dir: str, decoder: dict, vqgan: dict, te: dict | None,
                            configs: dict, save_dtype=torch.float32) -> None:
    """Write a decoder directory: decoder/, vqgan/ and text_encoder/, each
    with its `configs[name]` as config.json (diffusers' and transformers'
    field names), for `load_wuerstchen_decoder`."""
    for name, stem, sd in (("decoder", "diffusion_pytorch_model", decoder),
                           ("vqgan", "diffusion_pytorch_model", vqgan),
                           ("text_encoder", "model", te)):
        if sd is None:
            continue
        os.makedirs(os.path.join(decoder_dir, name), exist_ok=True)
        save_safetensors(os.path.join(decoder_dir, name, f"{stem}.safetensors"),
                         _cast(sd, save_dtype), _meta(None))
        with open(os.path.join(decoder_dir, name, "config.json"), "w", encoding="utf-8") as f:
            json.dump(configs[name], f)
