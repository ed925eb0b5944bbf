"""Load / save SD 1.5/2.x and SDXL checkpoints: diffusers directories and
LDM single files.

Counterpart of onetrainer_tpu/io/sd_checkpoints.py (reference:
modules/modelLoader/stableDiffusion/StableDiffusionModelLoader.py,
modules/modelSaver/stableDiffusion/StableDiffusionModelSaver.py).

A diffusers checkpoint directory looks like:
  unet/diffusion_pytorch_model.safetensors + config.json
  vae/diffusion_pytorch_model.safetensors + config.json
  text_encoder/model.safetensors + config.json (SDXL: text_encoder_2/ too)
  tokenizer/{vocab.json, merges.txt, ...}
  scheduler/scheduler_config.json

The port's modules carry diffusers' key names, so a component's tensors
load as they are stored; a single file goes through the port's copy of
the reference's key maps (io/ldm.py). Each tensor is read from the file,
moved to the target device and cast there (floats to the weight dtype),
so the host holds one tensor at a time. The loaders return configs and
state dicts; `setup/families.py` builds the model on the "meta" device
and assigns them (`assign_state_dict`). The savers take state dicts.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import replace

import torch
from torch import nn

from onetrainer_tpu_torch.io import ldm
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors, save_safetensors
from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
from onetrainer_tpu_torch.models.clip import CLIPTextConfig
from onetrainer_tpu_torch.models.unet import UNetConfig
from onetrainer_tpu_torch.models.vae import VAEConfig
from onetrainer_tpu_torch.ops.quant import dequantized_weight, is_quantized, module_is_quantized


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _find_weights(component_dir: str) -> str | None:
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        p = os.path.join(component_dir, name)
        if os.path.exists(p):
            return p
    # sharded checkpoints: *.safetensors.index.json
    for name in os.listdir(component_dir) if os.path.isdir(component_dir) else []:
        if name.endswith(".safetensors.index.json"):
            return os.path.join(component_dir, name)
    return None


def _load_weights(path: str, device, dtype) -> dict[str, torch.Tensor]:
    """A safetensors file or a sharded index, on `device`, floats in `dtype`."""
    if path.endswith(".index.json"):
        index = _read_json(path)
        base = os.path.dirname(path)
        out: dict[str, torch.Tensor] = {}
        for shard in sorted(set(index["weight_map"].values())):
            out.update(load_safetensors(os.path.join(base, shard), device, dtype))
        return out
    return load_safetensors(path, device, dtype)


def unet_config_from_diffusers(config: dict, dtype=torch.bfloat16,
                               gradient_checkpointing=False) -> UNetConfig:
    down_types = config.get("down_block_types",
                            ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
    block_out = tuple(config.get("block_out_channels", [320, 640, 1280, 1280]))
    heads = config.get("attention_head_dim", 8)
    if isinstance(heads, int):
        heads = [heads] * len(block_out)
    transformer_layers = config.get("transformer_layers_per_block", 1)
    if isinstance(transformer_layers, int):
        transformer_layers = [transformer_layers] * len(block_out)
    addition_embed = config.get("addition_time_embed_dim")
    return UNetConfig(
        in_channels=config.get("in_channels", 4),
        out_channels=config.get("out_channels", 4),
        block_out_channels=block_out,
        cross_attn_blocks=tuple(t == "CrossAttnDownBlock2D" for t in down_types),
        layers_per_block=config.get("layers_per_block", 2),
        transformer_layers_per_block=tuple(transformer_layers),
        num_heads=tuple(heads),
        cross_attention_dim=config.get("cross_attention_dim", 768),
        use_linear_projection=config.get("use_linear_projection", False),
        addition_embed_dim=addition_embed,
        addition_pooled_dim=1280 if addition_embed else None,
        gradient_checkpointing=gradient_checkpointing,
        remat_policy="tx_only",   # the reference's UNet default
        dtype=dtype,
    )


def vae_config_from_diffusers(config: dict, dtype=torch.bfloat16) -> VAEConfig:
    return VAEConfig(
        in_channels=config.get("in_channels", 3),
        out_channels=config.get("out_channels", 3),
        latent_channels=config.get("latent_channels", 4),
        block_out_channels=tuple(config.get("block_out_channels",
                                            [128, 256, 512, 512])),
        layers_per_block=config.get("layers_per_block", 2),
        scaling_factor=config.get("scaling_factor", 0.18215),
        shift_factor=config.get("shift_factor", 0.0) or 0.0,
        dtype=dtype,
    )


def clip_config_from_transformers(config: dict, dtype=torch.bfloat16) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=config.get("vocab_size", 49408),
        hidden_size=config.get("hidden_size", 768),
        intermediate_size=config.get("intermediate_size", 3072),
        num_layers=config.get("num_hidden_layers", 12),
        num_heads=config.get("num_attention_heads", 12),
        max_position_embeddings=config.get("max_position_embeddings", 77),
        hidden_act=config.get("hidden_act", "quick_gelu"),
        projection_dim=config.get("projection_dim")
        if "WithProjection" in str(config.get("architectures", "")) else None,
        eos_token_id=config.get("eos_token_id", 49407),
        dtype=dtype,
    )


@torch.no_grad()
def assign_state_dict(module: nn.Module, state_dict: dict) -> None:
    """Make `state_dict`'s tensors `module`'s parameters, strictly (every
    key of the module, no other), keeping their device and dtype: the
    module may live on the "meta" device. A text encoder's
    `position_ids` buffer, and an unprojected one's `text_projection`,
    which the reference's loader ignores, are dropped first."""
    own = module.state_dict(keep_vars=True)
    tensors = {}
    for key, value in state_dict.items():
        if key not in own and (clip_torch_key_map(key) is None
                               or key == "text_projection.weight"):
            continue
        tensors[key] = value.contiguous()
    module.load_state_dict(tensors, strict=True, assign=True)


def load_component(base_dir: str, name: str, device, dtype):
    """One component subdir -> (config dict, state dict on `device`), or
    (None, None) when it has no weights."""
    component_dir = os.path.join(base_dir, name)
    weights = _find_weights(component_dir)
    if weights is None:
        return None, None
    config = {}
    config_path = os.path.join(component_dir, "config.json")
    if os.path.exists(config_path):
        config = _read_json(config_path)
    return config, _load_weights(weights, device, dtype)


def _tokenizer_dir(base_dir: str, name: str) -> str | None:
    path = os.path.join(base_dir, name)
    return path if os.path.isdir(path) else None


def load_sd_diffusers(base_dir: str, weight_dtype=torch.float32,
                      compute_dtype=torch.bfloat16,
                      gradient_checkpointing=False,
                      device: torch.device | str = "cuda") -> dict:
    """Load a diffusers SD checkpoint directory: configs, state dicts on
    `device` (floats in `weight_dtype`), scheduler config, tokenizer dir."""
    unet_cfg_json, unet = load_component(base_dir, "unet", device, weight_dtype)
    vae_cfg_json, vae = load_component(base_dir, "vae", device, weight_dtype)
    te_cfg_json, te = load_component(base_dir, "text_encoder", device, weight_dtype)

    scheduler_cfg = {}
    sched_path = os.path.join(base_dir, "scheduler", "scheduler_config.json")
    if os.path.exists(sched_path):
        scheduler_cfg = _read_json(sched_path)

    return {
        "unet_config": unet_config_from_diffusers(
            unet_cfg_json or {}, compute_dtype, gradient_checkpointing),
        "vae_config": vae_config_from_diffusers(vae_cfg_json or {}, compute_dtype),
        "te_config": clip_config_from_transformers(te_cfg_json or {}, compute_dtype),
        "unet": unet,
        "vae": vae,
        "text_encoder": te,
        "scheduler_config": scheduler_cfg,
        "tokenizer_dir": _tokenizer_dir(base_dir, "tokenizer"),
        "prediction_type": scheduler_cfg.get("prediction_type", "epsilon"),
    }


def _read_single_file(path: str, device, dtype) -> dict[str, torch.Tensor]:
    """A single-file checkpoint: .safetensors through the port's reader,
    .ckpt through torch's (weights only); floats in `dtype` on `device`."""
    if path.endswith((".ckpt", ".pt", ".bin")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        return {k: v.to(device=device, dtype=dtype if v.is_floating_point() else None)
                for k, v in sd.items() if isinstance(v, torch.Tensor)}
    return load_safetensors(path, device, dtype)


def load_sd_single_file(path: str, model_type, weight_dtype=torch.float32,
                        compute_dtype=torch.bfloat16,
                        gradient_checkpointing=False,
                        device: torch.device | str = "cuda") -> dict:
    """Load an SD 1.5/2.x LDM single-file checkpoint (reference:
    StableDiffusionModelLoader.py single-file fallback path); the configs
    are the model type's published ones (models/sd.py:create_sd_model)."""
    from onetrainer_tpu_torch.models import sd as sd_models

    split = ldm.split_sd15_single_file(_read_single_file(path, device, weight_dtype))
    template = sd_models.create_sd_model(
        model_type, dtype=compute_dtype,
        gradient_checkpointing=gradient_checkpointing, device="meta")
    # in_channels from the checkpoint (inpaint/depth variants)
    conv_in = split["unet"].get("conv_in.weight")
    unet_cfg = template.unet_config
    if conv_in is not None and conv_in.shape[1] != unet_cfg.in_channels:
        unet_cfg = replace(unet_cfg, in_channels=int(conv_in.shape[1]))
    prediction_type = "v_prediction" if model_type.value in (
        "STABLE_DIFFUSION_20", "STABLE_DIFFUSION_21") else "epsilon"
    return {
        "unet_config": unet_cfg,
        "vae_config": template.vae_config,
        "te_config": template.te_config,
        "unet": split["unet"],
        "vae": split["vae"],
        "text_encoder": split["text_encoder"],
        "scheduler_config": {},
        "tokenizer_dir": None,
        "prediction_type": prediction_type,
    }


def load_sdxl_diffusers(base_dir: str, weight_dtype=torch.float32,
                        compute_dtype=torch.bfloat16,
                        gradient_checkpointing=False,
                        device: torch.device | str = "cuda") -> dict:
    """Load a diffusers SDXL checkpoint directory (adds text_encoder_2 /
    tokenizer_2)."""
    out = load_sd_diffusers(base_dir, weight_dtype, compute_dtype,
                            gradient_checkpointing, device)
    te2_cfg_json, te2 = load_component(base_dir, "text_encoder_2", device, weight_dtype)
    te2_cfg = clip_config_from_transformers(te2_cfg_json or {}, compute_dtype)
    if te2_cfg_json and te2_cfg.projection_dim is None:
        # SDXL TE2 always projects; some config.jsons omit architectures
        te2_cfg = replace(te2_cfg, projection_dim=te2_cfg_json.get("projection_dim", 1280))
    out["te2_config"] = te2_cfg
    out["text_encoder_2"] = te2
    out["tokenizer_2_dir"] = _tokenizer_dir(base_dir, "tokenizer_2")
    return out


def load_sdxl_single_file(path: str, model_type, weight_dtype=torch.float32,
                          compute_dtype=torch.bfloat16,
                          gradient_checkpointing=False,
                          device: torch.device | str = "cuda") -> dict:
    from onetrainer_tpu_torch.models import sdxl as sdxl_models

    split = ldm.split_sdxl_single_file(_read_single_file(path, device, weight_dtype))
    template = sdxl_models.create_sdxl_model(
        model_type, dtype=compute_dtype,
        gradient_checkpointing=gradient_checkpointing, device="meta")
    return {
        "unet_config": template.unet_config,
        "vae_config": template.vae_config,
        "te_config": template.te_config,
        "te2_config": template.te2_config,
        "unet": split["unet"],
        "vae": split["vae"],
        "text_encoder": split["text_encoder"],
        "text_encoder_2": split["text_encoder_2"],
        "scheduler_config": {},
        "tokenizer_dir": None,
        "tokenizer_2_dir": None,
        "prediction_type": "epsilon",
    }


# -- saving ----------------------------------------------------------------------

def state_dict_of(module: nn.Module, save_dtype=None) -> dict[str, torch.Tensor]:
    """The module's state dict (detached), each quantized layer's weight
    (setup/quantize.py: a frozen part's fp8, int8 or NF4 codes) dequantized
    into it in the torch layout: to fp32 when a save dtype is given (the
    saver casts it), else to bf16, as the reference's _to_numpy_tree
    exports a quantized part. NF4 decodes through K4 on the card
    (ops/quant.py:dequantized_weight)."""
    sd = {k: v.detach() for k, v in module.state_dict().items()}
    if not module_is_quantized(module):
        return sd
    dtype = torch.float32 if save_dtype is not None else torch.bfloat16
    for name, layer in module.named_modules():
        weight = getattr(layer, "weight", None)
        if is_quantized(weight):
            sd[f"{name}.weight"] = dequantized_weight(weight, dtype).contiguous()
    return sd


def _cast(sd: dict, dtype) -> dict:
    """Float tensors in `dtype` (None keeps each tensor's own), on the host."""
    return {k: (v.to(dtype) if dtype is not None and v.is_floating_point() else v)
            .detach().cpu().contiguous() for k, v in sd.items()}


def _meta(metadata: dict | None) -> dict:
    return {"format": "pt", **(metadata or {})}


def _copy_aux(source_dir: str | None, base_dir: str, name: str) -> None:
    """Copy a component's non-weight files (config.json, tokenizer files)."""
    if source_dir is None:
        return
    src = os.path.join(source_dir, name)
    if not os.path.isdir(src):
        return
    dst = os.path.join(base_dir, name)
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(src):
        s = os.path.join(src, f)
        if os.path.isfile(s) and not f.endswith((".safetensors", ".bin")):
            shutil.copy2(s, os.path.join(dst, f))


def save_sd_diffusers(base_dir: str, model, unet: dict, vae: dict, te: dict,
                      save_dtype=torch.float32, metadata: dict | None = None,
                      source_dir: str | None = None):
    """Write a diffusers-layout checkpoint from state dicts. Config jsons
    and tokenizer are copied from source_dir when available (keeps the
    exact ecosystem metadata)."""
    os.makedirs(base_dir, exist_ok=True)
    for name in ("unet", "vae", "text_encoder", "tokenizer", "scheduler"):
        _copy_aux(source_dir, base_dir, name)
    if source_dir and os.path.exists(os.path.join(source_dir, "model_index.json")):
        shutil.copy2(os.path.join(source_dir, "model_index.json"),
                     os.path.join(base_dir, "model_index.json"))
    save_safetensors(os.path.join(base_dir, "unet", "diffusion_pytorch_model.safetensors"),
                     _cast(unet, save_dtype), _meta(metadata))
    save_safetensors(os.path.join(base_dir, "vae", "diffusion_pytorch_model.safetensors"),
                     _cast(vae, save_dtype), _meta(metadata))
    save_safetensors(os.path.join(base_dir, "text_encoder", "model.safetensors"),
                     _cast(te, save_dtype), _meta(metadata))


def save_sd_single_file(path: str, model, unet: dict, vae: dict, te: dict,
                        save_dtype=torch.float32, metadata=None):
    """Write an LDM single-file .safetensors (reference:
    StableDiffusionModelSaver SAFETENSORS format path)."""
    merged = ldm.merge_sd15_single_file(
        _cast(unet, save_dtype), _cast(vae, save_dtype), _cast(te, save_dtype),
        sd2_openclip=model.model_type.is_sd_v2())
    save_safetensors(path, merged, _meta(metadata))


def save_sdxl_single_file(path: str, model, unet: dict, vae: dict, te: dict,
                          te2: dict, save_dtype=torch.float32, metadata=None):
    merged = ldm.merge_sdxl_single_file(
        _cast(unet, save_dtype), _cast(vae, save_dtype), _cast(te, save_dtype),
        _cast(te2, save_dtype))
    save_safetensors(path, merged, _meta(metadata))


def save_sdxl_diffusers(base_dir: str, model, unet: dict, vae: dict, te: dict,
                        te2: dict, save_dtype=torch.float32,
                        metadata: dict | None = None, source_dir: str | None = None):
    save_sd_diffusers(base_dir, model, unet, vae, te, save_dtype, metadata, source_dir)
    for name in ("text_encoder_2", "tokenizer_2"):
        _copy_aux(source_dir, base_dir, name)
    save_safetensors(os.path.join(base_dir, "text_encoder_2", "model.safetensors"),
                     _cast(te2, save_dtype), _meta(metadata))
