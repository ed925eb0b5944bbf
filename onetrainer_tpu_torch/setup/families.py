"""Model-family registry: one adapter per family wiring loader, setup,
encode functions, sampler and save paths.

Counterpart of onetrainer_tpu/setup/families.py, for SD 1.5/2.x
text-to-image and inpainting, SDXL and its inpainting UNet, SD3,
FLUX.1-dev, FLUX.1-fill, HunyuanVideo, PixArt-α/Σ, Sana, Würstchen v2
and Stable Cascade (diffusers directories and single files: LDM, SAI,
BFL, HunyuanVideo's, PixArt's and Stable Cascade's stage_c; Sana's and
Würstchen v2's single-file exports raise, as the reference's; SD 2.0
depth and HiDream are not ported yet) so far. The calls mirror the reference's trainer and
scripts: `get_family(...)`, then `family.load`, `family.create_setup`,
`family.make_encode_fns` (the data caches) and `setup.train_step` or
`family.sample`; `family.save_model` / `save_single_file` write the model, LoRA adapters merged into their
layers and, when the state holds an EMA, the EMA in place of the trained
tensors (the reference trainer's `_export_params`), and
`save_lora_output` the kohya LoRA file. `load` runs on the card unless
the caller passes another device. A DiT single file may lack the VAE or a
text encoder: that part stays on the "meta" device, without weights, and
the savers leave it out.
"""

from __future__ import annotations

import os
from collections.abc import Callable
from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
from onetrainer_tpu_torch.peft.lora import apply_peft, peft_to_kohya_state_dict
from onetrainer_tpu_torch.util.enums import ModelType


@dataclass
class ModelFamily:
    name: str
    quantization: int       # bucket resolution step of the data loader
    load: Callable          # (base_dir, config, device="cuda") -> model
    create_setup: Callable  # (model, config, total_steps) -> setup
    make_encode_fns: Callable  # setup -> (encode_images, encode_text)
    sample: Callable        # (setup, sample_config, on_progress) -> SamplerOutput
    save_model: Callable    # (setup, dir, source_dir, save_dtype=None, ema=True) -> None
    save_single_file: Callable  # (setup, path, save_dtype=None, ema=True) -> None
    lora_prefixes: dict     # trainable group -> kohya prefix
    video: bool = False     # the data loader collects video files


# module attribute -> (its LoRA group, its adapters' key map)
_LORA_PARTS = {
    "unet": ("unet_lora", None),
    "transformer": ("transformer_lora", None),
    "prior": ("prior_lora", None),
    "text_encoder": ("te_lora", clip_torch_key_map),
    "text_encoder_2": ("te2_lora", clip_torch_key_map),
}


def _load_kwargs(config, device, part: str = "unet") -> dict:
    return dict(
        weight_dtype=getattr(config.weight_dtypes(), part).to_load_dtype() or torch.float32,
        compute_dtype=config.train_dtype.to_compute_dtype() or torch.bfloat16,
        gradient_checkpointing=config.gradient_checkpointing.enabled(),
        device=device,
    )


def _assign(model, loaded: dict, device, optional=()) -> None:
    """Give the model's parts (built on "meta") the loaded state dicts; a
    part of `optional` that the checkpoint lacks stays on "meta"."""
    from onetrainer_tpu_torch.io.sd_checkpoints import assign_state_dict
    for name in model.modules():
        if loaded.get(name) is None:
            if name in optional:
                continue
            raise FileNotFoundError(f"the checkpoint has no {name} weights")
        assign_state_dict(getattr(model, name), loaded[name])
        loaded[name] = None   # the model holds them now
    model.device = torch.device(device)


def merged_state_dicts(setup, ema: bool = False, save_dtype=None) -> dict[str, dict]:
    """{module attribute: state dict} of the setup's model, each LoRA-trained
    part with its adapters merged into the weights (peft/lora.py:
    apply_peft; over a quantized base, bf16 results), for export; a frozen
    part quantized by its weight dtype comes dequantized, to fp32 when the
    caller passes the `save_dtype` its saver casts to, else to bf16
    (io/sd_checkpoints.py:state_dict_of). With `ema` and an EMA in the
    train state, the EMA's fp32 tensors stand in for the trained ones
    (adapters, or a fine-tuned module's parameters). A setup's
    `lora_key_maps` {group: key map} replaces `_LORA_PARTS`' key maps (Sana's
    adapters take the reference's flax module paths). A part left on
    "meta" (a single file without it) maps to None."""
    from onetrainer_tpu_torch.io.sd_checkpoints import state_dict_of
    state = setup.state
    params = state.params if state is not None else {}
    if ema and state is not None and state.ema is not None:
        params = state.ema.params
    out = {}
    for name, module in setup.model.modules().items():
        if next(module.parameters()).is_meta:
            out[name] = None
            continue
        group, key_map = _LORA_PARTS.get(name, (None, None))
        key_map = getattr(setup, "lora_key_maps", {}).get(group, key_map)
        if group in params:
            out[name] = apply_peft(module, params[group], setup.peft_cfg, key_map)
        else:
            out[name] = state_dict_of(module, save_dtype)
            if name in params:   # a FINE_TUNE group: {parameter name: tensor}
                out[name].update({k: t.detach() for k, t in params[name].items()})
    return out


def _load_dit(base_dir, config, device, load_single_file, load_diffusers):
    """A DiT family's checkpoint, every component in the transformer's
    (prior) weight dtype, as the reference -> (the loader's dict, the parts
    it may lack: a single file's VAE and text encoders)."""
    single = os.path.isfile(base_dir)
    loaded = (load_single_file if single else load_diffusers)(
        base_dir, **_load_kwargs(config, device, "prior"))
    return loaded, ("vae", "text_encoder", "text_encoder_2", "text_encoder_3") if single else ()


def _modelspec(setup, prediction_type: bool = True) -> dict:
    """The safetensors header's modelspec; the reference's DiT single files
    carry no prediction type."""
    from onetrainer_tpu_torch.util.model_spec import make_modelspec_metadata
    return make_modelspec_metadata(
        setup.config.model_type, setup.config.training_method,
        resolution=setup.config.resolution,
        prediction_type=setup.model.prediction_type if prediction_type else "",
        train_config=setup.config)


# -- SD 1.5 / 2.x -------------------------------------------------------------------

def _sd_load(base_dir, config, device: torch.device | str = "cuda"):
    from onetrainer_tpu_torch.io.sd_checkpoints import load_sd_diffusers, load_sd_single_file
    from onetrainer_tpu_torch.models.sd import StableDiffusionModel
    kwargs = _load_kwargs(config, device)
    if os.path.isfile(base_dir):
        loaded = load_sd_single_file(base_dir, config.model_type, **kwargs)
    else:
        loaded = load_sd_diffusers(base_dir, **kwargs)
    model = StableDiffusionModel(
        model_type=config.model_type,
        unet_config=loaded["unet_config"],
        vae_config=loaded["vae_config"],
        te_config=loaded["te_config"],
        device="meta",
        prediction_type=loaded["prediction_type"],
        text_encoder_layer_skip=1 if config.model_type.is_sd_v2() else 0,
        tokenizer=loaded["tokenizer_dir"],
    )
    _assign(model, loaded, device)
    return model


def _sd_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.sd_setup import create_sd_setup
    return create_sd_setup(model, config, total_steps, steps_per_epoch)


def _sd_encode_fns(setup):
    from onetrainer_tpu_torch.setup.sd_setup import make_encode_fns
    return make_encode_fns(setup)


def _sd_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.sd_sampler import sample_stable_diffusion
    unet, te, extra = setup.merged_inference_params()
    return sample_stable_diffusion(
        setup.model, unet, te, setup.model.vae, setup.tokenizer,
        sample_config, extra_embeddings=extra, on_update_progress=on_progress)


def _sd_save_model(setup, out_dir, source_dir, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.sd_checkpoints import save_sd_diffusers
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_sd_diffusers(out_dir, setup.model, sd["unet"], sd["vae"], sd["text_encoder"],
                      save_dtype=save_dtype or torch.float32, source_dir=source_dir)


def _sd_save_single_file(setup, path, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.sd_checkpoints import save_sd_single_file
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_sd_single_file(path, setup.model, sd["unet"], sd["vae"], sd["text_encoder"],
                        metadata=_modelspec(setup), save_dtype=save_dtype or torch.float32)


# -- SDXL -----------------------------------------------------------------------------

def _sdxl_load(base_dir, config, device: torch.device | str = "cuda"):
    from onetrainer_tpu_torch.io.sd_checkpoints import (
        load_sdxl_diffusers, load_sdxl_single_file,
    )
    from onetrainer_tpu_torch.models.sdxl import StableDiffusionXLModel
    kwargs = _load_kwargs(config, device)
    if os.path.isfile(base_dir):
        loaded = load_sdxl_single_file(base_dir, config.model_type, **kwargs)
    else:
        loaded = load_sdxl_diffusers(base_dir, **kwargs)
    model = StableDiffusionXLModel(
        model_type=config.model_type,
        unet_config=loaded["unet_config"],
        vae_config=loaded["vae_config"],
        te_config=loaded["te_config"],
        te2_config=loaded["te2_config"],
        device="meta",
        prediction_type=loaded["prediction_type"],
        tokenizer=loaded["tokenizer_dir"],
        tokenizer_2=loaded["tokenizer_2_dir"],
    )
    _assign(model, loaded, device)
    return model


def _sdxl_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.sdxl_setup import create_sdxl_setup
    return create_sdxl_setup(model, config, total_steps, steps_per_epoch)


def _sdxl_encode_fns(setup):
    from onetrainer_tpu_torch.setup.sdxl_setup import make_sdxl_encode_fns
    return make_sdxl_encode_fns(setup)


def _sdxl_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.sdxl_sampler import sample_stable_diffusion_xl
    unet, te, te2, extra = setup.merged_inference_params()
    return sample_stable_diffusion_xl(
        setup.model, unet, te, te2, setup.model.vae,
        setup.tokenizer, setup.tokenizer_2, sample_config,
        extra_embeddings=extra, on_update_progress=on_progress)


def _sdxl_save_model(setup, out_dir, source_dir, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.sd_checkpoints import save_sdxl_diffusers
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_sdxl_diffusers(out_dir, setup.model, sd["unet"], sd["vae"], sd["text_encoder"],
                        sd["text_encoder_2"], save_dtype=save_dtype or torch.float32,
                        source_dir=source_dir)


def _sdxl_save_single_file(setup, path, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.sd_checkpoints import save_sdxl_single_file
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_sdxl_single_file(path, setup.model, sd["unet"], sd["vae"], sd["text_encoder"],
                          sd["text_encoder_2"], metadata=_modelspec(setup),
                          save_dtype=save_dtype or torch.float32)


# -- SD3 -----------------------------------------------------------------------------

def _sd3_load(base_dir, config, device: torch.device | str = "cuda"):
    from onetrainer_tpu_torch.io.sd3_checkpoints import load_sd3_diffusers
    from onetrainer_tpu_torch.io.single_file import load_sd3_single_file
    from onetrainer_tpu_torch.models.sd3_model import StableDiffusion3Model
    loaded, optional = _load_dit(base_dir, config, device, load_sd3_single_file,
                                 load_sd3_diffusers)
    model = StableDiffusion3Model(
        model_type=config.model_type,
        transformer_config=loaded["transformer_config"],
        vae_config=loaded["vae_config"],
        te_config=loaded["te_config"],
        te2_config=loaded["te2_config"],
        te3_config=loaded["te3_config"],
        device="meta",
        tokenizer=loaded["tokenizer_dir"],
        tokenizer_2=loaded["tokenizer_2_dir"],
        tokenizer_3=loaded["tokenizer_3_dir"],
    )
    _assign(model, loaded, device, optional)
    return model


def _sd3_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.sd3_setup import create_sd3_setup
    return create_sd3_setup(model, config, total_steps, steps_per_epoch)


def _sd3_encode_fns(setup):
    from onetrainer_tpu_torch.setup.sd3_setup import make_sd3_encode_fns
    return make_sd3_encode_fns(setup)


def _sd3_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.sd3_sampler import sample_sd3
    transformer, te, te2, te3, extra = setup.merged_inference_params()
    return sample_sd3(
        setup.model, transformer, te, te2, te3, setup.model.vae,
        setup.tokenizer, setup.tokenizer_2, setup.tokenizer_3, sample_config,
        extra_embeddings=extra, on_update_progress=on_progress)


def _sd3_save_model(setup, out_dir, source_dir, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.sd3_checkpoints import save_sd3_diffusers
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_sd3_diffusers(out_dir, setup.model, sd["transformer"], sd["vae"],
                       sd["text_encoder"], sd["text_encoder_2"], sd["text_encoder_3"],
                       save_dtype=save_dtype or torch.float32, source_dir=source_dir)


def _sd3_save_single_file(setup, path, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.single_file import save_sd3_single_file
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_sd3_single_file(path, sd["transformer"], sd["vae"], sd["text_encoder"],
                         sd["text_encoder_2"], sd["text_encoder_3"],
                         save_dtype=save_dtype or torch.float32,
                         metadata=_modelspec(setup, prediction_type=False))


# -- FLUX ----------------------------------------------------------------------------

def _flux_load(base_dir, config, device: torch.device | str = "cuda"):
    from onetrainer_tpu_torch.io.flux_checkpoints import load_flux_diffusers
    from onetrainer_tpu_torch.io.single_file import load_flux_single_file
    from onetrainer_tpu_torch.models.flux_model import FluxModel
    loaded, optional = _load_dit(base_dir, config, device, load_flux_single_file,
                                 load_flux_diffusers)
    model = FluxModel(
        model_type=config.model_type,
        transformer_config=loaded["transformer_config"],
        vae_config=loaded["vae_config"],
        te_config=loaded["te_config"],
        te2_config=loaded["te2_config"],
        device="meta",
        tokenizer=loaded["tokenizer_dir"],
        tokenizer_2=loaded["tokenizer_2_dir"],
    )
    _assign(model, loaded, device, optional)
    return model


def _flux_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.flux_setup import create_flux_setup
    return create_flux_setup(model, config, total_steps, steps_per_epoch)


def _flux_encode_fns(setup):
    from onetrainer_tpu_torch.setup.flux_setup import make_flux_encode_fns
    return make_flux_encode_fns(setup)


def _flux_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.flux_sampler import sample_flux
    transformer, te, te2, extra = setup.merged_inference_params()
    return sample_flux(
        setup.model, transformer, te, te2, setup.model.vae,
        setup.tokenizer, setup.tokenizer_2, sample_config,
        extra_embeddings=extra, on_update_progress=on_progress)


def _flux_save_model(setup, out_dir, source_dir, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.flux_checkpoints import save_flux_diffusers
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_flux_diffusers(out_dir, setup.model, sd["transformer"], sd["vae"],
                        sd["text_encoder"], sd["text_encoder_2"],
                        save_dtype=save_dtype or torch.float32, source_dir=source_dir)


def _flux_save_single_file(setup, path, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.single_file import save_flux_single_file
    sd = merged_state_dicts(setup, ema, save_dtype)
    save_flux_single_file(path, sd["transformer"], sd["vae"], sd["text_encoder"],
                          sd["text_encoder_2"], save_dtype=save_dtype or torch.float32,
                          metadata=_modelspec(setup, prediction_type=False))


# -- HunyuanVideo ----------------------------------------------------------------------

def _hunyuan_load(base_dir, config, device: torch.device | str = "cuda"):
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import load_hunyuan_diffusers
    from onetrainer_tpu_torch.io.single_file import load_hunyuan_single_file
    from onetrainer_tpu_torch.models.hunyuan_video_model import HunyuanVideoModel
    loaded, optional = _load_dit(base_dir, config, device, load_hunyuan_single_file,
                                 load_hunyuan_diffusers)
    model = HunyuanVideoModel(
        model_type=config.model_type,
        transformer_config=loaded["transformer_config"],
        vae_config=loaded["vae_config"],
        te_config=loaded["te_config"],
        te2_config=loaded["te2_config"],
        device="meta",
        tokenizer=loaded["tokenizer_dir"],
        tokenizer_2=loaded["tokenizer_2_dir"],
    )
    _assign(model, loaded, device, optional)
    return model


def _hunyuan_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.hunyuan_setup import create_hunyuan_setup
    return create_hunyuan_setup(model, config, total_steps, steps_per_epoch)


def _hunyuan_encode_fns(setup):
    from onetrainer_tpu_torch.setup.hunyuan_setup import make_hunyuan_encode_fns
    return make_hunyuan_encode_fns(setup)


def _hunyuan_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.hunyuan_sampler import sample_hunyuan_video
    transformer, te, te2, extra = setup.merged_inference_params()
    return sample_hunyuan_video(
        setup.model, transformer, te, te2, setup.model.vae,
        setup.tokenizer, setup.tokenizer_2, sample_config,
        extra_embeddings=extra, on_update_progress=on_progress)


def _hunyuan_save_model(setup, out_dir, source_dir, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import save_hunyuan_diffusers
    sd = merged_state_dicts(setup, ema, save_dtype)
    save_hunyuan_diffusers(out_dir, setup.model, sd["transformer"], sd["vae"],
                           sd["text_encoder"], sd["text_encoder_2"],
                           save_dtype=save_dtype or torch.float32, source_dir=source_dir)


def _hunyuan_save_single_file(setup, path, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.single_file import save_hunyuan_single_file
    sd = merged_state_dicts(setup, ema, save_dtype)
    save_hunyuan_single_file(path, sd["transformer"], sd["vae"], sd["text_encoder"],
                             sd["text_encoder_2"], save_dtype=save_dtype or torch.float32,
                             metadata=_modelspec(setup, prediction_type=False))


# -- PixArt ---------------------------------------------------------------------------

def _pixart_load(base_dir, config, device: torch.device | str = "cuda"):
    from onetrainer_tpu_torch.io.pixart_checkpoints import load_pixart_diffusers
    from onetrainer_tpu_torch.io.single_file import load_pixart_single_file
    from onetrainer_tpu_torch.models.pixart_model import PixArtAlphaModel
    loaded, optional = _load_dit(base_dir, config, device, load_pixart_single_file,
                                 load_pixart_diffusers)
    model = PixArtAlphaModel(
        model_type=config.model_type,
        transformer_config=loaded["transformer_config"],
        vae_config=loaded["vae_config"],
        te_config=loaded["te_config"],
        device="meta",
        tokenizer=loaded["tokenizer_dir"],
    )
    _assign(model, loaded, device, optional)
    return model


def _pixart_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.pixart_setup import create_pixart_setup
    return create_pixart_setup(model, config, total_steps, steps_per_epoch)


def _pixart_encode_fns(setup):
    from onetrainer_tpu_torch.setup.pixart_setup import make_pixart_encode_fns
    return make_pixart_encode_fns(setup)


def _pixart_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.pixart_sampler import sample_pixart
    transformer, te, extra = setup.merged_inference_params()
    return sample_pixart(setup.model, transformer, te, setup.model.vae, setup.tokenizer,
                         sample_config, extra_embeddings=extra,
                         on_update_progress=on_progress)


def _pixart_save_model(setup, out_dir, source_dir, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.pixart_checkpoints import save_pixart_diffusers
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_pixart_diffusers(out_dir, setup.model, sd["transformer"], sd["vae"],
                          sd["text_encoder"], save_dtype=save_dtype or torch.float32,
                          source_dir=source_dir)


def _pixart_save_single_file(setup, path, save_dtype=None, ema=True):
    """The original PixArt repository's layout, the transformer alone
    (reference: modules/util/convert/convert_pixart_diffusers_to_ckpt.py)."""
    from onetrainer_tpu_torch.io.single_file import save_pixart_single_file
    sd = merged_state_dicts(setup, ema, save_dtype)
    save_pixart_single_file(path, sd["transformer"], save_dtype=save_dtype or torch.float32,
                            metadata=_modelspec(setup, prediction_type=False))


# -- Sana ------------------------------------------------------------------------------

def _sana_load(base_dir, config, device: torch.device | str = "cuda"):
    from onetrainer_tpu_torch.io.sana_checkpoints import load_sana_diffusers
    from onetrainer_tpu_torch.models.sana_model import SanaModel
    loaded = load_sana_diffusers(base_dir, **_load_kwargs(config, device, "prior"))
    model = SanaModel(
        model_type=config.model_type,
        transformer_config=loaded["transformer_config"],
        vae_config=loaded["vae_config"],
        te_config=loaded["te_config"],
        device="meta",
        tokenizer=loaded["tokenizer_dir"],
    )
    _assign(model, loaded, device)
    return model


def _sana_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.sana_setup import create_sana_setup
    return create_sana_setup(model, config, total_steps, steps_per_epoch)


def _sana_encode_fns(setup):
    from onetrainer_tpu_torch.setup.sana_setup import make_sana_encode_fns
    return make_sana_encode_fns(setup)


def _sana_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.sana_sampler import sample_sana
    transformer, te, extra = setup.merged_inference_params()
    return sample_sana(setup.model, transformer, te, setup.model.vae, setup.tokenizer,
                       sample_config, extra_embeddings=extra, on_update_progress=on_progress)


def _sana_save_model(setup, out_dir, source_dir, save_dtype=None, ema=True):
    """The transformer, DC-AE and Gemma-2 (the reference's writes no DC-AE
    weights: ROADMAP F22)."""
    from onetrainer_tpu_torch.io.sana_checkpoints import save_sana_diffusers
    sd = merged_state_dicts(setup, ema, save_dtype)
    save_sana_diffusers(out_dir, setup.model, sd["transformer"], sd["vae"],
                        sd["text_encoder"], save_dtype=save_dtype or torch.float32,
                        source_dir=source_dir)


def _sana_save_single_file(setup, path, save_dtype=None, ema=True):
    raise NotImplementedError(
        "Sana single-file export not implemented; use DIFFUSERS format")


# -- Würstchen v2 / Stable Cascade ---------------------------------------------------

def _wuerstchen_load(base_dir, config, device: torch.device | str = "cuda"):
    """A prior directory (or a Stable Cascade stage_c file), the effnet file
    `effnet_encoder.model_name` and, for sampling, the decoder directory
    `decoder.model_name`; the effnet and the text encoder may be missing."""
    from onetrainer_tpu_torch.io.single_file import load_cascade_single_file
    from onetrainer_tpu_torch.io.wuerstchen_checkpoints import (
        load_wuerstchen_decoder, load_wuerstchen_diffusers,
    )
    from onetrainer_tpu_torch.models.wuerstchen_model import WuerstchenModel, attach_decoder
    kwargs = dict(_load_kwargs(config, device, "prior"),
                  effnet_path=config.effnet_encoder.model_name or None)
    if os.path.isfile(base_dir) and config.model_type.is_stable_cascade():
        loaded = load_cascade_single_file(base_dir, **kwargs)
    else:
        loaded = load_wuerstchen_diffusers(base_dir, **kwargs)
    model = WuerstchenModel(
        model_type=config.model_type,
        prior_config=loaded["prior_config"],
        effnet_config=loaded["effnet_config"],
        te_config=loaded["te_config"],
        device="meta",
        text_encoder_layer_skip=config.text_encoder_layer_skip or 0,
        tokenizer=loaded["tokenizer_dir"],
    )
    _assign(model, loaded, device, optional=("effnet", "text_encoder"))
    decoder_dir = getattr(config.decoder, "model_name", None)
    if decoder_dir and os.path.isdir(decoder_dir):
        attach_decoder(model, load_wuerstchen_decoder(
            decoder_dir, compute_dtype=kwargs["compute_dtype"], device=device))
    return model


def _wuerstchen_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.wuerstchen_setup import create_wuerstchen_setup
    return create_wuerstchen_setup(model, config, total_steps, steps_per_epoch)


def _wuerstchen_encode_fns(setup):
    from onetrainer_tpu_torch.setup.wuerstchen_setup import make_wuerstchen_encode_fns
    return make_wuerstchen_encode_fns(setup)


def _wuerstchen_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.wuerstchen_sampler import sample_wuerstchen
    prior, te, extra = setup.merged_inference_params()
    return sample_wuerstchen(setup.model, prior, te, setup.tokenizer, sample_config,
                             extra_embeddings=extra, on_update_progress=on_progress)


def _wuerstchen_save_model(setup, out_dir, source_dir, save_dtype=None, ema=True):
    from onetrainer_tpu_torch.io.wuerstchen_checkpoints import save_wuerstchen_diffusers
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_wuerstchen_diffusers(out_dir, setup.model, sd["prior"], sd["text_encoder"],
                              save_dtype=save_dtype or torch.float32, source_dir=source_dir)


def _wuerstchen_save_single_file(setup, path, save_dtype=None, ema=True):
    """Stable Cascade's stage_c file and the text encoder beside it
    (io/single_file.py:save_cascade_single_file); Würstchen v2 raises, as
    the reference's saver does."""
    if not setup.config.model_type.is_stable_cascade():
        raise NotImplementedError(
            "Würstchen v2 single-file export is unsupported (reference "
            "WuerstchenModelSaver.__save_safetensors raises for non-Cascade)")
    from onetrainer_tpu_torch.io.single_file import save_cascade_single_file
    sd = merged_state_dicts(setup, ema, save_dtype or torch.float32)
    save_cascade_single_file(path, sd["prior"], sd["text_encoder"],
                             save_dtype=save_dtype or torch.float32,
                             metadata=_modelspec(setup, prediction_type=False))


def get_family(model_type: ModelType) -> ModelFamily:
    if model_type.is_stable_diffusion():
        if model_type.has_depth_input():
            raise NotImplementedError(f"{model_type} (depth) is not ported to torch yet")
        from onetrainer_tpu_torch.setup.sd_setup import LORA_PREFIXES as sd_prefixes
        return ModelFamily(
            name="sd", quantization=8,
            load=_sd_load, create_setup=_sd_create_setup,
            make_encode_fns=_sd_encode_fns, sample=_sd_sample,
            save_model=_sd_save_model, save_single_file=_sd_save_single_file,
            lora_prefixes=sd_prefixes,
        )
    if model_type.is_stable_diffusion_xl():
        from onetrainer_tpu_torch.setup.sdxl_setup import LORA_PREFIXES as sdxl_prefixes
        return ModelFamily(
            name="sdxl", quantization=64,
            load=_sdxl_load, create_setup=_sdxl_create_setup,
            make_encode_fns=_sdxl_encode_fns, sample=_sdxl_sample,
            save_model=_sdxl_save_model, save_single_file=_sdxl_save_single_file,
            lora_prefixes=sdxl_prefixes,
        )
    if model_type.is_stable_diffusion_3():
        from onetrainer_tpu_torch.setup.sd3_setup import LORA_PREFIXES as sd3_prefixes
        return ModelFamily(
            name="sd3", quantization=64,
            load=_sd3_load, create_setup=_sd3_create_setup,
            make_encode_fns=_sd3_encode_fns, sample=_sd3_sample,
            save_model=_sd3_save_model, save_single_file=_sd3_save_single_file,
            lora_prefixes=sd3_prefixes,
        )
    if model_type.is_flux():
        from onetrainer_tpu_torch.setup.flux_setup import LORA_PREFIXES as flux_prefixes
        return ModelFamily(
            name="flux", quantization=64,
            load=_flux_load, create_setup=_flux_create_setup,
            make_encode_fns=_flux_encode_fns, sample=_flux_sample,
            save_model=_flux_save_model, save_single_file=_flux_save_single_file,
            lora_prefixes=flux_prefixes,
        )
    if model_type.is_hunyuan_video():
        from onetrainer_tpu_torch.setup.hunyuan_setup import LORA_PREFIXES as hunyuan_prefixes
        return ModelFamily(
            name="hunyuan", quantization=32,
            load=_hunyuan_load, create_setup=_hunyuan_create_setup,
            make_encode_fns=_hunyuan_encode_fns, sample=_hunyuan_sample,
            save_model=_hunyuan_save_model, save_single_file=_hunyuan_save_single_file,
            lora_prefixes=hunyuan_prefixes,
            video=True,
        )
    if model_type.is_pixart():
        from onetrainer_tpu_torch.setup.pixart_setup import LORA_PREFIXES as pixart_prefixes
        return ModelFamily(
            name="pixart", quantization=8,
            load=_pixart_load, create_setup=_pixart_create_setup,
            make_encode_fns=_pixart_encode_fns, sample=_pixart_sample,
            save_model=_pixart_save_model, save_single_file=_pixart_save_single_file,
            lora_prefixes=pixart_prefixes,
        )
    if model_type.is_sana():
        from onetrainer_tpu_torch.setup.sana_setup import LORA_PREFIXES as sana_prefixes
        return ModelFamily(
            name="sana", quantization=32,
            load=_sana_load, create_setup=_sana_create_setup,
            make_encode_fns=_sana_encode_fns, sample=_sana_sample,
            save_model=_sana_save_model, save_single_file=_sana_save_single_file,
            lora_prefixes=sana_prefixes,
        )
    if model_type.is_wuerstchen():
        from onetrainer_tpu_torch.setup.wuerstchen_setup import (
            LORA_PREFIXES as wuerstchen_prefixes,
        )
        return ModelFamily(
            name="wuerstchen", quantization=128,
            load=_wuerstchen_load, create_setup=_wuerstchen_create_setup,
            make_encode_fns=_wuerstchen_encode_fns, sample=_wuerstchen_sample,
            save_model=_wuerstchen_save_model,
            save_single_file=_wuerstchen_save_single_file,
            lora_prefixes=wuerstchen_prefixes,
        )
    raise NotImplementedError(
        f"model family {model_type} is not ported to torch yet")


def cast_float_tensor(t: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """`t` in `dtype` when it is a float tensor (fp8 and bf16 included);
    integers, and every tensor when `dtype` is None, pass through: the
    reference's DtypeModelSaverMixin._convert_state_dict_dtype."""
    if dtype is None or not t.is_floating_point():
        return t
    return t.to(dtype)


def save_lora_output(setup, destination: str, lora_prefixes: dict,
                     save_dtype: torch.dtype | None = None) -> str:
    """kohya-format LoRA safetensors across all adapter groups (the EMA's
    when the train state holds one), with trained additional embeddings
    bundled as `bundle_emb.<placeholder>.emp_params`, every float tensor cast to
    `save_dtype` (the configured output_dtype), with modelspec metadata
    (reference: StableDiffusionLoRASaver.py:33-41, LoRASaverMixin.save).
    -> the path written."""
    tensors = {}
    state = setup.state
    params = state.params if state.ema is None else state.ema.params
    for key, prefix in lora_prefixes.items():
        if key in params:
            tensors.update(peft_to_kohya_state_dict(params[key], setup.peft_cfg, prefix))
    if "embeddings" in params and setup.config.bundle_additional_embeddings:
        # trained additional embeddings bundled beside the adapters (the
        # first text encoder's vectors, as the reference's families.py:1194-1203)
        for e in setup.config.all_embedding_configs():
            span = setup.embedding_ids.get(e.uuid)
            if span is not None:
                start, count = span
                tensors[f"bundle_emb.{e.placeholder}.emp_params"] = \
                    params["embeddings"][start:start + count]
    tensors = {k: cast_float_tensor(v, save_dtype).detach().cpu() for k, v in tensors.items()}
    if not destination.endswith(".safetensors"):
        destination += ".safetensors"
    from onetrainer_tpu_torch.util.model_spec import make_modelspec_metadata
    meta = make_modelspec_metadata(
        setup.config.model_type, setup.config.training_method,
        resolution=setup.config.resolution, train_config=setup.config,
        tensors=tensors)
    save_safetensors(destination, tensors, metadata={"format": "pt", **meta})
    return destination


# trained embedding group -> its file key in a family of several text
# encoders without keys of its own (SDXL, SD3; the reference's
# trainer/generic_trainer.py:396-405)
MULTI_ENCODER_EMBEDDING_KEYS = {
    "embeddings": "clip_l", "embeddings_2": "clip_g", "embeddings_3": "t5",
    "output_embeddings": "clip_l_out", "output_embeddings_2": "clip_g_out",
    "output_embeddings_3": "t5_out"}


def embedding_file_keys(setup) -> dict:
    """{trained embedding group: its key in the EMBEDDING output file}: the
    family's keys (`setup.embedding_save_keys`: FLUX's clip_l/t5/t5_out,
    HunyuanVideo's llama/clip_l/llama_out), `MULTI_ENCODER_EMBEDDING_KEYS`
    for SDXL and SD3, else `emp_params` and `output_emp_params` (the
    reference's trainer/generic_trainer.py:389-420)."""
    params = setup.state.params
    keys = getattr(setup, "embedding_save_keys", None)
    if keys is None and any(k.endswith(("_2", "_3")) for k in params):
        keys = MULTI_ENCODER_EMBEDDING_KEYS
    if keys is None:
        keys = {"embeddings": "emp_params", "output_embeddings": "output_emp_params"}
    return {group: name for group, name in keys.items() if group in params}


def save_embedding_output(setup, destination: str,
                          save_dtype: torch.dtype | None = None) -> str:
    """The EMBEDDING output under `embedding_file_keys` (the EMA's vectors
    when the train state holds one), every tensor cast to `save_dtype`.
    -> the path written."""
    state = setup.state
    params = state.params if state.ema is None else state.ema.params
    tensors = {name: cast_float_tensor(params[group], save_dtype).detach().cpu()
               for group, name in embedding_file_keys(setup).items()}
    if not destination.endswith(".safetensors"):
        destination += ".safetensors"
    save_safetensors(destination, tensors, metadata={"format": "pt"})
    return destination
