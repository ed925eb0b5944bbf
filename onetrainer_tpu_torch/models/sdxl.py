"""StableDiffusionXL model aggregate: UNet + VAE + dual text encoders
(CLIP ViT-L hidden states + OpenCLIP bigG hidden states and pooled).

Counterpart of onetrainer_tpu/models/sdxl.py. Where the reference holds
configs plus param trees, this holds configs plus `nn.Module`s. Modules
left unset are built on `device`; build on "meta" and materialise with
`io.weights.init_sdxl_weights` to skip a throwaway default init at full
width.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.math.schedules import (
    DiffusionScheduleCoefficients, make_betas, rescale_betas_zero_terminal_snr,
)
from onetrainer_tpu_torch.models.clip import (
    CLIPTextConfig, CLIPTextModel, clip_vit_l_config, open_clip_vit_bigg_config,
)
from onetrainer_tpu_torch.models.unet import (
    UNet2DCondition, UNetConfig, sdxl_inpaint_unet_config, sdxl_unet_config,
)
from onetrainer_tpu_torch.models.vae import AutoencoderKL, VAEConfig, sdxl_vae_config
from onetrainer_tpu_torch.util.enums import ModelType


@dataclass
class StableDiffusionXLModel:
    model_type: ModelType
    unet_config: UNetConfig
    vae_config: VAEConfig
    te_config: CLIPTextConfig       # text_encoder_1 (CLIP ViT-L)
    te2_config: CLIPTextConfig      # text_encoder_2 (OpenCLIP bigG, projected)

    unet: UNet2DCondition | None = None
    vae: AutoencoderKL | None = None
    text_encoder: CLIPTextModel | None = None
    text_encoder_2: CLIPTextModel | None = None
    device: torch.device | str = "cpu"

    betas: torch.Tensor | None = None
    prediction_type: str = "epsilon"
    text_encoder_layer_skip: int = 1   # SDXL reads the penultimate layer
    tokenizer: object | None = None
    tokenizer_2: object | None = None

    def __post_init__(self):
        if self.betas is None:
            self.betas = make_betas("scaled_linear", 0.00085, 0.012, 1000)
        with torch.device(self.device):
            if self.unet is None:
                self.unet = UNet2DCondition(self.unet_config)
            if self.vae is None:
                self.vae = AutoencoderKL(self.vae_config)
            if self.text_encoder is None:
                self.text_encoder = CLIPTextModel(self.te_config)
            if self.text_encoder_2 is None:
                self.text_encoder_2 = CLIPTextModel(self.te2_config)

    def modules(self) -> dict[str, torch.nn.Module]:
        return {"unet": self.unet, "text_encoder": self.text_encoder,
                "text_encoder_2": self.text_encoder_2, "vae": self.vae}

    def coefficients(self) -> DiffusionScheduleCoefficients:
        return DiffusionScheduleCoefficients.from_betas(self.betas)

    def rescale_noise_scheduler_to_zero_terminal_snr(self):
        self.betas = rescale_betas_zero_terminal_snr(self.betas)

    def force_v_prediction(self):
        self.prediction_type = "v_prediction"

    def force_epsilon_prediction(self):
        self.prediction_type = "epsilon"


def create_sdxl_model(model_type: ModelType, dtype: torch.dtype = torch.bfloat16,
                      device: torch.device | str = "cpu") -> StableDiffusionXLModel:
    """SDXL at its published widths (diffusers sdxl-base-1.0 configs)."""
    if model_type == ModelType.STABLE_DIFFUSION_XL_10_BASE_INPAINTING:
        unet_cfg = sdxl_inpaint_unet_config(dtype=dtype)
    else:
        unet_cfg = sdxl_unet_config(dtype=dtype)
    return StableDiffusionXLModel(
        model_type=model_type,
        unet_config=unet_cfg,
        vae_config=sdxl_vae_config(dtype=dtype),
        te_config=clip_vit_l_config(dtype=dtype),
        te2_config=open_clip_vit_bigg_config(dtype=dtype),
        device=device,
    )
