"""StableDiffusion 1.5 / 2.x model aggregate: UNet + VAE + one CLIP text
encoder (CLIP ViT-L for SD 1.5, OpenCLIP ViT-H for SD 2.x).

Counterpart of onetrainer_tpu/models/sd.py. Where the reference holds
configs plus param trees, this holds configs plus `nn.Module`s. Modules
left unset are built on `device`; build on "meta" and materialise with
`io.weights.init_sd_weights` to skip a throwaway default init at full
width. The inpainting types take 9 input channels (the noisy latent, the
mask and the conditioning image's latent); the depth type (5) is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.math.schedules import (
    DiffusionScheduleCoefficients, make_betas, rescale_betas_zero_terminal_snr,
)
from onetrainer_tpu_torch.models.clip import (
    CLIPTextConfig, CLIPTextModel, clip_vit_l_config, open_clip_vit_h_config,
)
from onetrainer_tpu_torch.models.unet import (
    UNet2DCondition, UNetConfig, sd15_inpaint_unet_config, sd15_unet_config,
    sd21_inpaint_unet_config, sd21_unet_config,
)
from onetrainer_tpu_torch.models.vae import AutoencoderKL, VAEConfig, sd15_vae_config
from onetrainer_tpu_torch.util.enums import ModelType


@dataclass
class StableDiffusionModel:
    model_type: ModelType
    unet_config: UNetConfig
    vae_config: VAEConfig
    te_config: CLIPTextConfig

    unet: UNet2DCondition | None = None
    vae: AutoencoderKL | None = None
    text_encoder: CLIPTextModel | None = None
    device: torch.device | str = "cuda"

    betas: torch.Tensor | None = None
    prediction_type: str = "epsilon"        # or "v_prediction"
    text_encoder_layer_skip: int = 0
    tokenizer: object | None = None

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

    def modules(self) -> dict[str, torch.nn.Module]:
        return {"unet": self.unet, "text_encoder": self.text_encoder, "vae": self.vae}

    def coefficients(self) -> DiffusionScheduleCoefficients:
        return DiffusionScheduleCoefficients.from_betas(self.betas)

    def rescale_noise_scheduler_to_zero_terminal_snr(self):
        self.betas = rescale_betas_zero_terminal_snr(self.betas)

    def force_v_prediction(self):
        self.prediction_type = "v_prediction"

    def force_epsilon_prediction(self):
        self.prediction_type = "epsilon"


def create_sd_model(model_type: ModelType, dtype: torch.dtype = torch.bfloat16,
                    gradient_checkpointing: bool = False,
                    remat_policy: str | None = None,
                    device: torch.device | str = "cuda",
                    unet_weight_dtype: torch.dtype = torch.float32,
                    ) -> StableDiffusionModel:
    """SD 1.5 (CLIP ViT-L, conv projections, 8 heads) or SD 2.0/2.1 and
    their -base variants (OpenCLIP ViT-H read at its penultimate layer,
    linear projections, 5/10/20/20 heads), and SD 1.5 and SD 2.0
    inpainting (9 input channels), at their published widths, built
    on `device` (the card unless the caller passes another). The
    prediction type starts at epsilon, as the reference's; a 768-v
    checkpoint's v-prediction comes from its loader or from the training
    config's `force_v_prediction`. The UNet's parameters are held in
    `unet_weight_dtype` (a training config's
    `weight_dtypes().unet.to_load_dtype()`)."""
    if not model_type.is_stable_diffusion():
        raise ValueError(f"not an SD 1/2 model type: {model_type}")
    if model_type.has_depth_input():
        raise NotImplementedError(f"{model_type} (the depth UNet) is not ported yet")
    common = dict(dtype=dtype, gradient_checkpointing=gradient_checkpointing,
                  remat_policy=remat_policy or "tx_only")
    inpainting = model_type.has_mask_input()
    if model_type.is_sd_v2():
        unet_cfg = (sd21_inpaint_unet_config if inpainting else sd21_unet_config)(**common)
        te_cfg = open_clip_vit_h_config(dtype=dtype)
        layer_skip = 1   # SD 2.x reads the penultimate hidden state
    else:
        unet_cfg = (sd15_inpaint_unet_config if inpainting else sd15_unet_config)(**common)
        te_cfg = clip_vit_l_config(dtype=dtype)
        layer_skip = 0
    model = StableDiffusionModel(
        model_type=model_type,
        unet_config=unet_cfg,
        vae_config=sd15_vae_config(dtype=dtype),
        te_config=te_cfg,
        text_encoder_layer_skip=layer_skip,
        device=device,
    )
    model.unet.to(unet_weight_dtype)
    return model
