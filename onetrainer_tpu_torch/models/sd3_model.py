"""SD3/3.5 model aggregate: MMDiT + 16-channel VAE + CLIP-L and CLIP-G (both
projected) + T5-XXL.

Counterpart of onetrainer_tpu/models/sd3_model.py. Where the reference
holds configs plus param trees, this holds configs plus `nn.Module`s.
Modules left unset are built on `device`; build on "meta" and materialise
with `io.weights.init_sd3_weights` to skip a throwaway default init at
full width.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.models.clip import (
    CLIPTextConfig, CLIPTextModel, clip_vit_l_config, open_clip_vit_bigg_config,
)
from onetrainer_tpu_torch.models.sd3 import (
    SD3Config, SD3Transformer2D, sd3_medium_config, sd35_medium_config,
)
from onetrainer_tpu_torch.models.t5 import T5Config, T5Encoder, t5_xxl_config
from onetrainer_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from onetrainer_tpu_torch.util.enums import ModelType


def sd3_vae_config(dtype: torch.dtype = torch.bfloat16) -> VAEConfig:
    return VAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609,
                     dtype=dtype)


@dataclass
class StableDiffusion3Model:
    model_type: ModelType
    transformer_config: SD3Config
    vae_config: VAEConfig
    te_config: CLIPTextConfig     # clip_l (projection)
    te2_config: CLIPTextConfig    # clip_g (projection)
    te3_config: T5Config          # t5-xxl

    transformer: SD3Transformer2D | None = None
    vae: AutoencoderKL | None = None
    text_encoder: CLIPTextModel | None = None
    text_encoder_2: CLIPTextModel | None = None
    text_encoder_3: T5Encoder | None = None
    device: torch.device | str = "cuda"

    prediction_type: str = "flow"
    tokenizer: object | None = None
    tokenizer_2: object | None = None
    tokenizer_3: object | None = None

    def __post_init__(self):
        with torch.device(self.device):
            if self.transformer is None:
                self.transformer = SD3Transformer2D(self.transformer_config)
            if self.vae is None:
                self.vae = AutoencoderKL(self.vae_config)
            if self.text_encoder is None:
                self.text_encoder = CLIPTextModel(self.te_config)
            if self.text_encoder_2 is None:
                self.text_encoder_2 = CLIPTextModel(self.te2_config)
            if self.text_encoder_3 is None:
                self.text_encoder_3 = T5Encoder(self.te3_config)

    def modules(self) -> dict[str, torch.nn.Module]:
        """The model's parts by attribute, the denoiser first."""
        return {"transformer": self.transformer, "text_encoder": self.text_encoder,
                "text_encoder_2": self.text_encoder_2,
                "text_encoder_3": self.text_encoder_3, "vae": self.vae}


def create_sd3_model(model_type: ModelType, dtype: torch.dtype = torch.bfloat16,
                     gradient_checkpointing: bool = False,
                     remat_policy: str | None = None,
                     device: torch.device | str = "cuda") -> StableDiffusion3Model:
    """SD3-medium (or SD3.5-medium's transformer config) at its published
    widths, built on `device` (the card unless the caller passes another).
    The remat policy defaults to "full", as the reference's create_sd3_model;
    its loaders pass models/remat.py:SD3_POLICY."""
    tcfg = (sd35_medium_config if model_type == ModelType.STABLE_DIFFUSION_35
            else sd3_medium_config)(
        dtype=dtype, gradient_checkpointing=gradient_checkpointing,
        remat_policy=remat_policy or "full")
    return StableDiffusion3Model(
        model_type=model_type,
        transformer_config=tcfg,
        vae_config=sd3_vae_config(dtype),
        # SD3's CLIP-L also projects (projection_dim 768)
        te_config=clip_vit_l_config(dtype=dtype, projection_dim=768),
        te2_config=open_clip_vit_bigg_config(dtype=dtype),
        te3_config=t5_xxl_config(dtype=dtype),
        device=device,
    )
