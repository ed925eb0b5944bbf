"""FLUX.1 model aggregate: the rectified-flow DiT, the 16-channel VAE,
CLIP-L (pooled output only) and T5-XXL (sequence states).

Counterpart of onetrainer_tpu/models/flux_model.py. Where the reference
holds configs plus param trees, this holds configs plus `nn.Module`s.
Modules left unset are built on `device`; build on "meta" and materialise
with `io.weights.init_flux_weights` to skip a throwaway default init at
full width (cast the transformer to bf16 on "meta" first: its fp32
parameters alone are 47.6 GB). FLUX.1-fill differs from FLUX.1-dev only in
the transformer's input width (`flux_fill_config`: 384 packed channels).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, clip_vit_l_config
from onetrainer_tpu_torch.models.flux import (
    FluxConfig, FluxTransformer2D, flux_dev_config, flux_fill_config,
)
from onetrainer_tpu_torch.models.t5 import T5Config, T5Encoder, t5_xxl_config
from onetrainer_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from onetrainer_tpu_torch.util.enums import ModelType


def flux_vae_config(dtype: torch.dtype = torch.bfloat16) -> VAEConfig:
    return VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                     dtype=dtype)


@dataclass
class FluxModel:
    model_type: ModelType
    transformer_config: FluxConfig
    vae_config: VAEConfig
    te_config: CLIPTextConfig     # CLIP-L: pooled output only
    te2_config: T5Config          # T5-XXL: sequence states

    transformer: FluxTransformer2D | None = None
    vae: AutoencoderKL | None = None
    text_encoder: CLIPTextModel | None = None
    text_encoder_2: T5Encoder | None = None
    device: torch.device | str = "cuda"

    prediction_type: str = "flow"
    tokenizer: object | None = None      # CLIP tokenizer
    tokenizer_2: object | None = None    # T5 tokenizer

    def __post_init__(self):
        with torch.device(self.device):
            if self.transformer is None:
                self.transformer = FluxTransformer2D(self.transformer_config)
            if self.vae is None:
                self.vae = AutoencoderKL(self.vae_config)
            if self.text_encoder is None:
                self.text_encoder = CLIPTextModel(self.te_config)
            if self.text_encoder_2 is None:
                self.text_encoder_2 = T5Encoder(self.te2_config)

    def modules(self) -> dict[str, torch.nn.Module]:
        """The model's parts by attribute, the denoiser first."""
        return {"transformer": self.transformer, "text_encoder": self.text_encoder,
                "text_encoder_2": self.text_encoder_2, "vae": self.vae}


def create_flux_model(model_type: ModelType, dtype: torch.dtype = torch.bfloat16,
                      gradient_checkpointing: bool = False,
                      remat_policy: str | None = None,
                      device: torch.device | str = "cuda") -> FluxModel:
    """FLUX.1-dev, or FLUX.1-fill for FLUX_FILL_DEV_1, at its published
    widths, built on `device` (the card unless the caller passes another).
    The remat policy defaults to "full", the reference's FLUX default
    (models/remat.py:FLUX_POLICY)."""
    config = flux_fill_config if model_type == ModelType.FLUX_FILL_DEV_1 else flux_dev_config
    return FluxModel(
        model_type=model_type,
        transformer_config=config(
            dtype=dtype, gradient_checkpointing=gradient_checkpointing,
            remat_policy=remat_policy or "full"),
        vae_config=flux_vae_config(dtype),
        te_config=clip_vit_l_config(dtype=dtype),
        te2_config=t5_xxl_config(dtype=dtype),
        device=device,
    )
