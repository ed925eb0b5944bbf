"""PixArt α/Σ model aggregate: the DiT, the SD-shaped VAE and T5.

Counterpart of onetrainer_tpu/models/pixart_model.py (reference:
modules/model/PixArtAlphaModel.py). Where the reference holds configs plus
param trees, this holds configs plus `nn.Module`s. Modules left unset are
built on `device`; build on "meta" and materialise with
`io.weights.init_pixart_weights` to skip a throwaway default init at full
width. The noise schedule is the reference's: 1000 scaled-linear betas
from 1e-4 to 0.02.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.math.schedules import DiffusionScheduleCoefficients, make_betas
from onetrainer_tpu_torch.models.pixart import (
    PixArtConfig, PixArtTransformer2D, pixart_alpha_config, pixart_sigma_config,
)
from onetrainer_tpu_torch.models.t5 import T5Config, T5Encoder, t5_xxl_config
from onetrainer_tpu_torch.models.vae import AutoencoderKL, VAEConfig, sd15_vae_config
from onetrainer_tpu_torch.util.enums import ModelType


@dataclass
class PixArtAlphaModel:
    model_type: ModelType
    transformer_config: PixArtConfig
    vae_config: VAEConfig
    te_config: T5Config

    transformer: PixArtTransformer2D | None = None
    vae: AutoencoderKL | None = None
    text_encoder: T5Encoder | None = None
    device: torch.device | str = "cuda"

    betas: torch.Tensor | None = None
    prediction_type: str = "epsilon"
    tokenizer: object | None = None      # T5 tokenizer

    def __post_init__(self):
        if self.betas is None:
            self.betas = make_betas("scaled_linear", 0.0001, 0.02, 1000)
        with torch.device(self.device):
            if self.transformer is None:
                self.transformer = PixArtTransformer2D(self.transformer_config)
            if self.vae is None:
                self.vae = AutoencoderKL(self.vae_config)
            if self.text_encoder is None:
                self.text_encoder = T5Encoder(self.te_config)

    def modules(self) -> dict[str, torch.nn.Module]:
        """The model's parts by attribute, the denoiser first."""
        return {"transformer": self.transformer, "text_encoder": self.text_encoder,
                "vae": self.vae}

    def coefficients(self) -> DiffusionScheduleCoefficients:
        return DiffusionScheduleCoefficients.from_betas(self.betas)


def create_pixart_model(model_type: ModelType, dtype: torch.dtype = torch.bfloat16,
                        gradient_checkpointing: bool = False,
                        device: torch.device | str = "cuda") -> PixArtAlphaModel:
    """PixArt-α (PIXART_ALPHA) or PixArt-Σ (PIXART_SIGMA) at the
    reference's default widths (XL-2: 28 blocks of 16 d=72 heads; T5-XXL;
    the SD VAE), built on `device` (the card unless the caller passes
    another)."""
    config = pixart_sigma_config if model_type == ModelType.PIXART_SIGMA \
        else pixart_alpha_config
    return PixArtAlphaModel(
        model_type=model_type,
        transformer_config=config(dtype=dtype, gradient_checkpointing=gradient_checkpointing),
        vae_config=sd15_vae_config(dtype=dtype),
        te_config=t5_xxl_config(dtype=dtype),
        device=device,
    )
