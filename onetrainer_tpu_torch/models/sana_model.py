"""Sana model aggregate: the linear-attention DiT, DC-AE f32c32 and Gemma-2.

Counterpart of onetrainer_tpu/models/sana_model.py (reference:
modules/model/SanaModel.py). Where the reference holds configs plus param
trees, this holds configs plus `nn.Module`s. Modules left unset are built
on `device`; build on "meta" and materialise with
`io.weights.init_sana_weights` to skip a throwaway default init at full
width. Sana trains by flow matching (train/sana_train_step.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.models.dcae import AutoencoderDC, DCAEConfig
from onetrainer_tpu_torch.models.gemma import Gemma2Config, Gemma2Encoder
from onetrainer_tpu_torch.models.sana import SanaConfig, SanaTransformer2D
from onetrainer_tpu_torch.util.enums import ModelType


@dataclass
class SanaModel:
    model_type: ModelType
    transformer_config: SanaConfig
    vae_config: DCAEConfig
    te_config: Gemma2Config

    transformer: SanaTransformer2D | None = None
    vae: AutoencoderDC | None = None
    text_encoder: Gemma2Encoder | None = None
    device: torch.device | str = "cuda"

    prediction_type: str = "flow"
    tokenizer: object | None = None      # Gemma tokenizer

    def __post_init__(self):
        with torch.device(self.device):
            if self.transformer is None:
                self.transformer = SanaTransformer2D(self.transformer_config)
            if self.vae is None:
                self.vae = AutoencoderDC(self.vae_config)
            if self.text_encoder is None:
                self.text_encoder = Gemma2Encoder(self.te_config)

    def modules(self) -> dict[str, torch.nn.Module]:
        """The model's parts by attribute, the denoiser first."""
        return {"transformer": self.transformer, "text_encoder": self.text_encoder,
                "vae": self.vae}


def create_sana_model(model_type: ModelType, dtype: torch.dtype = torch.bfloat16,
                      gradient_checkpointing: bool = False,
                      device: torch.device | str = "cuda") -> SanaModel:
    """Sana 1600M at its published widths (20 blocks of 70 linear heads x 32
    and 20 cross heads x 112; Gemma-2-2B; DC-AE f32c32), built on `device`
    (the card unless the caller passes another)."""
    return SanaModel(
        model_type=model_type,
        transformer_config=SanaConfig(dtype=dtype, gradient_checkpointing=gradient_checkpointing),
        vae_config=DCAEConfig(dtype=dtype),
        te_config=Gemma2Config(dtype=dtype),
        device=device,
    )
