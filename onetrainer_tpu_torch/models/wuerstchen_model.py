"""Würstchen v2 / Stable Cascade model aggregate.

Counterpart of onetrainer_tpu/models/wuerstchen_model.py (reference:
modules/model/WuerstchenModel.py): the prior (Würstchen v2's
`WuerstchenPrior`, or Stable Cascade's stage C for a `CascadePriorConfig`),
the EfficientNet encoder of the latent cache and the prior's CLIP text
encoder; for sampling, the decoder stage (DiffNeXt, the Paella VQGAN and
the decoder's CLIP text encoder), set by `attach_decoder`. Where the
reference holds configs plus param trees, this holds configs plus
`nn.Module`s, built on `device` when left unset (on "meta" to skip a
throwaway init at full width). Effnet latents are the image at 0.75 / 32
of its size (`vae_config.spatial_scale` 128 / 3 for the data loader).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.models.cascade import CascadePriorConfig, StableCascadePrior
from onetrainer_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from onetrainer_tpu_torch.models.wuerstchen import (
    EffnetConfig, WuerstchenEffnetEncoder, WuerstchenPrior, WuerstchenPriorConfig,
)
from onetrainer_tpu_torch.util.enums import ModelType


@dataclass(frozen=True)
class EffnetLatentScale:
    """The data loader's view of the effnet latents: image / (128 / 3)."""
    spatial_scale: float = 128.0 / 3.0
    scaling_factor: float = 1.0


@dataclass
class WuerstchenModel:
    model_type: ModelType
    prior_config: WuerstchenPriorConfig | CascadePriorConfig
    effnet_config: EffnetConfig
    te_config: CLIPTextConfig

    prior: torch.nn.Module | None = None
    effnet: WuerstchenEffnetEncoder | None = None
    text_encoder: CLIPTextModel | None = None
    device: torch.device | str = "cuda"

    # the decoder stage (sampling only)
    decoder_config: object | None = None       # models/diffnext.py:DiffNeXtConfig
    vqgan_config: object | None = None         # models/paella_vq.py:PaellaVQConfig
    decoder_te_config: CLIPTextConfig | None = None
    decoder: torch.nn.Module | None = None
    vqgan: torch.nn.Module | None = None
    decoder_text_encoder: CLIPTextModel | None = None
    decoder_tokenizer: object | None = None

    prediction_type: str = "epsilon"
    text_encoder_layer_skip: int = 0
    tokenizer: object | None = None
    vae_config: EffnetLatentScale = EffnetLatentScale()

    def __post_init__(self):
        with torch.device(self.device):
            if self.prior is None:
                self.prior = StableCascadePrior(self.prior_config) \
                    if isinstance(self.prior_config, CascadePriorConfig) \
                    else WuerstchenPrior(self.prior_config)
            if self.effnet is None:
                self.effnet = WuerstchenEffnetEncoder(self.effnet_config)
            if self.text_encoder is None:
                self.text_encoder = CLIPTextModel(self.te_config)

    def modules(self) -> dict[str, torch.nn.Module]:
        """The model's trained-side parts by attribute, the denoiser first
        (the decoder stage is not among them: nothing saves or trains it)."""
        return {"prior": self.prior, "text_encoder": self.text_encoder, "effnet": self.effnet}


def attach_decoder(model: WuerstchenModel, loaded: dict) -> None:
    """Give `model` the decoder stage from `io/wuerstchen_checkpoints.py:
    load_wuerstchen_decoder`'s dict: DiffNeXt, the Paella VQGAN and the
    decoder's CLIP text encoder (None when the directory has none). As in
    the reference, the prompt reaches the decoder's text encoder through
    the prior's tokenizer unless the caller sets `decoder_tokenizer`."""
    from onetrainer_tpu_torch.io.sd_checkpoints import assign_state_dict
    from onetrainer_tpu_torch.models.diffnext import WuerstchenDiffNeXt
    from onetrainer_tpu_torch.models.paella_vq import PaellaVQDecoder
    model.decoder_config = loaded["decoder_config"]
    model.vqgan_config = loaded["vqgan_config"]
    model.decoder_te_config = loaded["decoder_te_config"]
    with torch.device("meta"):
        model.decoder = WuerstchenDiffNeXt(model.decoder_config)
        model.vqgan = PaellaVQDecoder(model.vqgan_config)
        model.decoder_text_encoder = CLIPTextModel(model.decoder_te_config) \
            if loaded["decoder_text_encoder"] is not None else None
    assign_state_dict(model.decoder, loaded["decoder"])
    assign_state_dict(model.vqgan, loaded["vqgan"])
    if model.decoder_text_encoder is not None:
        assign_state_dict(model.decoder_text_encoder, loaded["decoder_text_encoder"])


def clip_h_text_config(**overrides) -> CLIPTextConfig:
    """The Würstchen v2 prior's text encoder (CLIP-H/14's text tower, 24 layers)."""
    kwargs = dict(hidden_size=1024, intermediate_size=4096, num_layers=24,
                  num_heads=16, hidden_act="gelu")
    kwargs.update(overrides)
    return CLIPTextConfig(**kwargs)


def create_wuerstchen_model(model_type: ModelType, dtype: torch.dtype = torch.bfloat16,
                            gradient_checkpointing: bool = False,
                            device: torch.device | str = "cuda") -> WuerstchenModel:
    """The reference's defaults (for either model type, as its
    create_wuerstchen_model): the Würstchen v2 prior config,
    EfficientNetV2-S and CLIP-H's text encoder, built on `device` (the card
    unless the caller passes another). A checkpoint's own configs come
    through io/wuerstchen_checkpoints.py."""
    return WuerstchenModel(
        model_type=model_type,
        prior_config=WuerstchenPriorConfig(dtype=dtype,
                                           gradient_checkpointing=gradient_checkpointing),
        effnet_config=EffnetConfig(dtype=dtype),
        te_config=clip_h_text_config(dtype=dtype),
        device=device,
    )
