"""HunyuanVideo model aggregate: the 3D DiT, the causal video VAE, Llama
(text encoder 1: sequence states) and CLIP-L (text encoder 2: pooled).

Counterpart of onetrainer_tpu/models/hunyuan_video_model.py. Where the
reference holds configs plus param trees, this holds configs plus
`nn.Module`s. Modules left unset are built on `device`; build on "meta"
and materialise with `io.weights.init_hunyuan_weights` to skip a throwaway
default init at full width (cast the transformer to bf16 on "meta" first:
its fp32 parameters alone are 51 GB).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, clip_vit_l_config
from onetrainer_tpu_torch.models.hunyuan_video import (
    HunyuanVideoConfig, HunyuanVideoTransformer3D,
)
from onetrainer_tpu_torch.models.llama import LlamaConfig, LlamaEncoder, llama3_8b_config
from onetrainer_tpu_torch.models.remat import HUNYUAN_POLICY
from onetrainer_tpu_torch.models.video_vae import AutoencoderKLVideo, VideoVAEConfig
from onetrainer_tpu_torch.util.enums import ModelType


@dataclass
class HunyuanVideoModel:
    model_type: ModelType
    transformer_config: HunyuanVideoConfig
    vae_config: VideoVAEConfig
    te_config: LlamaConfig          # text_encoder (Llama): sequence states
    te2_config: CLIPTextConfig      # text_encoder_2 (CLIP-L): pooled output only

    transformer: HunyuanVideoTransformer3D | None = None
    vae: AutoencoderKLVideo | None = None
    text_encoder: LlamaEncoder | None = None
    text_encoder_2: CLIPTextModel | None = None
    device: torch.device | str = "cuda"

    prediction_type: str = "flow"
    tokenizer: object | None = None      # Llama tokenizer
    tokenizer_2: object | None = None    # CLIP tokenizer

    def __post_init__(self):
        with torch.device(self.device):
            if self.transformer is None:
                self.transformer = HunyuanVideoTransformer3D(self.transformer_config)
            if self.vae is None:
                self.vae = AutoencoderKLVideo(self.vae_config)
            if self.text_encoder is None:
                self.text_encoder = LlamaEncoder(self.te_config)
            if self.text_encoder_2 is None:
                self.text_encoder_2 = CLIPTextModel(self.te2_config)

    def modules(self) -> dict[str, torch.nn.Module]:
        """The model's parts by attribute, the denoiser first."""
        return {"transformer": self.transformer, "text_encoder": self.text_encoder,
                "text_encoder_2": self.text_encoder_2, "vae": self.vae}


def create_hunyuan_video_model(model_type: ModelType, dtype: torch.dtype = torch.bfloat16,
                               gradient_checkpointing: bool = False,
                               device: torch.device | str = "cuda") -> HunyuanVideoModel:
    """HunyuanVideo at its published widths (the diffusers config; Llama-3-8B;
    CLIP-L with its 768 projection; the causal VAE), built on `device` (the
    card unless the caller passes another), with the reference's checkpoint
    policy "full"."""
    return HunyuanVideoModel(
        model_type=model_type,
        transformer_config=HunyuanVideoConfig(
            dtype=dtype, gradient_checkpointing=gradient_checkpointing,
            remat_policy=HUNYUAN_POLICY),
        vae_config=VideoVAEConfig(dtype=dtype),
        te_config=llama3_8b_config(dtype=dtype),
        te2_config=clip_vit_l_config(dtype=dtype, projection_dim=768),
        device=device,
    )
