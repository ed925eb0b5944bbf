"""SDXL model setup.

Counterpart of onetrainer_tpu/setup/sdxl_setup.py: schedule flags,
tokenizer wrapping, the LoRA and FINE_TUNE training branches of
`create_sdxl_setup` (adapters, or the UNet's and each text encoder's own
parameters; per-group schedules, the clipped optimizer wrapped for
gradient accumulation, the train step, the EMA),
`merged_inference_params`, and `make_sdxl_encode_fns` for latent and
text-embedding caching. EMBEDDING trains a vector table per text encoder
(768 wide for CLIP-L, 1280 for CLIP-G; input and output embeddings), as
do additional embeddings beside LoRA and FINE_TUNE. Frozen parts whose
weight dtype is FLOAT_8, INT_8 or NFLOAT_4 are quantized after the
adapters and vectors exist (setup/quantize.py; QLoRA is LoRA over an NF4
UNet with bf16 adapters). A FINE_TUNE config that trains no part builds
no trainer (it serves sampling).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.models.sdxl import StableDiffusionXLModel
from onetrainer_tpu_torch.peft.lora import PeftConfig
from onetrainer_tpu_torch.setup.sd_setup import (
    EmbeddingEncoder, embedding_step_fields, image_encoder, inference_extra, prepare_model,
    refuse_unported, setup_embeddings, setup_training, trained_embeddings, wrap_tokenizer,
)
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, TrainedEmbeddings
from onetrainer_tpu_torch.train.sdxl_train_step import make_sdxl_train_step
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.util.enums import EMAMode

# frozen part -> its ModelWeightDtypes attribute
_QUANTIZABLE = {"unet": "unet", "text_encoder": "text_encoder",
                "text_encoder_2": "text_encoder_2"}
# trainable LoRA group -> (model attribute and config part, adapter key
# map, init seed)
_LORA_GROUPS = {
    "unet_lora": ("unet", None, 0),
    "te_lora": ("text_encoder", clip_torch_key_map, 1),
    "te2_lora": ("text_encoder_2", clip_torch_key_map, 2),
}
# the kohya prefix of each LoRA group (the reference's setup/sdxl_setup.py:186-191)
LORA_PREFIXES = {"unet_lora": "lora_unet", "te_lora": "lora_te1",
                 "te2_lora": "lora_te2"}
# FINE_TUNE groups: the model attributes (and config parts) that may train
_FINE_TUNE_GROUPS = ("unet", "text_encoder", "text_encoder_2")


@dataclass
class SDXLSetup:
    model: StableDiffusionXLModel
    config: object
    tokenizer: SDTokenizer
    tokenizer_2: SDTokenizer
    peft_cfg: PeftConfig | None = None
    step_cfg: SDStepConfig | None = None
    trainable: dict = field(default_factory=dict)
    tx: object = None
    train_step: object = None
    state: object = None
    group_schedules: dict = field(default_factory=dict)
    embeddings: TrainedEmbeddings | None = None
    embedding_ids: dict = field(default_factory=dict)   # uuid -> (start, count)

    def merged_inference_params(self):
        """(unet, text_encoder, text_encoder_2, (extra_1, extra_2)) for
        sampling: the model's own modules (under LoRA their layers carry
        the trained adapters and add the LoRA term in their forward, which
        equals sampling from merged weights without a merged copy of the
        base; peft.lora.merge_peft_into_base is for export) and each text
        encoder's trained embedding rows."""
        m, e = self.model, self.embeddings
        return (m.unet, m.text_encoder, m.text_encoder_2,
                (inference_extra(e, 0), inference_extra(e, 1)))


def create_sdxl_setup(model: StableDiffusionXLModel, config,
                      total_steps: int = 10_000,
                      steps_per_epoch: int = 100) -> SDXLSetup:
    """Bind `model` and `config`. For LoRA: adapters for the UNet and each
    trained text encoder (setup/sd_setup.py:setup_lora, groups seeded 0,
    1, 2 as the reference's PRNGKeys); for FINE_TUNE: the UNet and each
    text encoder, when it trains (setup/sd_setup.py:setup_fine_tune; the
    reference's sdxl_setup.py:167-184); for EMBEDDING: each text encoder's
    vectors alone (setup/sd_setup.py:setup_embeddings; the reference's
    sdxl_setup.py:131-166), which LoRA and FINE_TUNE train too when the
    config has additional embeddings; then the clipped optimizer, the
    train step and the train state (with an EMA when configured). A
    FINE_TUNE config that trains nothing builds no trainer (the setup
    serves sampling)."""
    refuse_unported(config)
    prepare_model(model, config)
    model.tokenizer = wrap_tokenizer(model.tokenizer, model.te_config)
    model.tokenizer_2 = wrap_tokenizer(model.tokenizer_2, model.te2_config)
    groups = setup_embeddings(
        config, [EmbeddingEncoder("", model.text_encoder, model.tokenizer),
                 EmbeddingEncoder("_2", model.text_encoder_2, model.tokenizer_2)],
        total_steps, steps_per_epoch)
    step_cfg = SDStepConfig.from_train_config(
        config, model.prediction_type, model.text_encoder_layer_skip)
    step_cfg = replace(
        step_cfg, vae_scaling_factor=model.vae_config.scaling_factor,
        **embedding_step_fields(groups, config.train_text_encoder_or_embedding()
                                or config.train_text_encoder_2_or_embedding()))
    setup = SDXLSetup(model=model, config=config, tokenizer=model.tokenizer,
                      tokenizer_2=model.tokenizer_2, step_cfg=step_cfg,
                      embedding_ids=groups.ids if groups else {})
    trains, rank_dropout = setup_training(
        setup, groups, _LORA_GROUPS, LORA_PREFIXES, _FINE_TUNE_GROUPS, _QUANTIZABLE,
        total_steps, steps_per_epoch)
    if not trains:
        return setup
    setup.embeddings = trained_embeddings(groups, setup.trainable, ("", "_2"), step_cfg)
    setup.train_step = make_sdxl_train_step(model, step_cfg, setup.tx, rank_dropout,
                                            setup.embeddings)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def make_sdxl_encode_fns(setup: SDXLSetup):
    """(encode_images, encode_text) for the data loader's caches:
    `encode_images(images NHWC in [-1, 1])` -> {"latent_image",
    "latent_logvar"}; `encode_text(prompt)` -> tokens, plus both text
    encoders' hidden states and TE2's pooled state when the text encoders
    are frozen (cached text embeddings). Tensors are fp32 on the model's
    device, tokens int32 numpy arrays."""
    model = setup.model
    device = next(model.vae.parameters()).device
    encode_images = image_encoder(model)

    if setup.step_cfg.train_text_encoder:
        def encode_text(prompt: str) -> dict:
            return {"tokens": setup.tokenizer(prompt),
                    "tokens_2": setup.tokenizer_2(prompt)}
        return encode_images, encode_text

    @torch.no_grad()
    def encode_text(prompt: str) -> dict:
        tokens = setup.tokenizer(prompt)
        tokens_2 = setup.tokenizer_2(prompt)
        out1 = model.text_encoder(torch.as_tensor(tokens[None], device=device))
        out2 = model.text_encoder_2(torch.as_tensor(tokens_2[None], device=device))
        return {
            "tokens": tokens, "tokens_2": tokens_2,
            "text_encoder_hidden_state": encode_clip_text(
                out1, setup.step_cfg.text_encoder_layer_skip)[0].float(),
            "text_encoder_2_hidden_state": encode_clip_text(
                out2, setup.step_cfg.te2_layer_skip)[0].float(),
            "text_encoder_2_pooled_state": out2["pooled_output"][0].float(),
        }

    return encode_images, encode_text
