"""FLUX model setup.

Counterpart of onetrainer_tpu/setup/flux_setup.py (reference:
modules/modelSetup/FluxLoRASetup.py, BaseFluxSetup.py; the transformer is
the reference's 'prior' part): the tokenizer wraps (CLIP-L's and T5's),
the LoRA branch of `create_flux_setup` (adapters for the transformer and,
when it trains, CLIP-L, seeded 0 and 1 as the reference's PRNGKeys; a
`lora_layer_preset` of `FLUX_LORA_PRESETS` picks the layers when
`lora_layers` is empty), the frozen base quantized after the adapters
exist (setup/quantize.py: the transformer as `prior`, CLIP-L and T5), the
clipped optimizer, the flow-matching train step with the guidance
`config.prior.guidance_scale` and the train state; and
`make_flux_encode_fns` for latent and text-embedding caching. FINE_TUNE
trains the transformer (as `prior`) and CLIP-L, each when its part
trains, as parameter groups with their own schedules
(setup/sd_setup.py:setup_fine_tune; the reference's flux_setup.py:
170-184); a FINE_TUNE config that trains no part builds no trainer (it
serves sampling). EMBEDDING trains input vectors of CLIP-L and T5 and
output vectors patched into T5's output (setup/sd_setup.py:
setup_embeddings), as additional embeddings do beside LoRA and FINE_TUNE.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
from onetrainer_tpu_torch.models.flux_model import FluxModel
from onetrainer_tpu_torch.peft.lora import PeftConfig
from onetrainer_tpu_torch.setup.sd_setup import (
    EmbeddingEncoder, embedding_step_fields, image_encoder, inference_extra,
    refuse_unported, setup_embeddings, setup_training, trained_embeddings, wrap_tokenizer,
)
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer, T5TokenizerWrapper
from onetrainer_tpu_torch.train.flux_train_step import make_flux_train_step
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, TrainedEmbeddings
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.util.enums import EMAMode

# FLUX layer-filter presets (reference: FluxLoRASetup.PRESETS:12-16)
FLUX_LORA_PRESETS = {
    "attn-mlp": ("attn", "ff", "proj_mlp", "proj_out"),
    "attn-only": ("attn",),
    "full": (),
}
# trained embedding group -> its key in the embedding file
FLUX_EMBEDDING_KEYS = {"embeddings": "clip_l", "embeddings_2": "t5",
                       "output_embeddings_2": "t5_out"}
# frozen part -> its ModelWeightDtypes attribute
_QUANTIZABLE = {"transformer": "prior", "text_encoder": "text_encoder",
                "text_encoder_2": "text_encoder_2"}
# trainable LoRA group -> (model attribute, adapter key map, init seed)
_LORA_GROUPS = {
    "transformer_lora": ("transformer", None, 0),
    "te_lora": ("text_encoder", clip_torch_key_map, 1),
}
# the kohya prefix of each LoRA group (the reference's setup/flux_setup.py:186-191)
LORA_PREFIXES = {"transformer_lora": "lora_transformer", "te_lora": "lora_te1"}
# FINE_TUNE groups: the model attributes that may train (the reference's)
_FINE_TUNE_GROUPS = ("transformer", "text_encoder")
# model attribute -> its config part, where they differ
_PARTS = {"transformer": "prior"}


@dataclass
class FluxSetup:
    model: FluxModel
    config: object
    tokenizer: SDTokenizer
    tokenizer_2: T5TokenizerWrapper
    peft_cfg: PeftConfig | None = None
    step_cfg: SDStepConfig | None = None
    trainable: dict = field(default_factory=dict)
    tx: object = None
    train_step: object = None
    state: object = None
    group_schedules: dict = field(default_factory=dict)
    embeddings: TrainedEmbeddings | None = None
    embedding_ids: dict = field(default_factory=dict)   # uuid -> (start, count)
    # the embedding file's keys (reference: FluxEmbeddingSaver.py:29-35)
    embedding_save_keys: dict = field(default_factory=lambda: dict(FLUX_EMBEDDING_KEYS))

    def merged_inference_params(self):
        """(transformer, text_encoder, text_encoder_2, (extra_1, extra_2))
        for sampling: the model's own modules, whose layers carry any
        trained LoRA adapters, and each text encoder's trained embedding
        rows."""
        m, e = self.model, self.embeddings
        return (m.transformer, m.text_encoder, m.text_encoder_2,
                (inference_extra(e, 0), inference_extra(e, 1)))


def flux_peft_config(config) -> PeftConfig:
    """The config's PeftConfig, its layer filter from `lora_layer_preset`
    when `lora_layers` names none."""
    peft_cfg = PeftConfig.from_train_config(config)
    if config.lora_layer_preset in FLUX_LORA_PRESETS and not peft_cfg.layer_filter:
        peft_cfg = replace(peft_cfg, layer_filter=FLUX_LORA_PRESETS[config.lora_layer_preset])
    return peft_cfg


def create_flux_setup(model: FluxModel, config, total_steps: int = 10_000,
                      steps_per_epoch: int = 100) -> FluxSetup:
    """Bind `model` and `config`: the tokenizers, the LoRA groups
    (setup/sd_setup.py:setup_lora, the transformer's config part being
    `prior`) or the FINE_TUNE groups (the transformer and CLIP-L, each when
    its part trains: setup/sd_setup.py:setup_fine_tune; CLIP-L training
    runs the text encoders in the step) or the EMBEDDING vectors of CLIP-L
    and T5, output embeddings patching T5's output alone (the reference's
    flux_setup.py:132-169; additional embeddings train beside LoRA and
    FINE_TUNE too), the clipped optimizer, the train step and the train
    state. A FINE_TUNE config that trains nothing freezes and quantizes the
    base for sampling and builds no trainer."""
    refuse_unported(config)
    model.tokenizer = wrap_tokenizer(model.tokenizer, model.te_config)
    if not isinstance(model.tokenizer_2, T5TokenizerWrapper):
        model.tokenizer_2 = T5TokenizerWrapper(model.tokenizer_2,
                                               vocab_size=model.te2_config.vocab_size)
    groups = setup_embeddings(
        config, [EmbeddingEncoder("", model.text_encoder, model.tokenizer, patch_output=False),
                 EmbeddingEncoder("_2", model.text_encoder_2, model.tokenizer_2)],
        total_steps, steps_per_epoch)
    step_cfg = replace(
        SDStepConfig.from_train_config(config, "flow", 0),
        vae_scaling_factor=model.vae_config.scaling_factor,
        vae_shift_factor=model.vae_config.shift_factor,
        **embedding_step_fields(groups, config.train_text_encoder_or_embedding()))
    setup = FluxSetup(model=model, config=config, tokenizer=model.tokenizer,
                      tokenizer_2=model.tokenizer_2, step_cfg=step_cfg,
                      embedding_ids=groups.ids if groups else {})
    trains, rank_dropout = setup_training(
        setup, groups, _LORA_GROUPS, LORA_PREFIXES, _FINE_TUNE_GROUPS, _QUANTIZABLE,
        total_steps, steps_per_epoch, parts=_PARTS,
        peft_cfg=flux_peft_config(config))
    if not trains:
        return setup
    setup.embeddings = trained_embeddings(groups, setup.trainable, ("", "_2"), step_cfg)
    setup.train_step = make_flux_train_step(model, step_cfg, setup.tx,
                                            guidance_scale=config.prior.guidance_scale,
                                            rank_dropout=rank_dropout,
                                            embeddings=setup.embeddings)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def make_flux_encode_fns(setup: FluxSetup):
    """(encode_images, encode_text) for the data loader's caches:
    `encode_images(images NHWC in [-1, 1])` -> {"latent_image",
    "latent_logvar"}; `encode_text(prompt)` -> both token rows, plus the
    pooled CLIP-L embedding [768] and the T5 states [77, 4096] at T5's layer
    skip ("clip_pooled_state", "t5_hidden_state", fp32 on the model's
    device) when CLIP-L does not train."""
    model = setup.model
    encode_images = image_encoder(model)
    cfg = setup.step_cfg

    def tokens(prompt: str) -> dict:
        return {"tokens": setup.tokenizer(prompt), "tokens_2": setup.tokenizer_2(prompt)}

    if cfg.train_text_encoder:
        return encode_images, tokens
    device = next(model.text_encoder.parameters()).device

    @torch.no_grad()
    def encode_text(prompt: str) -> dict:
        out = tokens(prompt)
        t1, t2 = (torch.as_tensor(out[k][None], device=device) for k in ("tokens", "tokens_2"))
        pooled = model.text_encoder(t1)["pooled_output"]
        t5 = model.text_encoder_2(t2, layer_skip=cfg.te2_layer_skip)
        out["clip_pooled_state"] = pooled[0].float()
        out["t5_hidden_state"] = t5[0].float()
        return out

    return encode_images, encode_text
