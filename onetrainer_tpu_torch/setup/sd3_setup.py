"""SD3 model setup.

Counterpart of onetrainer_tpu/setup/sd3_setup.py (reference:
modules/modelSetup/StableDiffusion3LoRASetup.py,
BaseStableDiffusion3Setup.py; the MMDiT is the reference's 'prior' part):
tokenizer wrapping (two CLIP tokenizers and T5's), the LoRA branch of
`create_sd3_setup` (adapters for the transformer and each trained CLIP
encoder, seeded 0, 1, 2 as the reference's PRNGKeys), the frozen base
quantized after the adapters exist (setup/quantize.py: the transformer as
`prior`, and each text encoder), the clipped optimizer, the flow-matching
train step and the train state; and `make_sd3_encode_fns` for latent and
text-embedding caching. FINE_TUNE trains the transformer (as `prior`)
and CLIP-L, each when its part trains, as parameter groups with their own
schedules (setup/sd_setup.py:setup_fine_tune; the reference's
sd3_setup.py:137-151); a FINE_TUNE config that trains no part builds no
trainer (it serves sampling). EMBEDDING trains input and output
embedding vectors of CLIP-L, CLIP-G and T5 (setup/sd_setup.py:
setup_embeddings), as additional embeddings do beside LoRA and FINE_TUNE.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.models.sd3 import sd3_text_context
from onetrainer_tpu_torch.models.sd3_model import StableDiffusion3Model
from onetrainer_tpu_torch.peft.lora import PeftConfig
from onetrainer_tpu_torch.setup.sd_setup import (
    EmbeddingEncoder, embedding_step_fields, image_encoder, inference_extra,
    refuse_unported, setup_embeddings, setup_training, trained_embeddings, wrap_tokenizer,
)
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer, T5TokenizerWrapper
from onetrainer_tpu_torch.train.sd3_train_step import make_sd3_train_step
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, TrainedEmbeddings
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.util.enums import EMAMode

# frozen part -> its ModelWeightDtypes attribute
_QUANTIZABLE = {"transformer": "prior", "text_encoder": "text_encoder",
                "text_encoder_2": "text_encoder_2", "text_encoder_3": "text_encoder_3"}
# trainable LoRA group -> (model attribute, adapter key map, init seed)
_LORA_GROUPS = {
    "transformer_lora": ("transformer", None, 0),
    "te_lora": ("text_encoder", clip_torch_key_map, 1),
    "te2_lora": ("text_encoder_2", clip_torch_key_map, 2),
}
# the kohya prefix of each LoRA group (the reference's setup/sd3_setup.py:195-200)
LORA_PREFIXES = {"transformer_lora": "lora_transformer", "te_lora": "lora_te1",
                 "te2_lora": "lora_te2"}
# FINE_TUNE groups: the model attributes that may train (the reference's)
_FINE_TUNE_GROUPS = ("transformer", "text_encoder")
# model attribute -> its config part, where they differ
_PARTS = {"transformer": "prior"}


@dataclass
class SD3Setup:
    model: StableDiffusion3Model
    config: object
    tokenizer: SDTokenizer
    tokenizer_2: SDTokenizer
    tokenizer_3: T5TokenizerWrapper
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
        """(transformer, text_encoder, text_encoder_2, text_encoder_3,
        (extra_1, extra_2, extra_3)) for sampling: the model's own modules,
        whose layers carry any trained LoRA adapters, and each text
        encoder's trained embedding rows."""
        m, e = self.model, self.embeddings
        return (m.transformer, m.text_encoder, m.text_encoder_2, m.text_encoder_3,
                tuple(inference_extra(e, i) for i in range(3)))


def create_sd3_setup(model: StableDiffusion3Model, config, total_steps: int = 10_000,
                     steps_per_epoch: int = 100) -> SD3Setup:
    """Bind `model` and `config`: the tokenizers, the LoRA groups
    (setup/sd_setup.py:setup_lora, the transformer's config part being
    `prior`), the clipped optimizer, the train step (sigma-interpolated flow
    matching; the reference's step config takes layer skip 0 for CLIP-L)
    and the train state. FINE_TUNE trains the transformer and CLIP-L, each
    when its part trains (setup/sd_setup.py:setup_fine_tune); the text
    encoders then run in the step whenever CLIP-L or CLIP-G trains, as the
    reference's. EMBEDDING trains a vector table per text encoder (CLIP-L,
    CLIP-G and T5; input and output embeddings, the reference's
    sd3_setup.py:158-190), as additional embeddings do beside LoRA and
    FINE_TUNE. One that trains nothing freezes and quantizes the base for
    sampling and builds no trainer."""
    refuse_unported(config)
    model.tokenizer = wrap_tokenizer(model.tokenizer, model.te_config)
    model.tokenizer_2 = wrap_tokenizer(model.tokenizer_2, model.te2_config)
    if not isinstance(model.tokenizer_3, T5TokenizerWrapper):
        model.tokenizer_3 = T5TokenizerWrapper(model.tokenizer_3,
                                               vocab_size=model.te3_config.vocab_size)
    groups = setup_embeddings(
        config, [EmbeddingEncoder("", model.text_encoder, model.tokenizer),
                 EmbeddingEncoder("_2", model.text_encoder_2, model.tokenizer_2),
                 EmbeddingEncoder("_3", model.text_encoder_3, model.tokenizer_3)],
        total_steps, steps_per_epoch)
    step_cfg = replace(
        SDStepConfig.from_train_config(config, "flow", 0),
        vae_scaling_factor=model.vae_config.scaling_factor,
        vae_shift_factor=model.vae_config.shift_factor,
        **embedding_step_fields(groups, config.train_text_encoder_or_embedding()
                                or config.train_text_encoder_2_or_embedding()))
    setup = SD3Setup(model=model, config=config, tokenizer=model.tokenizer,
                     tokenizer_2=model.tokenizer_2, tokenizer_3=model.tokenizer_3,
                     step_cfg=step_cfg, embedding_ids=groups.ids if groups else {})
    trains, rank_dropout = setup_training(
        setup, groups, _LORA_GROUPS, LORA_PREFIXES, _FINE_TUNE_GROUPS, _QUANTIZABLE,
        total_steps, steps_per_epoch, parts=_PARTS)
    if not trains:
        return setup
    setup.embeddings = trained_embeddings(groups, setup.trainable, ("", "_2", "_3"), step_cfg)
    setup.train_step = make_sd3_train_step(model, step_cfg, setup.tx, rank_dropout,
                                           setup.embeddings)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def make_sd3_encode_fns(setup: SD3Setup):
    """(encode_images, encode_text) for the data loader's caches:
    `encode_images(images NHWC in [-1, 1])` -> {"latent_image",
    "latent_logvar"}; `encode_text(prompt)` -> the three token rows, plus
    the assembled context [S, 4096] and pooled [2048] embeddings
    ("sd3_context", "sd3_pooled", fp32 on the model's device) when no text
    encoder trains."""
    model = setup.model
    encode_images = image_encoder(model)
    cfg = setup.step_cfg

    def tokens(prompt: str) -> dict:
        return {"tokens": setup.tokenizer(prompt), "tokens_2": setup.tokenizer_2(prompt),
                "tokens_3": setup.tokenizer_3(prompt)}

    if cfg.train_text_encoder:
        return encode_images, tokens
    device = next(model.text_encoder.parameters()).device

    @torch.no_grad()
    def encode_text(prompt: str) -> dict:
        out = tokens(prompt)
        t1, t2, t3 = (torch.as_tensor(out[k][None], device=device)
                      for k in ("tokens", "tokens_2", "tokens_3"))
        out_l = model.text_encoder(t1)
        out_g = model.text_encoder_2(t2)
        t5 = model.text_encoder_3(t3, layer_skip=cfg.te3_layer_skip)
        context, pooled = sd3_text_context(
            encode_clip_text(out_l, cfg.text_encoder_layer_skip),
            encode_clip_text(out_g, cfg.te2_layer_skip),
            t5, out_l["pooled_output"], out_g["pooled_output"])
        out["sd3_context"] = context[0].float()
        out["sd3_pooled"] = pooled[0].float()
        return out

    return encode_images, encode_text
