"""Sana model setup.

Counterpart of onetrainer_tpu/setup/sana_setup.py (reference:
modules/modelSetup/SanaLoRASetup.py, SanaFineTuneSetup.py,
BaseSanaSetup.py; the transformer is the reference's 'prior' part, Gemma-2
its text encoder): the Gemma tokenizer wrap (300 tokens, BOS first, its
keep mask), the LoRA branch of `create_sana_setup` (adapters for the
transformer and, when its part trains, Gemma, seeded 0 and 1 as the
reference's PRNGKeys), FINE_TUNE of the transformer and Gemma, each when
its part trains (setup/sd_setup.py:setup_fine_tune), EMBEDDING of Gemma's
input vectors and output vectors patched into its states (as in the
reference, only EMBEDDING trains embeddings here), the frozen base
quantized after the adapters exist (setup/quantize.py: the transformer as
`prior`, Gemma), the clipped optimizer, the flow-matching step
(train/sana_train_step.py, at the config's text-encoder layer skip;
Gemma runs in the step when it trains or under EMBEDDING) and the train
state; and `make_sana_encode_fns` for latent and Gemma-state caching. A
FINE_TUNE config that trains nothing freezes and quantizes the base for
sampling and builds no trainer.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from onetrainer_tpu_torch.io.sana_checkpoints import sana_torch_key_map
from onetrainer_tpu_torch.models.gemma import apply_gemma_final_norm, encode_gemma_text
from onetrainer_tpu_torch.models.sana_model import SanaModel
from onetrainer_tpu_torch.peft.lora import PeftConfig
from onetrainer_tpu_torch.setup.sd_setup import (
    EmbeddingEncoder, embedding_step_fields, inference_extra, refuse_unported,
    setup_embeddings, setup_training, trained_embeddings,
)
from onetrainer_tpu_torch.setup.tokenizer import GemmaTokenizerWrapper
from onetrainer_tpu_torch.train.sana_train_step import make_sana_train_step
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, TrainedEmbeddings
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.util.enums import EMAMode, TrainingMethod

# trained embedding group -> its key in the embedding file
# (reference: SanaEmbeddingSaver.py:27-31)
SANA_EMBEDDING_KEYS = {"embeddings": "gemma", "output_embeddings": "gemma_out"}
# the reference setup's Gemma length
SANA_TOKENS = 300
# frozen part -> its ModelWeightDtypes attribute
_QUANTIZABLE = {"transformer": "prior", "text_encoder": "text_encoder"}
# trainable LoRA group -> (model attribute, adapter key map, init seed); the
# transformer's adapters take the reference's flax module paths
# (`time_embed_linear`, `caption_projection_linear_1`)
_LORA_GROUPS = {
    "transformer_lora": ("transformer", sana_torch_key_map, 0),
    "te_lora": ("text_encoder", None, 1),
}
# the kohya prefix of each LoRA group (the reference's setup/sana_setup.py:151)
LORA_PREFIXES = {"transformer_lora": "lora_transformer", "te_lora": "lora_te1"}
# model attribute -> its config part, where they differ
_PARTS = {"transformer": "prior"}
# FINE_TUNE groups: the model attributes that may train
_FINE_TUNE_GROUPS = ("transformer", "text_encoder")


@dataclass
class SanaSetup:
    model: SanaModel
    config: object
    tokenizer: GemmaTokenizerWrapper
    peft_cfg: PeftConfig | None = None
    step_cfg: SDStepConfig | None = None
    trainable: dict = field(default_factory=dict)
    tx: object = None
    train_step: object = None
    state: object = None
    group_schedules: dict = field(default_factory=dict)
    embeddings: TrainedEmbeddings | None = None
    embedding_ids: dict = field(default_factory=dict)   # uuid -> (start, count)
    embedding_save_keys: dict = field(default_factory=lambda: dict(SANA_EMBEDDING_KEYS))
    # LoRA group -> its adapters' key map, for the export's merge
    lora_key_maps: dict = field(default_factory=lambda: {
        group: key_map for group, (_, key_map, _) in _LORA_GROUPS.items()})

    def merged_inference_params(self):
        """(transformer, text_encoder, extra_embeddings) for sampling: the
        model's own modules, whose layers carry any trained LoRA adapters,
        and Gemma's trained embedding rows (None without embeddings)."""
        m = self.model
        return m.transformer, m.text_encoder, inference_extra(self.embeddings, 0)


def create_sana_setup(model: SanaModel, config, total_steps: int = 10_000,
                      steps_per_epoch: int = 100) -> SanaSetup:
    """Bind `model` and `config`: the tokenizer, the LoRA groups, the
    FINE_TUNE groups or the EMBEDDING vectors, the clipped optimizer, the
    train step and the train state (see the module docstring)."""
    refuse_unported(config)
    if not isinstance(model.tokenizer, GemmaTokenizerWrapper):
        model.tokenizer = GemmaTokenizerWrapper(model.tokenizer, max_length=SANA_TOKENS,
                                                vocab_size=model.te_config.vocab_size)
    groups = None
    if config.training_method == TrainingMethod.EMBEDDING:
        groups = setup_embeddings(
            config, [EmbeddingEncoder("", model.text_encoder, model.tokenizer)],
            total_steps, steps_per_epoch)
    step_cfg = replace(
        SDStepConfig.from_train_config(config, "flow", config.text_encoder_layer_skip or 0),
        vae_scaling_factor=model.vae_config.scaling_factor,
        **embedding_step_fields(groups, bool(config.text_encoder.train)))
    setup = SanaSetup(model=model, config=config, tokenizer=model.tokenizer,
                      step_cfg=step_cfg, embedding_ids=groups.ids if groups else {})
    trains, rank_dropout = setup_training(
        setup, groups, _LORA_GROUPS, LORA_PREFIXES, _FINE_TUNE_GROUPS, _QUANTIZABLE,
        total_steps, steps_per_epoch, parts=_PARTS)
    if not trains:
        return setup
    setup.embeddings = trained_embeddings(groups, setup.trainable, ("",), step_cfg)
    setup.train_step = make_sana_train_step(model, step_cfg, setup.tx,
                                            rank_dropout=rank_dropout,
                                            embeddings=setup.embeddings)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def make_sana_encode_fns(setup: SanaSetup):
    """(encode_images, encode_text) for the data loader's caches:
    `encode_images(images NHWC in [-1, 1])` -> {"latent_image"} (DC-AE's
    deterministic latent, fp32); `encode_text(prompt)` -> the Gemma tokens
    ("tokens") and their keep mask ("tokens_mask"), plus, when Gemma does
    not run in the step, its states at the layer skip
    ("text_encoder_hidden_state" [300, 2304], fp32 on the model's device)."""
    model = setup.model
    cfg = setup.step_cfg
    vae_device = next(model.vae.parameters()).device

    @torch.no_grad()
    def encode_images(images) -> dict:
        return {"latent_image": model.vae.encode(
            torch.as_tensor(images, device=vae_device)).float()}

    def tokens(prompt: str) -> dict:
        t = setup.tokenizer(prompt)
        return {"tokens": t, "tokens_mask": setup.tokenizer.mask(t)}

    if cfg.train_text_encoder:
        return encode_images, tokens
    device = next(model.text_encoder.parameters()).device

    @torch.no_grad()
    def encode_text(prompt: str) -> dict:
        out = tokens(prompt)
        t, m = (torch.as_tensor(out[k][None], device=device) for k in ("tokens", "tokens_mask"))
        hidden = encode_gemma_text(model.text_encoder(t, m), cfg.text_encoder_layer_skip)
        if cfg.text_encoder_layer_skip > 0:
            hidden = apply_gemma_final_norm(model.text_encoder, hidden)
        out["text_encoder_hidden_state"] = hidden[0].float()
        return out

    return encode_images, encode_text
