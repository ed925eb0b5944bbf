"""PixArt model setup.

Counterpart of onetrainer_tpu/setup/pixart_setup.py (reference:
modules/modelSetup/PixArtAlphaLoRASetup.py, BasePixArtAlphaSetup.py; the
transformer is the reference's 'prior' part, T5 its text encoder): the T5
tokenizer wrap (120 tokens, as the reference's setup), the LoRA branch of
`create_pixart_setup` (transformer adapters seeded 0, as the reference's
PRNGKey; T5 has none), FINE_TUNE of the transformer when its part trains
(setup/sd_setup.py:setup_fine_tune), EMBEDDING of T5's input vectors and
output vectors patched into its states (setup/sd_setup.py:
setup_embeddings; as in the reference, only EMBEDDING trains embeddings
here), the frozen base quantized after the adapters exist
(setup/quantize.py: the transformer as `prior`, T5), the clipped
optimizer, the step (train/pixart_train_step.py: epsilon with the VB
term; the step config's layer skip 0 and its text encoder running in the
step only under EMBEDDING, as the reference's) and the train state; and
`make_pixart_encode_fns` for latent and T5-state caching. A FINE_TUNE
config that trains nothing freezes and quantizes the base for sampling
and builds no trainer.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from onetrainer_tpu_torch.models.pixart_model import PixArtAlphaModel
from onetrainer_tpu_torch.peft.lora import PeftConfig
from onetrainer_tpu_torch.setup.sd_setup import (
    EmbeddingEncoder, embedding_step_fields, image_encoder, inference_extra, refuse_unported,
    setup_embeddings, setup_training, trained_embeddings,
)
from onetrainer_tpu_torch.setup.tokenizer import T5TokenizerWrapper
from onetrainer_tpu_torch.train.pixart_train_step import make_pixart_train_step
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, TrainedEmbeddings
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.util.enums import EMAMode, TrainingMethod

# trained embedding group -> its key in the embedding file
# (reference: PixArtAlphaEmbeddingSaver.py:29-31)
PIXART_EMBEDDING_KEYS = {"embeddings": "t5", "output_embeddings": "t5_out"}
# the reference setup's T5 length
PIXART_TOKENS = 120
# frozen part -> its ModelWeightDtypes attribute
_QUANTIZABLE = {"transformer": "prior", "text_encoder": "text_encoder"}
# trainable LoRA group -> (model attribute, adapter key map, init seed)
_LORA_GROUPS = {"transformer_lora": ("transformer", None, 0)}
# the kohya prefix of each LoRA group (the reference's families.py:1052)
LORA_PREFIXES = {"transformer_lora": "lora_transformer"}
# model attribute -> its config part, where they differ
_PARTS = {"transformer": "prior"}
# FINE_TUNE groups: the model attributes that may train
_FINE_TUNE_GROUPS = ("transformer",)


@dataclass
class PixArtSetup:
    model: PixArtAlphaModel
    config: object
    tokenizer: T5TokenizerWrapper
    peft_cfg: PeftConfig | None = None
    step_cfg: SDStepConfig | None = None
    trainable: dict = field(default_factory=dict)
    tx: object = None
    train_step: object = None
    state: object = None
    group_schedules: dict = field(default_factory=dict)
    embeddings: TrainedEmbeddings | None = None
    embedding_ids: dict = field(default_factory=dict)   # uuid -> (start, count)
    embedding_save_keys: dict = field(default_factory=lambda: dict(PIXART_EMBEDDING_KEYS))

    def merged_inference_params(self):
        """(transformer, text_encoder, extra_embeddings) for sampling: the
        model's own modules, whose layers carry any trained LoRA adapters,
        and T5's trained embedding rows (None without embeddings)."""
        m = self.model
        return m.transformer, m.text_encoder, inference_extra(self.embeddings, 0)


def create_pixart_setup(model: PixArtAlphaModel, config, total_steps: int = 10_000,
                        steps_per_epoch: int = 100) -> PixArtSetup:
    """Bind `model` and `config`: the tokenizer, the LoRA group, the
    FINE_TUNE group or the EMBEDDING vectors, the clipped optimizer, the
    train step and the train state (see the module docstring)."""
    refuse_unported(config)
    if not isinstance(model.tokenizer, T5TokenizerWrapper):
        model.tokenizer = T5TokenizerWrapper(model.tokenizer, max_length=PIXART_TOKENS,
                                             vocab_size=model.te_config.vocab_size)
    groups = None
    if config.training_method == TrainingMethod.EMBEDDING:
        groups = setup_embeddings(
            config, [EmbeddingEncoder("", model.text_encoder, model.tokenizer)],
            total_steps, steps_per_epoch)
    step_cfg = replace(SDStepConfig.from_train_config(config, "epsilon", 0),
                       vae_scaling_factor=model.vae_config.scaling_factor,
                       **embedding_step_fields(groups, False))
    setup = PixArtSetup(model=model, config=config, tokenizer=model.tokenizer,
                        step_cfg=step_cfg, embedding_ids=groups.ids if groups else {})
    trains, rank_dropout = setup_training(
        setup, groups, _LORA_GROUPS, LORA_PREFIXES, _FINE_TUNE_GROUPS, _QUANTIZABLE,
        total_steps, steps_per_epoch, parts=_PARTS)
    if not trains:
        return setup
    setup.embeddings = trained_embeddings(groups, setup.trainable, ("",), step_cfg)
    setup.train_step = make_pixart_train_step(model, step_cfg, setup.tx,
                                              rank_dropout=rank_dropout,
                                              embeddings=setup.embeddings)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def make_pixart_encode_fns(setup: PixArtSetup):
    """(encode_images, encode_text) for the data loader's caches:
    `encode_images(images NHWC in [-1, 1])` -> {"latent_image",
    "latent_logvar"}; `encode_text(prompt)` -> the T5 tokens ("tokens_2")
    and, when T5 does not run in the step, its states at the step's layer
    skip ("t5_hidden_state" [120, 4096], fp32 on the model's device)."""
    model = setup.model
    encode_images = image_encoder(model)
    cfg = setup.step_cfg

    def tokens(prompt: str) -> dict:
        return {"tokens_2": setup.tokenizer(prompt)}

    if cfg.train_text_encoder:
        return encode_images, tokens
    device = next(model.text_encoder.parameters()).device

    @torch.no_grad()
    def encode_text(prompt: str) -> dict:
        out = tokens(prompt)
        t5 = model.text_encoder(torch.as_tensor(out["tokens_2"][None], device=device),
                                layer_skip=cfg.text_encoder_layer_skip)
        out["t5_hidden_state"] = t5[0].float()
        return out

    return encode_images, encode_text
