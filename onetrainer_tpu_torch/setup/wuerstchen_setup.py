"""Würstchen v2 / Stable Cascade model setup.

Counterpart of onetrainer_tpu/setup/wuerstchen_setup.py (reference:
modules/modelSetup/WuerstchenLoRASetup.py, WuerstchenFineTuneSetup.py,
WuerstchenEmbeddingSetup.py, BaseWuerstchenSetup.py): the CLIP tokenizer
wrap; LoRA on the prior (`prior_lora`, seeded 0, kohya prefix
`lora_prior`) and, when its part trains, the text encoder (`te_lora`,
seeded 1, `lora_prior_te`), from a LoRA file when `lora_model_name` names
one; FINE_TUNE of the prior and the text encoder, each when its part
trains; EMBEDDING of the text encoder's input vectors, which FINE_TUNE
trains too when the config has additional embeddings (as the reference's,
LoRA trains none, and output embeddings are not among Würstchen's); the
frozen prior and text encoder quantized by their weight dtypes after the
adapters exist (setup/quantize.py); the clipped optimizer, the step
(train/wuerstchen_train_step.py; the layer skip the config's
`text_encoder_layer_skip`, the text encoder in the step when it trains
or embeddings do) and the train state. `make_wuerstchen_encode_fns`
caches the effnet latents (a x0.75 antialiased bilinear resize, ImageNet
normalization, the encoder) and the text: Cascade the raw picked hidden
state and the pooled projection, v2 the final-LayerNorm'd state. A
FINE_TUNE config that trains nothing freezes and quantizes the base for
sampling and builds no trainer.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
from onetrainer_tpu_torch.models.resize import resize
from onetrainer_tpu_torch.models.wuerstchen_model import WuerstchenModel
from onetrainer_tpu_torch.peft.lora import PeftConfig
from onetrainer_tpu_torch.setup.sd_setup import (
    EmbeddingGroups, _group_schedule, _init_embedding_vectors, embedding_step_fields,
    inference_extra, refuse_unported, setup_training, trained_embeddings, wrap_tokenizer,
)
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, TrainedEmbeddings
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.train.wuerstchen_train_step import (
    encode_wuerstchen_text, make_wuerstchen_train_step,
)
from onetrainer_tpu_torch.util.enums import EMAMode, TrainingMethod

# ImageNet channel statistics of the EfficientNet encoder's input
# (reference: WuerstchenBaseDataLoader.py:65)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# frozen part -> its ModelWeightDtypes attribute
_QUANTIZABLE = {"prior": "prior", "text_encoder": "text_encoder"}
# trainable LoRA group -> (model attribute, adapter key map, init seed)
_LORA_GROUPS = {"prior_lora": ("prior", None, 0),
                "te_lora": ("text_encoder", clip_torch_key_map, 1)}
# the kohya prefix of each LoRA group (the reference's families.py:1100)
LORA_PREFIXES = {"prior_lora": "lora_prior", "te_lora": "lora_prior_te"}
# FINE_TUNE groups: the model attributes (and config parts) that may train
_FINE_TUNE_GROUPS = ("prior", "text_encoder")


@dataclass
class WuerstchenSetup:
    model: WuerstchenModel
    config: object
    tokenizer: SDTokenizer
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
        """(prior, text_encoder, extra_embeddings) for sampling: the model's
        own modules, whose layers carry any trained LoRA adapters, and the
        text encoder's trained rows (None without embeddings)."""
        m = self.model
        return m.prior, m.text_encoder, inference_extra(self.embeddings, 0)


def _input_embeddings(model, config, total_steps: int,
                      steps_per_epoch: int) -> EmbeddingGroups | None:
    """The trained input vectors of the text encoder (the reference's
    `_init_embedding_vectors`), at `embedding_learning_rate` (else the
    learning rate); None when the config has none."""
    vectors, ids = _init_embedding_vectors(model.text_encoder, model.tokenizer, config)
    if vectors is None:
        return None
    lr = config.embedding_learning_rate or config.learning_rate
    return EmbeddingGroups(
        trainable={"embeddings": vectors},
        schedules={"embeddings": _group_schedule(config, lr, total_steps,
                                                 steps_per_epoch=steps_per_epoch)},
        inputs={}, encoders={"": model.text_encoder}, step_fields={}, ids=ids)


def create_wuerstchen_setup(model: WuerstchenModel, config, total_steps: int = 10_000,
                            steps_per_epoch: int = 100) -> WuerstchenSetup:
    """Bind `model` and `config` (see the module docstring)."""
    refuse_unported(config)
    model.tokenizer = wrap_tokenizer(model.tokenizer, model.te_config)
    method = config.training_method
    groups = None
    if method == TrainingMethod.EMBEDDING or (
            method == TrainingMethod.FINE_TUNE and config.train_any_embedding()):
        groups = _input_embeddings(model, config, total_steps, steps_per_epoch)
    base = SDStepConfig.from_train_config(config, "epsilon", config.text_encoder_layer_skip or 0)
    step_cfg = replace(base, vae_scaling_factor=1.0,
                       **embedding_step_fields(groups, base.train_text_encoder))
    setup = WuerstchenSetup(model=model, config=config, tokenizer=model.tokenizer,
                            step_cfg=step_cfg, embedding_ids=groups.ids if groups else {})
    trains, rank_dropout = setup_training(
        setup, groups, _LORA_GROUPS, LORA_PREFIXES, _FINE_TUNE_GROUPS, _QUANTIZABLE,
        total_steps, steps_per_epoch)
    if not trains:
        return setup
    setup.embeddings = trained_embeddings(groups, setup.trainable, ("",), step_cfg)
    setup.train_step = make_wuerstchen_train_step(model, step_cfg, setup.tx,
                                                  rank_dropout=rank_dropout,
                                                  embeddings=setup.embeddings)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def effnet_input(images: torch.Tensor) -> torch.Tensor:
    """Images NHWC in [-1, 1] -> the encoder's input: [0, 1], resized to
    x0.75 (jax.image.resize's antialiased bilinear, models/resize.py),
    ImageNet-normalized, fp32."""
    _, h, w, _ = images.shape
    x01 = (images.float() + 1.0) * 0.5
    x01 = resize(x01, (int(round(h * 0.75)), int(round(w * 0.75))), "bilinear")
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (x01 - mean) / std


def make_wuerstchen_encode_fns(setup: WuerstchenSetup):
    """(encode_images, encode_text) for the data loader's caches:
    `encode_images(images NHWC in [-1, 1])` -> {"latent_image"} (the effnet
    latents [B, 0.75 H / 32, 0.75 W / 32, 16], fp32); `encode_text(prompt)`
    -> the tokens and, when the text encoder does not run in the step, its
    states ("text_encoder_hidden_state", and Cascade's
    "pooled_text_encoder_output"), fp32 on the model's device."""
    model = setup.model
    cfg = setup.step_cfg
    device = next(model.effnet.parameters()).device

    @torch.no_grad()
    def encode_images(images) -> dict:
        x = effnet_input(torch.as_tensor(images, device=device))
        return {"latent_image": model.effnet(x).float()}

    if cfg.train_text_encoder:
        return encode_images, lambda prompt: {"tokens": setup.tokenizer(prompt)}
    te_device = next(model.text_encoder.parameters()).device

    @torch.no_grad()
    def encode_text(prompt: str) -> dict:
        tokens = setup.tokenizer(prompt)
        hidden, pooled = encode_wuerstchen_text(
            model, model.text_encoder, torch.as_tensor(tokens[None], device=te_device),
            layer_skip=cfg.text_encoder_layer_skip)
        row = {"tokens": tokens, "text_encoder_hidden_state": hidden[0].float()}
        if pooled is not None:
            row["pooled_text_encoder_output"] = pooled[0].float()
        return row

    return encode_images, encode_text
