"""HunyuanVideo model setup.

Counterpart of onetrainer_tpu/setup/hunyuan_setup.py (reference:
modules/modelSetup/HunyuanVideoLoRASetup.py, BaseHunyuanVideoSetup.py; the
transformer is the reference's 'prior' part): the tokenizer wraps (Llama's
with its prompt template, CLIP-L's), the LoRA branch of
`create_hunyuan_setup` (adapters for the transformer and, when it trains,
Llama, seeded 0 and 1 as the reference's PRNGKeys), the frozen base
quantized after the adapters exist (setup/quantize.py: the transformer as
`prior`, Llama, CLIP-L), the clipped optimizer, the flow-matching train
step with the guidance `config.prior.guidance_scale` and the train state;
and `make_hunyuan_encode_fns` for latent and text-embedding caching.
FINE_TUNE trains the transformer (as `prior`), when its part trains, as a
parameter group with its own schedule (setup/sd_setup.py:setup_fine_tune;
the reference's hunyuan_setup.py:164-171); Llama and CLIP-L stay frozen,
and with `text_encoder.train` set the text is not cached and both run in
the step (the reference's :197-200). A FINE_TUNE config that trains no
part builds no trainer (it serves sampling). EMBEDDING trains input
vectors of Llama and CLIP-L and output vectors patched into Llama's
cropped states (setup/sd_setup.py:setup_embeddings), as additional
embeddings do beside LoRA and FINE_TUNE.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from onetrainer_tpu_torch.models.hunyuan_video import PROMPT_TEMPLATE_CROP_START
from onetrainer_tpu_torch.models.hunyuan_video_model import HunyuanVideoModel
from onetrainer_tpu_torch.models.llama import encode_llama_text
from onetrainer_tpu_torch.peft.lora import PeftConfig
from onetrainer_tpu_torch.setup.sd_setup import (
    EmbeddingEncoder, embedding_step_fields, inference_extra, refuse_unported,
    setup_embeddings, setup_training, trained_embeddings, wrap_tokenizer,
)
from onetrainer_tpu_torch.setup.tokenizer import LlamaTokenizerWrapper, SDTokenizer
from onetrainer_tpu_torch.train.hunyuan_train_step import make_hunyuan_train_step
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, TrainedEmbeddings
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.util.enums import EMAMode

# trained embedding group -> its key in the embedding file
# (reference: HunyuanVideoEmbeddingSaver.py:27-35)
HUNYUAN_EMBEDDING_KEYS = {"embeddings": "llama", "embeddings_2": "clip_l",
                          "output_embeddings": "llama_out"}
# frozen part -> its ModelWeightDtypes attribute
_QUANTIZABLE = {"transformer": "prior", "text_encoder": "text_encoder",
                "text_encoder_2": "text_encoder_2"}
# trainable LoRA group -> (model attribute, adapter key map, init seed)
_LORA_GROUPS = {
    "transformer_lora": ("transformer", None, 0),
    "te_lora": ("text_encoder", None, 1),
}
# the kohya prefix of each LoRA group (the reference's setup/hunyuan_setup.py:173-177)
LORA_PREFIXES = {"transformer_lora": "lora_transformer", "te_lora": "lora_te1"}
# model attribute -> its config part, where they differ
_PARTS = {"transformer": "prior"}
# FINE_TUNE groups: the model attributes that may train
_FINE_TUNE_GROUPS = ("transformer",)


@dataclass
class HunyuanSetup:
    model: HunyuanVideoModel
    config: object
    tokenizer: LlamaTokenizerWrapper
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
    embedding_save_keys: dict = field(default_factory=lambda: dict(HUNYUAN_EMBEDDING_KEYS))

    def merged_inference_params(self):
        """(transformer, text_encoder, text_encoder_2, (extra_1, extra_2))
        for sampling: the model's own modules, whose layers carry any
        trained LoRA adapters, and each text encoder's trained embedding
        rows (Llama's, CLIP-L's)."""
        m, e = self.model, self.embeddings
        return (m.transformer, m.text_encoder, m.text_encoder_2,
                (inference_extra(e, 0), inference_extra(e, 1)))


def create_hunyuan_setup(model: HunyuanVideoModel, config, total_steps: int = 10_000,
                         steps_per_epoch: int = 100) -> HunyuanSetup:
    """Bind `model` and `config`: the tokenizers, the LoRA groups
    (setup/sd_setup.py:setup_lora) or the FINE_TUNE group
    (setup/sd_setup.py:setup_fine_tune), the transformer's config part
    being `prior`, or the EMBEDDING vectors of Llama and CLIP-L, output
    embeddings patching Llama's cropped states alone (the reference's
    hunyuan_setup.py:119-159; additional embeddings train beside LoRA and
    FINE_TUNE too), the clipped optimizer, the train step and the train
    state. A FINE_TUNE config that does not train the transformer builds
    no trainer: its setup freezes and quantizes the base for sampling."""
    refuse_unported(config)
    if not isinstance(model.tokenizer, LlamaTokenizerWrapper):
        model.tokenizer = LlamaTokenizerWrapper(model.tokenizer,
                                                vocab_size=model.te_config.vocab_size)
    model.tokenizer_2 = wrap_tokenizer(model.tokenizer_2, model.te2_config)

    def llama_context(tokens):
        return encode_llama_text(model.text_encoder(tokens), 0, default_layer=-3,
                                 crop_start=PROMPT_TEMPLATE_CROP_START)

    groups = setup_embeddings(
        config, [EmbeddingEncoder("", model.text_encoder, model.tokenizer,
                                  encode_fn=llama_context, start=0),
                 EmbeddingEncoder("_2", model.text_encoder_2, model.tokenizer_2,
                                  patch_output=False)],
        total_steps, steps_per_epoch)
    step_cfg = replace(
        SDStepConfig.from_train_config(config, "flow", config.text_encoder_layer_skip or 0),
        vae_scaling_factor=model.vae_config.scaling_factor,
        **embedding_step_fields(groups, config.text_encoder.train))
    setup = HunyuanSetup(model=model, config=config, tokenizer=model.tokenizer,
                         tokenizer_2=model.tokenizer_2, step_cfg=step_cfg,
                         embedding_ids=groups.ids if groups else {})
    trains, rank_dropout = setup_training(
        setup, groups, _LORA_GROUPS, LORA_PREFIXES, _FINE_TUNE_GROUPS, _QUANTIZABLE,
        total_steps, steps_per_epoch, parts=_PARTS)
    if not trains:
        return setup
    setup.embeddings = trained_embeddings(groups, setup.trainable, ("", "_2"), step_cfg)
    setup.train_step = make_hunyuan_train_step(
        model, step_cfg, setup.tx, guidance_scale=config.prior.guidance_scale or 1.0,
        rank_dropout=rank_dropout, embeddings=setup.embeddings)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def make_hunyuan_encode_fns(setup: HunyuanSetup):
    """(encode_images, encode_text) for the data loader's caches:
    `encode_images(images NHWC or clips NTHWC in [-1, 1])` -> {"latent_image",
    "latent_logvar"} [B, T', h, w, 16] fp32 on the model's device (an image
    row as a 1-frame clip); `encode_text(prompt)` -> the Llama tokens
    ("tokens_1"), their keep mask ("tokens_mask_1") and CLIP-L's tokens
    ("tokens_2"), plus, when Llama does not train, its states at layer -3
    minus the layer skip past the template [77, 4096]
    ("text_encoder_1_hidden_state"), the mask cropped alike, and CLIP-L's
    pooled embedding [768] ("text_encoder_2_pooled_state")."""
    model = setup.model
    cfg = setup.step_cfg
    vae_device = next(model.vae.parameters()).device

    @torch.no_grad()
    def encode_images(images) -> dict:
        x = torch.as_tensor(images, device=vae_device)
        if x.dim() == 4:   # image rows -> 1-frame clips
            x = x[:, None]
        mean, logvar = model.vae.encode(x)
        return {"latent_image": mean.float(), "latent_logvar": logvar.float()}

    def tokens(prompt: str) -> dict:
        t1 = setup.tokenizer(prompt)
        return {"tokens_1": t1, "tokens_mask_1": setup.tokenizer.mask(t1),
                "tokens_2": setup.tokenizer_2(prompt)}

    if cfg.train_text_encoder:
        return encode_images, tokens
    device = next(model.text_encoder.parameters()).device

    @torch.no_grad()
    def encode_text(prompt: str) -> dict:
        out = tokens(prompt)
        t1, mask, t2 = (torch.as_tensor(out[k][None], device=device)
                        for k in ("tokens_1", "tokens_mask_1", "tokens_2"))
        states = encode_llama_text(model.text_encoder(t1, mask), cfg.text_encoder_layer_skip,
                                   default_layer=-3, crop_start=PROMPT_TEMPLATE_CROP_START)
        out["tokens_mask_1"] = out["tokens_mask_1"][PROMPT_TEMPLATE_CROP_START:]
        out["text_encoder_1_hidden_state"] = states[0].float()
        out["text_encoder_2_pooled_state"] = model.text_encoder_2(t2)["pooled_output"][0].float()
        return out

    return encode_images, encode_text
