"""SDXL model setup.

Counterpart of onetrainer_tpu/setup/sdxl_setup.py: schedule flags,
tokenizer wrapping, the LoRA training branch of `create_sdxl_setup`
(adapters, per-group schedules, the clipped AdamW, the train step),
`merged_inference_params`, and `make_sdxl_encode_fns` for latent and
text-embedding caching. FINE_TUNE builds no trainer yet (it serves
sampling); EMBEDDING training and continuing from a LoRA file raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.models.sdxl import StableDiffusionXLModel
from onetrainer_tpu_torch.peft.lora import (
    PeftConfig, attach_peft, init_peft_params,
)
from onetrainer_tpu_torch.setup.sd_setup import _group_schedule
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer
from onetrainer_tpu_torch.train.optimizers import create_group_optimizer
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig
from onetrainer_tpu_torch.train.sdxl_train_step import make_sdxl_train_step
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.util.enums import TrainingMethod

# trainable LoRA group -> (model attribute, adapter key map, init seed)
_LORA_GROUPS = {
    "unet_lora": ("unet", None, 0),
    "te_lora": ("text_encoder", clip_torch_key_map, 1),
    "te2_lora": ("text_encoder_2", clip_torch_key_map, 2),
}


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

    def merged_inference_params(self):
        """(unet, text_encoder, text_encoder_2, (extra_1, extra_2)) modules
        for sampling: the model's own modules. Under LoRA their layers carry
        the trained adapters and add the LoRA term in their forward, which
        equals sampling from merged weights without a merged copy of the
        base (peft.lora.merge_peft_into_base is for export)."""
        m = self.model
        return m.unet, m.text_encoder, m.text_encoder_2, (None, None)


def create_sdxl_setup(model: StableDiffusionXLModel, config,
                      total_steps: int = 10_000,
                      steps_per_epoch: int = 100) -> SDXLSetup:
    """Bind `model` and `config`. For LoRA: adapters for the UNet and each
    trained text encoder, drawn on the model's device from a generator
    seeded per group (0, 1, 2, as the reference's PRNGKeys) and attached to
    the layers; the frozen base stops requiring grads."""
    method = config.training_method
    if method == TrainingMethod.EMBEDDING:
        raise NotImplementedError("EMBEDDING training is not ported yet")
    if config.rescale_noise_scheduler_to_zero_terminal_snr:
        model.rescale_noise_scheduler_to_zero_terminal_snr()
        model.force_v_prediction()
    if config.force_v_prediction:
        model.force_v_prediction()
    if config.force_epsilon_prediction:
        model.force_epsilon_prediction()

    def wrap_tokenizer(tok, cfg):
        if isinstance(tok, SDTokenizer):
            return tok
        return SDTokenizer(tok, max_length=cfg.max_position_embeddings,
                           vocab_size=cfg.vocab_size,
                           bos=max(cfg.eos_token_id - 1, 0), eos=cfg.eos_token_id)

    model.tokenizer = wrap_tokenizer(model.tokenizer, model.te_config)
    model.tokenizer_2 = wrap_tokenizer(model.tokenizer_2, model.te2_config)
    step_cfg = SDStepConfig.from_train_config(
        config, model.prediction_type, model.text_encoder_layer_skip)
    step_cfg = SDStepConfig(**{
        **step_cfg.__dict__,
        "vae_scaling_factor": model.vae_config.scaling_factor,
        "train_text_encoder": (config.train_text_encoder_or_embedding()
                               or config.train_text_encoder_2_or_embedding()),
    })
    setup = SDXLSetup(model=model, config=config, tokenizer=model.tokenizer,
                      tokenizer_2=model.tokenizer_2, step_cfg=step_cfg)
    if method != TrainingMethod.LORA:
        return setup
    if config.lora_model_name:
        raise NotImplementedError("continuing from a LoRA file is not ported yet")

    peft_cfg = PeftConfig.from_train_config(config)
    if peft_cfg.weight_dtype != torch.float32:
        # the reference rounds the updates of bf16 LoRA weights stochastically
        # (ops/pallas_sr.py, not ported); fp32 updates need no rounding
        raise NotImplementedError(
            f"{peft_cfg.weight_dtype} LoRA weights are not ported yet (fp32 only)")
    parts = {"unet_lora": config.unet, "te_lora": config.text_encoder,
             "te2_lora": config.text_encoder_2}
    modules = model.modules()
    for module in modules.values():
        module.requires_grad_(False)
    trainable, group_schedules = {}, {}
    for group, (attr, key_map, seed) in _LORA_GROUPS.items():
        part = parts[group]
        if not part.train:
            continue
        module = modules[attr]
        gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
        adapters = init_peft_params(gen, module, peft_cfg, key_map)
        for entry in adapters.values():
            for tensor in entry.values():
                tensor.requires_grad_()
        attach_peft(module, adapters, peft_cfg, key_map)
        trainable[group] = adapters
        group_schedules[group] = _group_schedule(
            config, part.learning_rate, total_steps, part, steps_per_epoch)

    tx = create_group_optimizer(group_schedules, config.optimizer.optimizer,
                                config.optimizer, config.clip_grad_norm)
    setup.peft_cfg = peft_cfg
    setup.trainable = trainable
    setup.tx = tx
    setup.group_schedules = group_schedules
    setup.train_step = make_sdxl_train_step(model, step_cfg, tx)
    setup.state = create_train_state(trainable, tx)
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

    @torch.no_grad()
    def encode_images(images) -> dict:
        mean, logvar = model.vae.encode(torch.as_tensor(images, device=device))
        return {"latent_image": mean.float(), "latent_logvar": logvar.float()}

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
