"""SD 1.5/2.x model setup, and the setup pieces the SD-family setups share.

Counterpart of onetrainer_tpu/setup/sd_setup.py: prediction forcing, the
tokenizer wrap, the LoRA and FINE_TUNE training branches of
`create_sd_setup` (LoRA: UNet and text-encoder adapters seeded 0 and 1;
FINE_TUNE: the UNet's and the text encoder's own parameters, each when
its part trains; per-group schedules, the clipped optimizer, wrapped for
gradient accumulation, the train step, the EMA), `merged_inference_params`,
`make_encode_fns` for latent and text-embedding caching, and the
per-group learning-rate schedules `_lr_scale`, `_stop_step` and
`_group_schedule` (reference: modules/util/NamedParameterGroup.py,
modules/util/create.py:1114-1232). Frozen parts whose weight dtype is
FLOAT_8, INT_8 or NFLOAT_4 are quantized after the adapters exist
(setup/quantize.py). A FINE_TUNE config that trains no part builds no
trainer (it serves sampling). `refuse_unported` raises for the training
methods, EMA held on the CPU, prior preservation and additional
embeddings; CUSTOM schedulers and schedule-free optimizers raise where
they are built. `setup_lora` continues from a LoRA file
(`lora_model_name`). `prepare_model`, `wrap_tokenizer`, `setup_lora`,
`setup_fine_tune` and `image_encoder` serve the SDXL, SD3, FLUX and
HunyuanVideo setups too.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.peft.lora import (
    PeftConfig, RankDropout, apply_lora_checkpoint, attach_peft, init_peft_params,
)
from onetrainer_tpu_torch.setup.quantize import quantize_frozen_parts
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer
from onetrainer_tpu_torch.train.lr_schedules import make_schedule, resolve_warmup_steps
from onetrainer_tpu_torch.train.optimizers import create_group_optimizer
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, make_sd_train_step
from onetrainer_tpu_torch.train.train_state import create_train_state
from onetrainer_tpu_torch.util.enums import (
    ConceptType, EMAMode, LearningRateScaler, LearningRateScheduler, TimeUnit,
    TrainingMethod,
)

# frozen part -> its ModelWeightDtypes attribute
_QUANTIZABLE = {"unet": "unet", "text_encoder": "text_encoder"}
# trainable LoRA group -> (model attribute and config part, adapter key
# map, init seed), as the reference's PRNGKeys
_LORA_GROUPS = {
    "unet_lora": ("unet", None, 0),
    "te_lora": ("text_encoder", clip_torch_key_map, 1),
}
# the kohya prefix of each LoRA group (the reference's setup/sd_setup.py:329-335)
LORA_PREFIXES = {"unet_lora": "lora_unet", "te_lora": "lora_te"}
# FINE_TUNE groups: the model attributes (and config parts) that may train
_FINE_TUNE_GROUPS = ("unet", "text_encoder")


def _lr_scale(config) -> float:
    """sqrt batch/accum LR scaling (reference:
    modules/util/NamedParameterGroup.py parameters_for_optimizer)."""
    scaler = config.learning_rate_scaler
    scale = 1.0
    if scaler in (LearningRateScaler.BATCH, LearningRateScaler.BOTH):
        scale *= config.batch_size ** 0.5
    if scaler in (LearningRateScaler.GRADIENT_ACCUMULATION, LearningRateScaler.BOTH):
        scale *= config.gradient_accumulation_steps ** 0.5
    return scale


def _stop_step(part, steps_per_epoch: int) -> int | None:
    """stop_training_after in optimizer steps."""
    if part.stop_training_after is None or \
            part.stop_training_after_unit == TimeUnit.NEVER:
        return None
    if part.stop_training_after_unit == TimeUnit.EPOCH:
        return int(part.stop_training_after * steps_per_epoch)
    if part.stop_training_after_unit == TimeUnit.STEP:
        return int(part.stop_training_after)
    return None


def _group_schedule(config, group_lr: float | None, total_steps: int,
                    part=None, steps_per_epoch: int = 1):
    """step -> learning rate of one param group."""
    base_lr = (group_lr if group_lr is not None else config.learning_rate)
    base_lr *= _lr_scale(config)
    scheduler = config.learning_rate_scheduler
    if config.optimizer.optimizer.is_schedule_free():
        raise NotImplementedError("schedule-free optimizers are not ported yet")
    if scheduler == LearningRateScheduler.CUSTOM:
        raise NotImplementedError("CUSTOM learning-rate schedulers are not ported yet")
    warmup = resolve_warmup_steps(config.learning_rate_warmup_steps, total_steps,
                                  config.gradient_accumulation_steps)
    schedule = make_schedule(scheduler, total_steps, warmup,
                             config.learning_rate_cycles,
                             config.learning_rate_min_factor, base_lr)
    stop = _stop_step(part, steps_per_epoch) if part is not None else None
    if stop is None:
        return schedule
    return lambda step: schedule(step) * float(step < stop)


def refuse_unported(config) -> None:
    """Raise NotImplementedError for what `config` asks of the model, its
    setup and its step that the port does not run: training methods other
    than LoRA and FINE_TUNE, EMA held on the CPU, prior preservation and
    additional embeddings. The setups call it first, and the trainer
    before it loads the model."""
    asked = {
        f"{config.training_method} training (LoRA and FINE_TUNE only)":
            config.training_method not in (TrainingMethod.LORA, TrainingMethod.FINE_TUNE),
        "EMA on the CPU": config.ema == EMAMode.CPU,
        "prior preservation": config.masked_prior_preservation_weight > 0 or any(
            c.type == ConceptType.PRIOR_PREDICTION for c in (config.concepts or [])),
        "additional embeddings": any(e.train for e in config.additional_embeddings),
    }
    unported = [what for what, on in asked.items() if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")


def prepare_model(model, config) -> None:
    """Prediction forcing (reference: StableDiffusionFineTuneSetup.py:80-86)."""
    if config.rescale_noise_scheduler_to_zero_terminal_snr:
        model.rescale_noise_scheduler_to_zero_terminal_snr()
        model.force_v_prediction()
    if config.force_v_prediction:
        model.force_v_prediction()
    if config.force_epsilon_prediction:
        model.force_epsilon_prediction()


def wrap_tokenizer(tok, te_config) -> SDTokenizer:
    """`tok` as an SDTokenizer at its text encoder's length and vocabulary."""
    if isinstance(tok, SDTokenizer):
        return tok
    return SDTokenizer(tok, max_length=te_config.max_position_embeddings,
                       vocab_size=te_config.vocab_size,
                       bos=max(te_config.eos_token_id - 1, 0), eos=te_config.eos_token_id)


def quantize_frozen(model, config, quantizable: dict, trained=()) -> None:
    """Quantize, in place, the model's parts outside `trained` whose
    configured weight dtype is quantized."""
    modules = model.modules()
    quantize_frozen_parts({k: modules[k] for k in quantizable if k not in trained},
                          config.weight_dtypes(), quantizable)


def setup_lora(model, config, lora_groups: dict, lora_prefixes: dict, quantizable: dict,
               total_steps: int, steps_per_epoch: int, parts: dict | None = None,
               peft_cfg: PeftConfig | None = None):
    """The LoRA branch of the SD-family setups: adapters (LoRA, DoRA or
    LoHa) for each group whose config part trains, drawn on the model's
    device from a generator seeded per group in the LoRA weight dtype;
    with `config.lora_model_name` the file's tensors replace them and its
    rank and alpha are adopted (peft/lora.py:apply_lora_checkpoint, with
    the family's kohya prefix of each group, `lora_prefixes`); then they
    are attached to the layers. The
    frozen base stops requiring grads, and frozen parts configured with a
    quantized weight dtype are quantized in place after the adapters exist
    (their shapes are the logical ones, as the reference's). `parts` names
    the config part of a model attribute where the two differ (SD3's and
    FLUX's transformer trains as `config.prior`); `peft_cfg` replaces the
    config's own (FLUX's layer presets).
    -> (peft_cfg, trainable, group_schedules, tx, rank_dropout): the
    last a `RankDropout` over the attached adapters for the step, None
    when the config drops no rank."""
    peft_cfg = peft_cfg or PeftConfig.from_train_config(config)
    modules = model.modules()
    for module in modules.values():
        module.requires_grad_(False)
    trainable, group_schedules = {}, {}
    for group, (attr, key_map, seed) in lora_groups.items():
        part = getattr(config, (parts or {}).get(attr, attr))
        if not part.train:
            continue
        module = modules[attr]
        gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
        trainable[group] = init_peft_params(gen, module, peft_cfg, key_map)
        group_schedules[group] = _group_schedule(
            config, part.learning_rate, total_steps, part, steps_per_epoch)
    if config.lora_model_name:
        peft_cfg = apply_lora_checkpoint(config.lora_model_name, trainable,
                                         lora_prefixes, peft_cfg)
    attached = {}
    for group, adapters in trainable.items():
        attr, key_map, _ = lora_groups[group]
        for entry in adapters.values():
            for tensor in entry.values():
                tensor.requires_grad_()
        attached[group] = attach_peft(modules[attr], adapters, peft_cfg, key_map)
    quantize_frozen(model, config, quantizable)
    rank_dropout = RankDropout(peft_cfg.dropout, attached) if peft_cfg.dropout > 0 else None
    return (peft_cfg, trainable, group_schedules, _optimizer(config, group_schedules),
            rank_dropout)


def _optimizer(config, group_schedules: dict):
    """The configured optimizer per group behind the global-norm clip,
    wrapped for gradient accumulation (the reference's optax chain,
    setup/sd_setup.py:406-411)."""
    clip = config.clip_grad_norm if (config.clip_grad_norm or 0) > 0 else None
    return create_group_optimizer(group_schedules, config.optimizer.optimizer,
                                  config.optimizer, clip,
                                  config.gradient_accumulation_steps)


def setup_fine_tune(model, config, groups: tuple, quantizable: dict,
                    total_steps: int, steps_per_epoch: int, parts: dict | None = None):
    """The FINE_TUNE branch of the SD-family setups: each part of `groups`
    whose config part trains becomes a group of its module's parameters,
    {diffusers name: parameter} in the module's order; every other part
    stops requiring grads and, when its weight dtype is quantized, is
    quantized in place. `parts` names the config part of a model attribute
    where the two differ (SD3's and FLUX's transformer trains as
    `config.prior`). -> (trainable, group_schedules, tx)."""
    modules = model.modules()
    trainable, group_schedules = {}, {}
    for name, module in modules.items():
        part = getattr(config, (parts or {}).get(name, name), None) if name in groups else None
        module.requires_grad_(bool(part is not None and part.train))
        if part is None or not part.train:
            continue
        trainable[name] = dict(module.named_parameters())
        group_schedules[name] = _group_schedule(
            config, part.learning_rate, total_steps, part, steps_per_epoch)
    quantize_frozen(model, config, quantizable, trained=list(trainable))
    return trainable, group_schedules, _optimizer(config, group_schedules)


def image_encoder(model):
    """`encode_images(images NHWC in [-1, 1])` -> {"latent_image",
    "latent_logvar"}, fp32 on the model's device: the data loader's
    latent cache."""
    device = next(model.vae.parameters()).device

    @torch.no_grad()
    def encode_images(images) -> dict:
        mean, logvar = model.vae.encode(torch.as_tensor(images, device=device))
        return {"latent_image": mean.float(), "latent_logvar": logvar.float()}

    return encode_images


@dataclass
class SDSetup:
    model: object                  # models.sd.StableDiffusionModel
    config: object
    tokenizer: SDTokenizer
    peft_cfg: PeftConfig | None = None
    step_cfg: SDStepConfig | None = None
    trainable: dict = field(default_factory=dict)
    tx: object = None
    train_step: object = None
    state: object = None
    group_schedules: dict = field(default_factory=dict)

    def merged_inference_params(self):
        """(unet, text_encoder, extra_embeddings) for sampling: the model's
        own modules. Under LoRA their layers carry the trained adapters and
        add the LoRA term in their forward, which equals sampling from
        merged weights without a merged copy of the base."""
        return self.model.unet, self.model.text_encoder, None


def create_sd_setup(model, config, total_steps: int = 10_000,
                    steps_per_epoch: int = 100) -> SDSetup:
    """Bind an SD 1.5/2.x `model` and `config`. For LoRA: adapters for the
    UNet and, when it trains, the text encoder (setup_lora); for FINE_TUNE:
    the UNet and the text encoder, each when it trains (setup_fine_tune);
    then the clipped optimizer, the train step and the train state (with
    an EMA when configured). A FINE_TUNE config that trains nothing builds
    no trainer (the setup serves sampling)."""
    refuse_unported(config)
    prepare_model(model, config)
    model.tokenizer = wrap_tokenizer(model.tokenizer, model.te_config)
    step_cfg = SDStepConfig.from_train_config(
        config, model.prediction_type, model.text_encoder_layer_skip)
    step_cfg = replace(step_cfg, vae_scaling_factor=model.vae_config.scaling_factor)
    setup = SDSetup(model=model, config=config, tokenizer=model.tokenizer,
                    step_cfg=step_cfg)
    rank_dropout = None
    if config.training_method == TrainingMethod.LORA:
        (setup.peft_cfg, setup.trainable, setup.group_schedules, setup.tx,
         rank_dropout) = setup_lora(model, config, _LORA_GROUPS, LORA_PREFIXES, _QUANTIZABLE,
                                    total_steps, steps_per_epoch)
    else:
        setup.trainable, setup.group_schedules, setup.tx = setup_fine_tune(
            model, config, _FINE_TUNE_GROUPS, _QUANTIZABLE, total_steps, steps_per_epoch)
        if not setup.trainable:
            return setup
    setup.train_step = make_sd_train_step(model, step_cfg, setup.tx, rank_dropout)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def make_encode_fns(setup: SDSetup):
    """(encode_images, encode_text) for the data loader's caches:
    `encode_images` as `image_encoder`; `encode_text(prompt)` -> tokens
    (int32 numpy), plus the text encoder's hidden state at the model's
    layer skip ([77, hidden] fp32 on the model's device) when the text
    encoder is frozen (cached text embeddings)."""
    model = setup.model
    encode_images = image_encoder(model)
    if setup.step_cfg.train_text_encoder:
        def encode_text(prompt: str) -> dict:
            return {"tokens": setup.tokenizer(prompt)}
        return encode_images, encode_text
    device = next(model.text_encoder.parameters()).device

    @torch.no_grad()
    def encode_text(prompt: str) -> dict:
        tokens = setup.tokenizer(prompt)
        out = model.text_encoder(torch.as_tensor(tokens[None], device=device))
        return {"tokens": tokens,
                "text_encoder_hidden_state": encode_clip_text(
                    out, setup.step_cfg.text_encoder_layer_skip)[0].float()}

    return encode_images, encode_text
