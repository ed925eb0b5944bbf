"""SD 1.5/2.x model setup, and the setup pieces the SD-family setups share.

Counterpart of onetrainer_tpu/setup/sd_setup.py: prediction forcing, the
tokenizer wrap, the training branches of `create_sd_setup` (LoRA: UNet
and text-encoder adapters seeded 0 and 1; FINE_TUNE: the UNet's and the
text encoder's own parameters, each when its part trains; EMBEDDING: the
text encoder's input and output embedding vectors alone, which LoRA and
FINE_TUNE train too when the config has additional embeddings;
FINE_TUNE_VAE: the VAE's parameters; per-group schedules, the clipped
optimizer, wrapped for gradient accumulation, the train step, the EMA),
`merged_inference_params`, `make_encode_fns` for latent and
text-embedding caching, and the per-group learning-rate schedules
`_lr_scale`, `_stop_step` and `_group_schedule` (reference:
modules/util/NamedParameterGroup.py, modules/util/create.py:1114-1232).
The embedding vectors (`_embedding_table`, `_init_embedding_vectors`,
`_init_output_embeddings`, `_load_embedding_file`) start from the
tables' rows at the initial text's tokens, the text encoder's own output
for it, or an embedding file; `embedding_weight_dtype` is accepted and,
as in the reference, not applied (the vectors train in fp32). Frozen
parts whose weight dtype is FLOAT_8, INT_8 or NFLOAT_4 are quantized after
the adapters and vectors exist (setup/quantize.py). A FINE_TUNE config
that trains no part builds no trainer (it serves sampling).
`refuse_unported` raises for FINE_TUNE_VAE outside SD 1.5/2.x, EMA held
on the CPU and prior preservation. A schedule-free optimizer takes a
CONSTANT schedule without warmup, as the reference's. `setup_lora` continues from a LoRA
file (`lora_model_name`). `prepare_model`, `wrap_tokenizer`,
`setup_embeddings`, `setup_training`, `setup_lora`, `setup_fine_tune` and
`image_encoder` serve the SDXL, SD3, FLUX and HunyuanVideo setups too.
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
from onetrainer_tpu_torch.train.lr_schedules import (
    make_schedule, resolve_warmup_steps, tabulate_custom_schedule,
)
from onetrainer_tpu_torch.train.optimizers import create_group_optimizer
from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, TrainedEmbeddings, make_sd_train_step,
)
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
    # schedule-free optimizers carry their own schedule: the reference forces
    # CONSTANT and no warmup for them (modules/util/create.py:1139-1141,1227-1228)
    if config.optimizer.optimizer.is_schedule_free():
        scheduler, warmup = LearningRateScheduler.CONSTANT, 0
    else:
        warmup = resolve_warmup_steps(config.learning_rate_warmup_steps, total_steps,
                                      config.gradient_accumulation_steps)
    if scheduler == LearningRateScheduler.CUSTOM:
        schedule = tabulate_custom_schedule(
            config.custom_learning_rate_scheduler, config.scheduler_params, base_lr,
            config.learning_rate, total_steps, warmup, config.epochs, steps_per_epoch)
    else:
        schedule = make_schedule(scheduler, total_steps, warmup,
                                 config.learning_rate_cycles,
                                 config.learning_rate_min_factor, base_lr)
    stop = _stop_step(part, steps_per_epoch) if part is not None else None
    if stop is None:
        return schedule
    return lambda step: schedule(step) * float(step < stop)


def refuse_unported(config) -> None:
    """Raise NotImplementedError for what `config` asks of the model, its
    setup and its step that the port does not run: FINE_TUNE_VAE outside
    the SD 1.5/2.x families (as the reference's), EMA held on the CPU and
    prior preservation. The setups call it first, and the trainer before it
    loads the model."""
    asked = {
        f"{config.training_method} training of {config.model_type} (SD 1.5/2.x only)":
            config.training_method == TrainingMethod.FINE_TUNE_VAE
            and not config.model_type.is_stable_diffusion(),
        "EMA on the CPU": config.ema == EMAMode.CPU,
        "prior preservation": config.masked_prior_preservation_weight > 0 or any(
            c.type == ConceptType.PRIOR_PREDICTION for c in (config.concepts or [])),
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


def _embedding_table(te) -> torch.Tensor:
    """A text encoder's input-embedding table: CLIP's `token_embedding`,
    T5's `shared`, Llama's `embed_tokens`."""
    if hasattr(te, "text_model"):
        return te.text_model.embeddings.token_embedding.weight
    for name in ("shared", "embed_tokens"):
        if hasattr(te, name):
            return getattr(te, name).weight
    raise KeyError("no input embedding table in the text encoder")


def _table_rows(table: torch.Tensor, ids: list[int], count: int) -> torch.Tensor:
    """`count` rows of `table`, cycling through `ids`, fp32."""
    index = torch.as_tensor([ids[i % len(ids)] for i in range(count)], device=table.device)
    return table.detach()[index].float()


def _load_embedding_file(path: str, hidden: int) -> torch.Tensor | None:
    """A standalone embedding file's vectors [n, hidden] fp32 on the host
    (continuing training, or a fixed start): the `emp_params` or
    `string_to_param` tensor, else the file's one 2-D tensor `hidden` wide
    (reference: modules/modelLoader/mixin/EmbeddingLoaderMixin.py:14-68)."""
    if not path:
        return None
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    sd = load_safetensors(path)
    for key in ("emp_params", "string_to_param"):
        if key in sd:
            return sd[key].float()
    candidates = [v for v in sd.values() if v.dim() == 2 and v.shape[-1] == hidden]
    if len(candidates) == 1:
        return candidates[0].float()
    raise ValueError(f"could not find an embedding tensor in {path}")


@torch.no_grad()
def _init_embedding_vectors(te, tokenizer, config) -> tuple[torch.Tensor | None, dict]:
    """The trained input-embedding vectors of one text encoder, fp32 on its
    device: each input embedding's `token_count` rows of the encoder's
    table at the tokens of its `initial_embedding_text` (cycled; token 0
    when it has none), or its `model_name` file's vectors; each placeholder
    registered with the tokenizer. -> (vectors [n, hidden] or None, {uuid:
    (start, count)}) (reference: ModelSetupEmbeddingMixin.py:37-80)."""
    configs = [e for e in config.all_embedding_configs() if not e.is_output_embedding]
    if not configs:
        return None, {}
    table = _embedding_table(te)
    vectors, ids_map, offset = [], {}, 0
    for e in configs:
        count = e.token_count or 1
        init = _load_embedding_file(e.model_name, table.shape[-1])
        if init is not None:
            count = init.shape[0]
            init = init.to(table.device)
        else:
            init = _table_rows(table, tokenizer._encode_words(e.initial_embedding_text) or [0],
                               count)
        vectors.append(init)
        tokenizer.register_placeholder(e.placeholder, count)
        ids_map[e.uuid] = (offset, count)
        offset += count
    return torch.cat(vectors, 0), ids_map


@torch.no_grad()
def _init_output_embeddings(te, tokenizer, config, input_count: int, encode_fn=None,
                            start: int | None = None, compute_output: bool = True):
    """Output embeddings of one text encoder: trained vectors patched into
    its output at the placeholder positions, the placeholders' input rows
    frozen at their initial text's table rows (reference:
    BaseModel._apply_output_embeddings:119-143, ModelSetupEmbeddingMixin:37-110).
    The vectors start at the encoder's own output for the initial text
    (`encode_fn(tokens [1, S])` -> [1, S, d], else the encoder's last
    hidden state), from position `start` (default: past the BOS, where
    the tokenizer has one); `compute_output=False` registers the
    placeholders and their rows without running the encoder. The
    placeholders take the ids after the `input_count` input ones. ->
    (frozen input rows or None, output vectors or None, {uuid: (start,
    count)}, spans, the vectors' initial per-row stds)."""
    configs = [e for e in config.all_embedding_configs() if e.is_output_embedding]
    if not configs:
        return None, None, {}, (), ()
    table = _embedding_table(te)
    device = table.device
    input_rows, out_vectors, ids_map, spans, stds = [], [], {}, [], []
    offset = 0
    for e in configs:
        count = e.token_count or 1
        input_rows.append(_table_rows(
            table, tokenizer._encode_words(e.initial_embedding_text) or [0], count))
        if compute_output:
            tokens = torch.as_tensor(tokenizer(e.initial_embedding_text), device=device)[None]
            out = encode_fn(tokens) if encode_fn is not None else te(tokens)
            hidden = (out["last_hidden_state"] if isinstance(out, dict) else out)[0]
            s0 = start if start is not None else (1 if hasattr(tokenizer, "bos") else 0)
            vec = hidden[s0:s0 + count].float()
            out_vectors.append(vec)
            stds.append(float(vec.cpu().numpy().std(axis=1).mean()))
        tokenizer.register_placeholder(e.placeholder, count)
        ids_map[e.uuid] = (input_count + offset, count)
        spans.append((offset, count))
        offset += count
    return (torch.cat(input_rows, 0), torch.cat(out_vectors, 0) if out_vectors else None,
            ids_map, tuple(spans), tuple(stds))


@dataclass(frozen=True)
class EmbeddingEncoder:
    """One text encoder of a family for its trained embeddings: the suffix
    of its groups (train/sd_train_step.py:ENCODER_SUFFIXES), its module and
    tokenizer; `patch_output` whether output embeddings patch its output
    (else their placeholders only take frozen input rows), `encode_fn` and
    `start` as in `_init_output_embeddings`."""
    suffix: str
    module: object
    tokenizer: object
    patch_output: bool = True
    encode_fn: object = None
    start: int | None = None


@dataclass
class EmbeddingGroups:
    """What `setup_embeddings` made: the trained groups and their
    schedules, the frozen input rows of output placeholders and the text
    encoder modules per encoder suffix, the step config's output-embedding
    fields, and {uuid: (start, count)} of the first encoder's rows."""
    trainable: dict
    schedules: dict
    inputs: dict
    encoders: dict
    step_fields: dict
    ids: dict


def setup_embeddings(config, encoders: list, total_steps: int,
                     steps_per_epoch: int) -> EmbeddingGroups | None:
    """The trained embedding vectors of a setup (EMBEDDING, or additional
    embeddings beside LoRA and FINE_TUNE), over the family's text
    `encoders` (EmbeddingEncoder): every encoder's input vectors
    (`embeddings<suffix>`), then, over the same encoders, the output
    embeddings (`output_embeddings<suffix>` where the encoder's output is
    patched), each group at `embedding_learning_rate` (else the learning
    rate), as the reference's setups build them (sd_setup.py:338-357,
    sdxl_setup.py:131-166, sd3_setup.py:158-190, flux_setup.py:132-169,
    hunyuan_setup.py:119-159). Runs before the base is quantized, on the
    encoders' own weights. None when the config names no embedding, or,
    beside LoRA and FINE_TUNE, trains none (the reference's gate,
    sd_setup.py:389)."""
    if not config.all_embedding_configs() or (
            config.training_method != TrainingMethod.EMBEDDING
            and not (config.train_any_embedding() or config.train_any_output_embedding())):
        return None
    lr = config.embedding_learning_rate or config.learning_rate
    groups = EmbeddingGroups({}, {}, {}, {}, {}, {})
    counts = {}
    for enc in encoders:
        groups.encoders[enc.suffix] = enc.module
        vectors, ids = _init_embedding_vectors(enc.module, enc.tokenizer, config)
        counts[enc.suffix] = 0 if vectors is None else vectors.shape[0]
        if vectors is not None:
            groups.trainable[f"embeddings{enc.suffix}"] = vectors
            if enc.suffix == "":
                groups.ids.update(ids)
    for enc in encoders:
        inputs, vectors, ids, spans, stds = _init_output_embeddings(
            enc.module, enc.tokenizer, config, counts[enc.suffix], enc.encode_fn,
            enc.start, enc.patch_output)
        if inputs is None:
            continue
        groups.inputs[enc.suffix] = inputs
        if enc.suffix == "":
            groups.ids.update(ids)
            groups.step_fields["output_embedding_spans"] = spans
        if vectors is not None:
            groups.trainable[f"output_embeddings{enc.suffix}"] = vectors
            groups.step_fields[f"output_embedding_base_id{enc.suffix}"] = \
                _embedding_table(enc.module).shape[0] + counts[enc.suffix]
            groups.step_fields[f"output_embedding_stds{enc.suffix}"] = stds
    for name in groups.trainable:
        groups.schedules[name] = _group_schedule(config, lr, total_steps,
                                                 steps_per_epoch=steps_per_epoch)
    return groups


def trained_embeddings(groups: EmbeddingGroups | None, params: dict,
                       suffixes: tuple, step_cfg) -> TrainedEmbeddings | None:
    """The step's view of `setup_embeddings`' groups in the train state
    `params` (None without embeddings)."""
    if groups is None:
        return None
    tables = {suffix: (lambda te=te: _embedding_table(te))
              for suffix, te in groups.encoders.items()}
    return TrainedEmbeddings(params=params, suffixes=suffixes, inputs=groups.inputs,
                             tables=tables, cfg=step_cfg)


def embedding_step_fields(groups: EmbeddingGroups | None, train_text_encoder: bool) -> dict:
    """The step config's text fields: whether the text encoders run in the
    step (`train_text_encoder`, or any trained embeddings), and the output
    embeddings' base ids, spans and stds."""
    return {"train_text_encoder": train_text_encoder or groups is not None,
            **(groups.step_fields if groups is not None else {})}


def setup_embedding_only(model, config, groups: EmbeddingGroups | None, quantizable: dict):
    """The EMBEDDING branch of the SD-family setups: every part of the
    model frozen (and quantized where its weight dtype says so), only the
    vectors train. -> (trainable, group_schedules, tx)."""
    for module in model.modules().values():
        module.requires_grad_(False)
    quantize_frozen(model, config, quantizable)
    trainable = dict(groups.trainable) if groups is not None else {}
    schedules = dict(groups.schedules) if groups is not None else {}
    return trainable, schedules, _optimizer(config, schedules)


def setup_training(setup, groups: EmbeddingGroups | None, lora_groups: dict,
                   lora_prefixes: dict, fine_tune_groups: tuple, quantizable: dict,
                   total_steps: int, steps_per_epoch: int, parts: dict | None = None,
                   peft_cfg: PeftConfig | None = None):
    """The training branch of an SD-family setup by the config's method,
    each with the trained embedding `groups`: LoRA (`setup_lora`),
    EMBEDDING (`setup_embedding_only`) or FINE_TUNE (`setup_fine_tune`);
    fills `setup`'s peft_cfg, trainable, group_schedules and tx. ->
    (whether it trains anything, the LoRA rank dropout or None)."""
    model, config = setup.model, setup.config
    method = config.training_method
    rank_dropout = None
    if method == TrainingMethod.LORA:
        (setup.peft_cfg, setup.trainable, setup.group_schedules, setup.tx,
         rank_dropout) = setup_lora(model, config, lora_groups, lora_prefixes, quantizable,
                                    total_steps, steps_per_epoch, parts=parts,
                                    peft_cfg=peft_cfg, embeddings=groups)
    elif method == TrainingMethod.EMBEDDING:
        setup.trainable, setup.group_schedules, setup.tx = setup_embedding_only(
            model, config, groups, quantizable)
    else:
        setup.trainable, setup.group_schedules, setup.tx = setup_fine_tune(
            model, config, fine_tune_groups, quantizable, total_steps, steps_per_epoch,
            parts=parts, embeddings=groups)
    return bool(setup.trainable), rank_dropout


def quantize_frozen(model, config, quantizable: dict, trained=()) -> None:
    """Quantize, in place, the model's parts outside `trained` whose
    configured weight dtype is quantized."""
    modules = model.modules()
    quantize_frozen_parts({k: modules[k] for k in quantizable if k not in trained},
                          config.weight_dtypes(), quantizable)


def setup_lora(model, config, lora_groups: dict, lora_prefixes: dict, quantizable: dict,
               total_steps: int, steps_per_epoch: int, parts: dict | None = None,
               peft_cfg: PeftConfig | None = None,
               embeddings: EmbeddingGroups | None = None):
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
    config's own (FLUX's layer presets). `embeddings`
    (`setup_embeddings`) adds the trained embedding groups after the
    adapters'.
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
    if embeddings is not None:
        trainable.update(embeddings.trainable)
        group_schedules.update(embeddings.schedules)
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
                    total_steps: int, steps_per_epoch: int, parts: dict | None = None,
                    embeddings: EmbeddingGroups | None = None):
    """The FINE_TUNE branch of the SD-family setups: each part of `groups`
    whose config part trains becomes a group of its module's parameters,
    {diffusers name: parameter} in the module's order; every other part
    stops requiring grads and, when its weight dtype is quantized, is
    quantized in place. `parts` names the config part of a model attribute
    where the two differ (SD3's and FLUX's transformer trains as
    `config.prior`); `embeddings` (`setup_embeddings`) adds the trained
    embedding groups after them. -> (trainable, group_schedules, tx)."""
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
    if embeddings is not None:
        trainable.update(embeddings.trainable)
        group_schedules.update(embeddings.schedules)
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
    embeddings: TrainedEmbeddings | None = None
    embedding_ids: dict = field(default_factory=dict)   # uuid -> (start, count)

    def merged_inference_params(self):
        """(unet, text_encoder, extra_embeddings) for sampling: the model's
        own modules (under LoRA their layers carry the trained adapters and
        add the LoRA term in their forward, which equals sampling from
        merged weights without a merged copy of the base), and the text
        encoder's trained rows past its vocabulary (None without
        embeddings)."""
        return self.model.unet, self.model.text_encoder, inference_extra(self.embeddings, 0)


def inference_extra(embeddings: TrainedEmbeddings | None, index: int):
    """Text encoder `index`'s trained embedding rows for sampling, detached
    (None without embeddings)."""
    if embeddings is None or index >= len(embeddings.suffixes):
        return None
    extra = embeddings.extra(embeddings.suffixes[index])
    return None if extra is None else extra.detach()


def create_sd_setup(model, config, total_steps: int = 10_000,
                    steps_per_epoch: int = 100) -> SDSetup:
    """Bind an SD 1.5/2.x `model` and `config`. For LoRA: adapters for the
    UNet and, when it trains, the text encoder (setup_lora); for FINE_TUNE:
    the UNet and the text encoder, each when it trains (setup_fine_tune);
    for EMBEDDING: the text encoder's input and output embedding vectors
    alone (setup_embeddings), which LoRA and FINE_TUNE train too when the
    config has additional embeddings; for FINE_TUNE_VAE: the VAE's
    parameters, decoded against the original pixels
    (train/vae_train_step.py); then the clipped optimizer, the train step
    and the train state (with an EMA when configured). A FINE_TUNE config
    that trains nothing builds no trainer (the setup serves sampling)."""
    refuse_unported(config)
    prepare_model(model, config)
    model.tokenizer = wrap_tokenizer(model.tokenizer, model.te_config)
    method = config.training_method
    groups = None
    if method != TrainingMethod.FINE_TUNE_VAE:
        groups = setup_embeddings(
            config, [EmbeddingEncoder("", model.text_encoder, model.tokenizer)],
            total_steps, steps_per_epoch)
    step_cfg = SDStepConfig.from_train_config(
        config, model.prediction_type, model.text_encoder_layer_skip)
    step_cfg = replace(step_cfg, vae_scaling_factor=model.vae_config.scaling_factor,
                       **embedding_step_fields(groups, step_cfg.train_text_encoder))
    setup = SDSetup(model=model, config=config, tokenizer=model.tokenizer,
                    step_cfg=step_cfg, embedding_ids=groups.ids if groups else {})
    if method == TrainingMethod.FINE_TUNE_VAE:
        return _setup_vae_fine_tune(setup, total_steps, steps_per_epoch)
    trains, rank_dropout = setup_training(
        setup, groups, _LORA_GROUPS, LORA_PREFIXES, _FINE_TUNE_GROUPS, _QUANTIZABLE,
        total_steps, steps_per_epoch)
    if not trains:
        return setup
    setup.embeddings = trained_embeddings(groups, setup.trainable, ("",), step_cfg)
    setup.train_step = make_sd_train_step(model, step_cfg, setup.tx, rank_dropout,
                                          setup.embeddings)
    setup.state = create_train_state(setup.trainable, setup.tx,
                                     ema_enabled=config.ema != EMAMode.OFF)
    return setup


def _setup_vae_fine_tune(setup, total_steps: int, steps_per_epoch: int):
    """The FINE_TUNE_VAE branch of the SD setup: the VAE's
    parameters are the one group {"vae": {name: parameter}} at the `vae`
    part's learning rate, every other part frozen (and quantized where its
    weight dtype says so); the step decodes the cached latent against the
    original pixels, without masks or the VB loss (the reference's
    setup/sd_setup.py:360-369,431-438)."""
    from onetrainer_tpu_torch.train.vae_train_step import make_vae_train_step
    model, config = setup.model, setup.config
    for name, module in model.modules().items():
        module.requires_grad_(name == "vae")
    quantize_frozen(model, config, _QUANTIZABLE)
    setup.trainable = {"vae": dict(model.vae.named_parameters())}
    setup.group_schedules = {"vae": _group_schedule(
        config, config.vae.learning_rate, total_steps, config.vae, steps_per_epoch)}
    setup.tx = _optimizer(config, setup.group_schedules)
    setup.step_cfg = replace(setup.step_cfg, loss=replace(
        setup.step_cfg.loss, masked_training=False, vb_loss_strength=0.0))
    setup.train_step = make_vae_train_step(model, setup.step_cfg, setup.tx)
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
