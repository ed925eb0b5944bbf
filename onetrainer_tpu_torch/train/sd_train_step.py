"""The SD 1.5/2.x training step, and the pieces every SD-family step shares.

Counterpart of onetrainer_tpu/train/sd_train_step.py: `SDStepConfig` (the
reference's field names and defaults, for the fields the port's steps
read), `conditioning_dropout_mask`, `sd_predict` (noising, the text
context cached or live, the UNet forward, the epsilon or v-prediction
target; reference: modules/modelSetup/BaseStableDiffusionSetup.py:135-310)
and `make_sd_train_step`.

Where the reference's step is a pure jitted function of an immutable
state, the port's steps update the trainable tensors, the optimizer state
and the EMA in place, draw their randomness from an explicit
`torch.Generator`, and run eagerly on the device the model lives on. LoRA,
FINE_TUNE and EMBEDDING (textual inversion: input and output embeddings,
`scatter_output_embeddings`, `preserve_input_embedding_norms`,
`normalize_output_embeddings`) are the ported methods; the VAE fine-tune
is train/vae_train_step.py. `make_train_step` is the loss,
backward, clip, update and EMA that the SD and SDXL steps share; each
family brings its own predict.

The optimizer returns its updates and the step adds them, as
optax.apply_updates does (a bf16 tensor rounds p + u to nearest). With
`stochastic_rounding` (the reference's `optimizer.stochastic_rounding`)
and bf16 trainable tensors, it adds them through
`ops/stochastic.py:apply_updates_stochastic` instead (K5 on the card, one
launch per update dtype over every bf16 tensor, one seed per tensor from
the step's generator); fp32 tensors add their update exactly either way,
so an fp32 run draws no seeds. Under gradient accumulation the
micro-steps between optimizer updates apply nothing (the reference adds
zero updates, which leave every tensor as it is).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from itertools import islice

import numpy as np
import torch

from onetrainer_tpu_torch.math.losses import LossConfig, diffusion_losses
from onetrainer_tpu_torch.math.noise import add_noise_discrete, create_noise
from onetrainer_tpu_torch.math.schedules import DiffusionScheduleCoefficients
from onetrainer_tpu_torch.math.timesteps import TimestepConfig, sample_timesteps_discrete
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.ops.stochastic import apply_updates_stochastic, draw_seeds
from onetrainer_tpu_torch.peft.lora import RankDropout
from onetrainer_tpu_torch.train.ema import maybe_update_ema
from onetrainer_tpu_torch.train.optimizers import (
    add_updates_, arithmetic_dtype, chunk_lengths, global_norm,
)
from onetrainer_tpu_torch.train.train_state import TrainState, leaves_like, param_groups
from onetrainer_tpu_torch.util.enums import EMAMode, TrainingMethod


@dataclass(frozen=True)
class SDStepConfig:
    """Static configuration of the train step."""
    training_method: TrainingMethod
    timestep: TimestepConfig
    loss: LossConfig
    offset_noise_weight: float = 0.0
    perturbation_noise_weight: float = 0.0
    vae_scaling_factor: float = 0.18215
    vae_shift_factor: float = 0.0
    prediction_type: str = "epsilon"
    text_encoder_layer_skip: int = 0
    train_text_encoder: bool = False
    num_train_timesteps: int = 1000
    te_dropout: float = 0.0
    te2_dropout: float = 0.0
    te3_dropout: float = 0.0
    te2_layer_skip: int = 0
    te3_layer_skip: int = 0
    stochastic_rounding: bool = False
    ema_decay: float = 0.0              # 0 = EMA off
    ema_update_interval: int = 1
    accum: int = 1                      # gradient accumulation micro-steps
    # output embeddings: trained vectors patched into a text encoder's
    # output at its placeholder positions, whose token ids (>= that
    # encoder's base id) index them; the spans are (start, count) per
    # embedding, the stds each one's initial per-row std, per encoder
    # (reference: BaseModel._apply_output_embeddings:119-143)
    output_embedding_base_id: int = 0
    output_embedding_base_id_2: int = 0
    output_embedding_base_id_3: int = 0
    output_embedding_spans: tuple = ()
    output_embedding_stds: tuple = ()
    output_embedding_stds_2: tuple = ()
    output_embedding_stds_3: tuple = ()
    # after each optimizer step, input embeddings renormalized to their
    # encoder table's median row norm, output embeddings to their initial
    # std (reference: after_optimizer_step, StableDiffusionEmbeddingSetup.py:90-92)
    preserve_embedding_norm: bool = False

    @staticmethod
    def from_train_config(config, prediction_type: str = "epsilon",
                          layer_skip: int = 0) -> "SDStepConfig":
        """The step's settings from a TrainConfig (the setups refuse what
        the port does not run first: setup/sd_setup.py:refuse_unported)."""

        def _part_dropout(name: str) -> float:
            part = getattr(config, name, None)
            return float(getattr(part, "dropout_probability", 0.0) or 0.0)

        return SDStepConfig(
            training_method=config.training_method,
            timestep=TimestepConfig.from_train_config(config),
            loss=LossConfig.from_train_config(
                config, v_prediction=prediction_type == "v_prediction"),
            offset_noise_weight=config.offset_noise_weight,
            perturbation_noise_weight=config.perturbation_noise_weight,
            prediction_type=prediction_type,
            text_encoder_layer_skip=layer_skip,
            train_text_encoder=config.train_text_encoder_or_embedding(),
            te_dropout=_part_dropout("text_encoder"),
            te2_dropout=_part_dropout("text_encoder_2"),
            te3_dropout=_part_dropout("text_encoder_3"),
            te2_layer_skip=int(getattr(config, "text_encoder_2_layer_skip", 0) or 0),
            te3_layer_skip=int(getattr(config, "text_encoder_3_layer_skip", 0) or 0),
            stochastic_rounding=config.optimizer.stochastic_rounding,
            ema_decay=config.ema_decay if config.ema != EMAMode.OFF else 0.0,
            ema_update_interval=config.ema_update_step_interval,
            accum=max(config.gradient_accumulation_steps, 1),
            preserve_embedding_norm=bool(config.preserve_embedding_norm),
        )


def conditioning_dropout_mask(generator: torch.Generator, batch_size: int,
                              p: float) -> torch.Tensor:
    """Per-sample keep mask for text-conditioning dropout: 0 with
    probability p, else 1 (fp32, on the generator's device)."""
    u = torch.rand((batch_size,), generator=generator, device=generator.device)
    return (u >= p).to(torch.float32)


def dropout_masks(cfg: SDStepConfig | None, generator: torch.Generator | None,
                  batch_size: int, encoders: int) -> tuple:
    """Keep masks of the first `encoders` text encoders' conditioning
    dropout (`te_dropout`, `te2_dropout`, `te3_dropout`), each None where
    that dropout is off or no generator draws (SD3's and FLUX's steps)."""
    if cfg is None or generator is None:
        return (None,) * encoders
    probabilities = (cfg.te_dropout, cfg.te2_dropout, cfg.te3_dropout)[:encoders]
    return tuple(conditioning_dropout_mask(generator, batch_size, p) if p > 0 else None
                 for p in probabilities)


def keep_samples(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """x [B, ...] with the samples `mask` [B] drops zeroed (None keeps all)."""
    if mask is None:
        return x
    return x * mask.reshape((-1,) + (1,) * (x.dim() - 1)).to(device=x.device, dtype=x.dtype)


# the text encoders' suffixes in group and batch keys: embeddings, embeddings_2, ...
ENCODER_SUFFIXES = ("", "_2", "_3")


def scatter_output_embeddings(hidden: torch.Tensor, tokens: torch.Tensor,
                              vectors: torch.Tensor, base_id: int) -> torch.Tensor:
    """Patch trained vectors into a text encoder's output [B, S, d] at the
    placeholder positions of `tokens` [B, S]: ids >= `base_id` take row
    id - base_id of `vectors` (reference: BaseModel._apply_output_embeddings:119-143)."""
    ids = tokens.long() - base_id
    gathered = vectors[ids.clamp(0, vectors.shape[0] - 1)]
    return torch.where((ids >= 0)[..., None], gathered.to(hidden.dtype), hidden)


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median of a 1-D tensor, the mean of the two middle values for an
    even count (as jnp.median; torch.median takes the lower one)."""
    s = x.sort().values
    n = s.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


@torch.no_grad()
def preserve_input_embedding_norms(params: dict, tables: dict, cfg: SDStepConfig) -> None:
    """preserve_embedding_norm for input embeddings, in place: each row of
    every `embeddings<suffix>` group L2-renormalized to the median row norm
    of that text encoder's token table `tables[suffix]` (reference:
    AdditionalEmbeddingWrapper.normalize_embeddings:69-75)."""
    if not cfg.preserve_embedding_norm:
        return
    for key, vec in params.items():
        table = tables.get(key[len("embeddings"):]) if key.startswith("embeddings") else None
        if table is None:
            continue
        median = _median(torch.linalg.vector_norm(table.float(), dim=-1))
        v = vec.float()
        norms = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        vec.copy_((v / norms.clamp(min=1e-12) * median).to(vec.dtype))


def normalize_output_embeddings(vectors: torch.Tensor, spans: tuple,
                                stds: tuple) -> torch.Tensor:
    """Each output embedding (a span of rows) rescaled back to its initial
    per-row std, fp32 (reference:
    ModelSetupEmbeddingMixin._normalize_output_embeddings:105-110)."""
    oe = vectors.float()
    segments = []
    for (start, count), orig in zip(spans, stds):
        seg = oe[start:start + count]
        std = seg.std(dim=1, correction=0).mean()
        segments.append(seg * (orig / (std + 1e-8)))
    return torch.cat(segments, 0)


@dataclass
class TrainedEmbeddings:
    """A setup's trained embedding vectors as its step reads them: `params`
    is the train state's groups (`embeddings<suffix>` input vectors and
    `output_embeddings<suffix>` output vectors, suffixes as in
    `ENCODER_SUFFIXES`), `suffixes` the model's text encoders in order,
    `inputs` {suffix: the frozen input rows of the output-embedding
    placeholders}, `tables` {suffix: a function giving that encoder's token
    table as it is now} (for `preserve_input_embedding_norms`)."""
    params: dict
    suffixes: tuple
    inputs: dict
    tables: dict
    cfg: SDStepConfig

    def extra(self, suffix: str) -> torch.Tensor | None:
        """The rows past the vocabulary of one text encoder: its trained
        input vectors, then the output placeholders' frozen rows."""
        rows = [t for t in (self.params.get(f"embeddings{suffix}"), self.inputs.get(suffix))
                if t is not None]
        if not rows:
            return None
        return torch.cat(rows, 0) if len(rows) > 1 else rows[0]

    def batch_entries(self) -> dict:
        """{"extra_embeddings": one row table (or None) per text encoder,
        "output_embeddings<suffix>": the output vectors} for a predict."""
        out = {"extra_embeddings": tuple(self.extra(s) for s in self.suffixes)}
        out.update({f"output_embeddings{s}": self.params[f"output_embeddings{s}"]
                    for s in self.suffixes if f"output_embeddings{s}" in self.params})
        return out

    @torch.no_grad()
    def after_update(self) -> None:
        """Under preserve_embedding_norm, after an optimizer step: each
        output embedding back to its initial std, each input embedding to
        its table's median norm, in place (the reference's
        onetrainer_tpu/train/sd_train_step.py:387-392)."""
        cfg = self.cfg
        if cfg.preserve_embedding_norm and cfg.output_embedding_spans:
            for suffix, stds in zip(ENCODER_SUFFIXES, (
                    cfg.output_embedding_stds, cfg.output_embedding_stds_2,
                    cfg.output_embedding_stds_3)):
                vec = self.params.get(f"output_embeddings{suffix}")
                if vec is not None and stds:
                    vec.copy_(normalize_output_embeddings(
                        vec, cfg.output_embedding_spans, stds).to(vec.dtype))
        if cfg.preserve_embedding_norm:
            preserve_input_embedding_norms(
                self.params, {s: table() for s, table in self.tables.items()}, cfg)


def output_embedding_scatter(hidden: torch.Tensor, batch: dict, tokens_key: str,
                             suffix: str, base_id: int, crop: int = 0) -> torch.Tensor:
    """`hidden` with the batch's output vectors of encoder `suffix` patched
    in at the placeholders of `batch[tokens_key]` (from position `crop`),
    or as it is when that encoder has none."""
    vectors = batch.get(f"output_embeddings{suffix}")
    if vectors is None:
        return hidden
    return scatter_output_embeddings(hidden, batch[tokens_key][:, crop:], vectors, base_id)


def extra_rows(batch: dict, index: int) -> torch.Tensor | None:
    """Text encoder `index`'s trained rows past its vocabulary in the batch
    (TrainedEmbeddings.batch_entries), or None."""
    extra = batch.get("extra_embeddings")
    return extra[index] if extra is not None and index < len(extra) else None


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def _coefficients_on(model, device: torch.device) -> DiffusionScheduleCoefficients:
    c = model.coefficients()
    return c._replace(**{name: value.to(device) for name, value in c._asdict().items()
                         if isinstance(value, torch.Tensor)})


def noise_latents(batch: dict, generator: torch.Generator, cfg: SDStepConfig,
                  coefficients: DiffusionScheduleCoefficients,
                  *, timestep=None, noise=None, latent_noise=None) -> dict:
    """Sample the cached latent distribution, scale it, draw timesteps and
    noise, and noise the latents. `timestep`, `noise` (the diffusion noise)
    and `latent_noise` (the draw that samples the cached latent
    distribution) replace the generator's draws when given. -> {"scaled",
    "timestep" int32, "noise", "noisy"}; latents are NHWC."""
    latent = batch["latent_image"]
    device = latent.device
    if "latent_logvar" in batch:
        std = torch.exp(0.5 * torch.clamp(batch["latent_logvar"], -30.0, 20.0))
        if latent_noise is None:
            latent_noise = torch.randn(latent.shape, generator=generator,
                                       device=device, dtype=latent.dtype)
        latent = latent + std * torch.as_tensor(latent_noise, device=device)
    scaled_latent = latent * cfg.vae_scaling_factor

    if timestep is None:
        timestep = sample_timesteps_discrete(
            generator, scaled_latent.shape[0], cfg.timestep,
            num_train_timesteps=cfg.num_train_timesteps)
    timestep = torch.as_tensor(timestep, device=device).to(torch.int32)
    if noise is None:
        noise = create_noise(generator, tuple(scaled_latent.shape),
                             scaled_latent.dtype, cfg.offset_noise_weight,
                             cfg.perturbation_noise_weight)
    noise = torch.as_tensor(noise, device=device).to(scaled_latent.dtype)
    noisy = add_noise_discrete(
        scaled_latent, noise, timestep, coefficients.sqrt_alphas_cumprod,
        coefficients.sqrt_one_minus_alphas_cumprod)
    return {"scaled": scaled_latent, "timestep": timestep, "noise": noise,
            "noisy": noisy}


def prediction_data(predicted: torch.Tensor, noised: dict, cfg: SDStepConfig,
                    coefficients: DiffusionScheduleCoefficients) -> dict:
    """The loss stack's input: the prediction beside its target (the noise,
    or v = sqrt(abar) eps - sqrt(1 - abar) x_0 under v-prediction)."""
    noise, scaled_latent, timestep = noised["noise"], noised["scaled"], noised["timestep"]
    if cfg.prediction_type == "v_prediction":
        t = timestep.long()
        sac = coefficients.sqrt_alphas_cumprod[t].reshape(-1, 1, 1, 1)
        somac = coefficients.sqrt_one_minus_alphas_cumprod[t].reshape(-1, 1, 1, 1)
        target = sac * noise.float() - somac * scaled_latent.float()
    else:
        target = noise.float()
    return {
        "loss_type": "target",
        "predicted": predicted,
        "target": target,
        "timestep": timestep,
        "scaled_latent_image": scaled_latent,
        "noisy_latent_image": noised["noisy"],
        "prediction_type": cfg.prediction_type,
    }


def unet_input(noisy: torch.Tensor, batch: dict, cfg: SDStepConfig) -> torch.Tensor:
    """The UNet's input: the noisy latents, with an inpainting batch's mask
    and scaled conditioning latents concatenated on channels."""
    if "latent_conditioning_image" not in batch:
        return noisy
    return torch.cat([
        noisy, batch["latent_mask"].to(noisy.dtype),
        batch["latent_conditioning_image"] * cfg.vae_scaling_factor,
    ], dim=-1)


def sd_text_context(model, batch: dict, cfg: SDStepConfig,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """-> context [B, 77, hidden]: the cached TE hidden state when the batch
    carries it and the text encoder is frozen, else the text encoder (with
    any LoRA adapters attached, and the batch's trained embedding rows) on
    the batch's tokens at the model's layer skip, its output embeddings
    patched in; then the per-sample conditioning dropout."""
    if "text_encoder_hidden_state" in batch and not cfg.train_text_encoder:
        context = batch["text_encoder_hidden_state"]
    else:
        out = model.text_encoder(batch["tokens"], None, extra_rows(batch, 0))
        context = encode_clip_text(out, cfg.text_encoder_layer_skip)
        context = output_embedding_scatter(context, batch, "tokens", "",
                                           cfg.output_embedding_base_id)
    if cfg.te_dropout > 0 and generator is not None:
        keep = conditioning_dropout_mask(generator, context.shape[0], cfg.te_dropout)
        context = context * keep[:, None, None].to(context.dtype)
    return context


def sd_predict(model, batch: dict, generator: torch.Generator,
               cfg: SDStepConfig, coefficients: DiffusionScheduleCoefficients,
               *, timestep=None, noise=None, latent_noise=None) -> dict:
    """Noise the batch's latents (`batch["latent_image"]` is the unscaled
    NHWC VAE latent) and predict with the UNet; the overrides as in
    `noise_latents`."""
    noised = noise_latents(batch, generator, cfg, coefficients, timestep=timestep,
                           noise=noise, latent_noise=latent_noise)
    context = sd_text_context(model, batch, cfg, generator)
    predicted = model.unet(unet_input(noised["noisy"], batch, cfg),
                           noised["timestep"], context)
    return prediction_data(predicted, noised, cfg, coefficients)


# elements of one chunk of the update: the optimizer's updates of that many
# elements exist at a time (8 GiB in bf16; FLUX's transformer is 11.9e9
# elements, three chunks), and K5 rounds each chunk in one launch
UPDATE_CHUNK_ELEMENTS = 1 << 32


def make_train_step(model, cfg: SDStepConfig, tx, predict, losses=None,
                    rank_dropout: RankDropout | None = None,
                    embeddings: TrainedEmbeddings | None = None):
    """The LoRA or FINE_TUNE step of `model` around its family's `predict`
    (`sd_predict`, `sdxl_predict`, `sd3_predict`) and per-sample `losses`
    (batch, data) -> [B] (default: `diffusion_losses` on the model's
    noise schedule): for LoRA the model's layers already carry the
    adapters (the setups attach them) and the trainable groups are adapter
    trees; for FINE_TUNE they are modules' parameters.

        train_step(state, batch, generator, *, round_bits=None, **draws)
            -> {"loss", "grad_norm"}

    `draws` replace the generator's draws of `predict` (`timestep`,
    `noise`, `latent_noise`; SD3's `dropout_keep` too). Under LoRA rank
    dropout (`rank_dropout`, from the LoRA setup) the step first draws
    each adapter group's keep masks from the generator
    (peft/lora.py:RankDropout.draw), or takes `rank_keep` {group:
    {module_key: mask}} in their place, and holds them on the layers'
    adapters through the forward and the backward. The step updates
    `state.params`, `state.opt_state` and `state.ema` in place and
    advances `state.step`; the returned loss (fp32, on the model's device:
    reading it synchronises) and pre-clip global norm of this micro-step's
    gradients (fp32 on the device; for bf16 tensors bf16 on the host, as
    optax computes it) are 0-dim tensors. After the optimizer update the
    EMA, when on, moves towards the trained tensors
    (train/ema.py:maybe_update_ema; the reference's
    onetrainer_tpu/train/sd_train_step.py:396-400). `round_bits`, shaped
    like `state.params`, gives the 16 random low bits of each bf16
    tensor's stochastic rounding in place of the generator's draws (CPU
    only). The update is made and applied in chunks of consecutive leaves
    of at most `UPDATE_CHUNK_ELEMENTS` elements (read when the step is
    made), each leaf's gradient freed once
    its update exists: the weights, the gradients and one chunk of
    updates are what the update holds at its peak. `train_step.loss(batch,
    generator, **draws)` is the step's loss alone, for a caller that wants
    its gradients without the update (and without rank dropout);
    `train_step.rank_dropout` is `rank_dropout`. With trained
    `embeddings` (EMBEDDING, or additional embeddings beside LoRA and
    FINE_TUNE) the loss hands the predict their rows and output vectors
    (`TrainedEmbeddings.batch_entries`: only the vectors take gradients,
    the frozen text encoders do not), and each step ends, before the EMA,
    with their norm preservation (`TrainedEmbeddings.after_update`)."""
    denoiser = next(iter(model.modules().values()))
    device = next(denoiser.parameters()).device
    chunk_elements = UPDATE_CHUNK_ELEMENTS
    coefficients = None
    if losses is None:
        coefficients = _coefficients_on(model, device)

        def losses(batch, data):
            return diffusion_losses(batch, data, cfg.loss, coefficients)

    def loss(batch: dict, generator: torch.Generator, **draws) -> torch.Tensor:
        batch = _on_device(batch, device)
        if embeddings is not None:
            batch = dict(batch, **embeddings.batch_entries())
        data = predict(model, batch, generator, cfg, coefficients, **draws)
        return losses(batch, data).mean()

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   *, round_bits=None, rank_keep=None, **draws) -> dict:
        groups = param_groups(state.params)
        flat = [t.requires_grad_() for g in groups.values() for t in g]
        if rank_dropout is not None and rank_keep is None and generator is not None:
            rank_keep = rank_dropout.draw(state.params, generator)
        with rank_dropout.masked(rank_keep) if rank_dropout is not None and rank_keep \
                else nullcontext():
            with torch.enable_grad():
                value = loss(batch, generator, **draws)
            # a tensor off the loss's path (TE1's last layer under layer
            # skip) gets a zero gradient, as under jax.grad
            grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
                flat, torch.autograd.grad(value, flat, allow_unused=True))]
        if any(t.dtype.itemsize == 1 for t in flat):   # fp8 leaves: fp32 gradients
            grads = [g.to(arithmetic_dtype(g.dtype)) for g in grads]
        norm = global_norm(grads)
        grouped, i = {}, 0
        for name, tensors in groups.items():
            grouped[name] = grads[i:i + len(tensors)]
            i += len(tensors)
        del grads
        apply_update(state, flat, tx.leaf_updates(groups, grouped, state.opt_state, norm),
                     grouped, generator, round_bits)
        if embeddings is not None:
            embeddings.after_update()
        if state.ema is not None and cfg.ema_decay > 0:
            maybe_update_ema(state.ema, state.params, cfg.ema_decay, state.step,
                             cfg.ema_update_interval, cfg.accum)
        state.step += 1
        return {"loss": value.detach(), "grad_norm": norm}

    @torch.no_grad()
    def apply_update(state, flat, leaf_updates, grouped, generator, round_bits) -> None:
        """Add the optimizer's updates to `flat` in chunks of consecutive
        leaves of at most `chunk_elements` elements (a larger leaf alone),
        each chunk's gradients and updates freed once it is applied; bf16
        leaves through K5 under stochastic rounding, one launch per chunk,
        on seeds drawn once for the whole update (so bitwise what one
        launch gives)."""
        rounding = cfg.stochastic_rounding and any(t.dtype == torch.bfloat16 for t in flat)
        bits = None if round_bits is None or not rounding \
            else leaves_like(round_bits, state.params)
        seeds = None
        where = [(name, j) for name, g in grouped.items() for j in range(len(g))]
        first = 0
        for n in chunk_lengths([t.numel() for t in flat], chunk_elements):
            chunk = list(islice(leaf_updates, n))
            if not chunk:   # a micro-step between updates: nothing to apply, no seeds
                return
            for name, j in where[first:first + n]:
                grouped[name][j] = None   # these leaves' gradients are spent
            params = flat[first:first + n]
            if not rounding:
                add_updates_(params, chunk)
            elif bits is not None:
                apply_updates_stochastic(params, chunk, bits=bits[first:])
            else:
                if seeds is None:
                    seeds = draw_seeds(len(flat), generator)
                apply_updates_stochastic(params, chunk, seeds=seeds, first=first)
            del chunk
            first += n
        next(leaf_updates, None)   # past the last leaf: MultiSteps resets its mean

    train_step.loss = loss
    train_step.rank_dropout = rank_dropout
    return train_step


def make_sd_train_step(model, cfg: SDStepConfig, tx, rank_dropout=None, embeddings=None):
    """The SD 1.5/2.x LoRA, FINE_TUNE or EMBEDDING step (see `make_train_step`)."""
    return make_train_step(model, cfg, tx, sd_predict, rank_dropout=rank_dropout,
                           embeddings=embeddings)
