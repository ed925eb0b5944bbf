"""The SDXL training step.

Counterpart of onetrainer_tpu/train/sdxl_train_step.py: SDXL conditioning
(concat(TE1 penultimate, TE2 penultimate) [B, 77, 2048] context, TE2
pooled text embeds, add_time_ids from the batch's crop metadata), noising,
the UNet forward, the loss stack, the backward, the global-norm clip and
the optimizer update (reference: modules/modelSetup/
BaseStableDiffusionXLSetup.py:241-330).

Where the reference's step is a pure jitted function of an immutable
state, this one updates the trainable tensors and the optimizer state in
place, draws its randomness from an explicit `torch.Generator`, and runs
eagerly on the device the model lives on. LoRA is the ported method.
"""

from __future__ import annotations

import numpy as np
import torch

from onetrainer_tpu_torch.math.losses import diffusion_losses
from onetrainer_tpu_torch.math.noise import add_noise_discrete, create_noise
from onetrainer_tpu_torch.math.schedules import DiffusionScheduleCoefficients
from onetrainer_tpu_torch.math.timesteps import sample_timesteps_discrete
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.train.optimizers import global_norm
from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, conditioning_dropout_mask,
)
from onetrainer_tpu_torch.train.train_state import TrainState, param_groups
from onetrainer_tpu_torch.util.enums import TrainingMethod


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def sdxl_text_conditioning(model, batch: dict, layer_skip: int,
                           cfg: SDStepConfig | None = None,
                           generator: torch.Generator | None = None):
    """-> (context [B, S, 2048], pooled [B, 1280]): the cached hidden states
    when the batch carries both, else both text encoders on its tokens
    (with any LoRA adapters attached to them)."""
    def _te_dropout(h1, h2, pooled):
        # TE1 sequence, TE2 sequence + pooled share one mask each
        # (reference: StableDiffusionXLModel.py:273-284)
        if cfg is None or generator is None:
            return h1, h2, pooled
        b = h1.shape[0]
        if cfg.te_dropout > 0:
            m1 = conditioning_dropout_mask(generator, b, cfg.te_dropout)
            h1 = h1 * m1[:, None, None].to(h1.dtype)
        if cfg.te2_dropout > 0:
            m2 = conditioning_dropout_mask(generator, b, cfg.te2_dropout)
            h2 = h2 * m2[:, None, None].to(h2.dtype)
            pooled = pooled * m2[:, None].to(pooled.dtype)
        return h1, h2, pooled

    if "text_encoder_hidden_state" in batch and "text_encoder_2_hidden_state" in batch:
        h1, h2, pooled = _te_dropout(
            batch["text_encoder_hidden_state"],
            batch["text_encoder_2_hidden_state"],
            batch["text_encoder_2_pooled_state"])
        return torch.cat([h1, h2], dim=-1), pooled
    out1 = model.text_encoder(batch["tokens"])
    out2 = model.text_encoder_2(batch["tokens_2"])
    h1 = encode_clip_text(out1, layer_skip)
    h2 = encode_clip_text(out2, cfg.te2_layer_skip if cfg is not None else layer_skip)
    h1, h2, pooled = _te_dropout(h1, h2, out2["pooled_output"])
    return torch.cat([h1, h2], dim=-1), pooled


def sdxl_predict(model, batch: dict, generator: torch.Generator,
                 cfg: SDStepConfig, coefficients: DiffusionScheduleCoefficients,
                 *, timestep=None, noise=None, latent_noise=None) -> dict:
    """Noise the batch's latents and predict with the UNet. `timestep`,
    `noise` (the diffusion noise) and `latent_noise` (the draw that
    samples the cached latent distribution) replace the generator's draws
    when given."""
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

    context, pooled = sdxl_text_conditioning(
        model, batch, cfg.text_encoder_layer_skip, cfg, generator)
    add_time_ids = torch.cat([
        batch["original_resolution"].float(),
        batch["crop_offset"].float(),
        batch["crop_resolution"].float(),
    ], dim=-1)

    unet_in = noisy
    if "latent_conditioning_image" in batch:
        unet_in = torch.cat([
            noisy, batch["latent_mask"].to(noisy.dtype),
            batch["latent_conditioning_image"] * cfg.vae_scaling_factor,
        ], dim=-1)
    predicted = model.unet(unet_in, timestep, context, pooled, add_time_ids)

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
        "noisy_latent_image": noisy,
        "prediction_type": cfg.prediction_type,
    }


def _coefficients_on(model, device: torch.device) -> DiffusionScheduleCoefficients:
    c = model.coefficients()
    return c._replace(**{name: value.to(device) for name, value in c._asdict().items()
                         if isinstance(value, torch.Tensor)})


def make_sdxl_train_step(model, cfg: SDStepConfig, tx):
    """Build the step for LoRA training of `model`, whose layers already
    carry the adapters (setup/sdxl_setup.py attaches them).

        train_step(state, batch, generator, *, timestep=None, noise=None,
                   latent_noise=None) -> {"loss", "grad_norm"}

    The step updates `state.params` (the adapter tensors) and
    `state.opt_state` in place and advances `state.step`; the returned
    loss and pre-clip global gradient norm are 0-dim fp32 tensors on the
    model's device (reading them synchronises)."""
    if cfg.training_method != TrainingMethod.LORA:
        raise NotImplementedError(
            f"{cfg.training_method} training is not ported yet (LoRA only)")
    device = next(model.unet.parameters()).device
    coefficients = _coefficients_on(model, device)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   *, timestep=None, noise=None, latent_noise=None) -> dict:
        batch = _on_device(batch, device)
        groups = param_groups(state.params)
        flat = [t.requires_grad_() for g in groups.values() for t in g]
        with torch.enable_grad():
            data = sdxl_predict(model, batch, generator, cfg, coefficients,
                                timestep=timestep, noise=noise,
                                latent_noise=latent_noise)
            loss = diffusion_losses(batch, data, cfg.loss, coefficients).mean()
        # a layer off the loss's path (TE1's last layer under layer skip)
        # gets a zero gradient, as under jax.grad
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
            flat, torch.autograd.grad(loss, flat, allow_unused=True))]
        norm = global_norm(grads)
        grouped, i = {}, 0
        for name, tensors in groups.items():
            grouped[name] = grads[i:i + len(tensors)]
            i += len(tensors)
        tx.update_(groups, grouped, state.opt_state, norm)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": norm}

    return train_step
