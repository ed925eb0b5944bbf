"""The FLUX training step: rectified flow with µ-shifted continuous
timesteps, 2x2 latent packing and the guidance embedding.

Counterpart of onetrainer_tpu/train/flux_train_step.py (reference:
modules/modelSetup/BaseFluxSetup.py:263-313): `flux_text_conditioning`
(the cached T5 states and pooled CLIP embedding, or CLIP-L and T5 run on
the batch's tokens), `flux_predict` (the cached latent distribution
sampled, shifted and scaled; t in (0, 1] from 10000 buckets, µ-shifted by
the latent size when dynamic shifting is on; x_t = t * noise + (1 - t) *
x_0 in fp32; per-encoder conditioning dropout; packing, image ids, the
guidance `config.prior.guidance_scale`; the target noise - x_0) and
`make_flux_train_step` (LoRA, FINE_TUNE or EMBEDDING; output embeddings
patch T5's states only, as the reference's). A FLUX.1-fill batch (`latent_conditioning_image`
and the 64-channel `latent_mask`) packs the transformer's input as [noisy
(64) | (conditioning - shift) * scale (64) | 8x8-shuffled mask (256)]. The
loss, backward, clip, update and EMA are the SD family's shared step
(train/sd_train_step.py:make_train_step) with the flow-matching losses.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from onetrainer_tpu_torch.math.losses import flow_matching_losses
from onetrainer_tpu_torch.math.noise import create_noise
from onetrainer_tpu_torch.math.timesteps import flux_mu_shift, sample_timesteps_continuous
from onetrainer_tpu_torch.models.flux import (
    pack_latents, prepare_latent_image_ids, unpack_latents,
)
from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, dropout_masks, extra_rows, keep_samples, make_train_step,
    output_embedding_scatter,
)


def flux_text_conditioning(model, batch: dict, cfg: SDStepConfig | None = None):
    """-> (T5 sequence states [B, S, 4096], CLIP pooled [B, 768]): the
    cached states when the batch carries both, else CLIP-L (with any LoRA
    adapters attached) and T5 at its layer skip on the batch's tokens, each
    with its trained embedding rows, T5's output embeddings patched in (the
    reference's flux_train_step.py:30-55)."""
    if "t5_hidden_state" in batch and "clip_pooled_state" in batch:
        return batch["t5_hidden_state"], batch["clip_pooled_state"]
    pooled = model.text_encoder(batch["tokens"], None, extra_rows(batch, 0))["pooled_output"]
    t5_states = model.text_encoder_2(
        batch["tokens_2"], extra_rows(batch, 1),
        layer_skip=cfg.te2_layer_skip if cfg is not None else 0)
    if cfg is not None:
        t5_states = output_embedding_scatter(t5_states, batch, "tokens_2", "_2",
                                             cfg.output_embedding_base_id_2)
    return t5_states, pooled


def flux_predict(model, batch: dict, generator: torch.Generator, cfg: SDStepConfig,
                 coefficients=None, *, guidance_scale: float = 1.0, timestep=None,
                 noise=None, latent_noise=None, dropout_keep=None) -> dict:
    """Sample the cached latent distribution, shift and scale it, draw t and
    noise, interpolate to x_t and predict the velocity. `timestep` (t in
    (0, 1]), `noise`, `latent_noise` and `dropout_keep` (the CLIP and T5
    keep masks) replace the generator's draws when given; `coefficients` is
    unused (flow matching has no noise schedule)."""
    latent = batch["latent_image"]
    device = latent.device
    if "latent_logvar" in batch:
        std = torch.exp(0.5 * torch.clamp(batch["latent_logvar"], -30.0, 20.0))
        if latent_noise is None:
            latent_noise = torch.randn(latent.shape, generator=generator, device=device,
                                       dtype=latent.dtype)
        latent = latent + std * torch.as_tensor(latent_noise, device=device)
    scaled = (latent - cfg.vae_shift_factor) * cfg.vae_scaling_factor
    b, h, w, _ = scaled.shape

    if timestep is None:
        tcfg = cfg.timestep
        if tcfg.dynamic_timestep_shifting:   # the latent size's µ replaces the shift
            tcfg = replace(tcfg, dynamic_timestep_shifting=False,
                           timestep_shift=flux_mu_shift(w, h))
        timestep = sample_timesteps_continuous(generator, b, tcfg)
    t = torch.as_tensor(timestep, device=device).to(torch.float32)
    if noise is None:
        noise = create_noise(generator, tuple(scaled.shape), scaled.dtype,
                             cfg.offset_noise_weight, cfg.perturbation_noise_weight)
    noise = torch.as_tensor(noise, device=device).to(scaled.dtype)
    sigma = t.reshape(-1, 1, 1, 1)
    noisy = (noise.float() * sigma + scaled.float() * (1.0 - sigma)).to(scaled.dtype)

    t5_states, pooled = flux_text_conditioning(model, batch, cfg)
    # CLIP-L pooled, T5 sequence (reference: FluxModel.py:286-296)
    m_clip, m_t5 = dropout_keep if dropout_keep is not None else \
        dropout_masks(cfg, generator, b, 2)
    pooled, t5_states = keep_samples(pooled, m_clip), keep_samples(t5_states, m_t5)

    packed = pack_latents(noisy)
    if "latent_conditioning_image" in batch:
        cond = (batch["latent_conditioning_image"] - cfg.vae_shift_factor) \
            * cfg.vae_scaling_factor
        packed = torch.cat([packed, pack_latents(cond.to(packed.dtype)),
                            pack_latents(batch["latent_mask"].to(packed.dtype))], dim=-1)
    img_ids = prepare_latent_image_ids(h, w, device)
    guidance = torch.full((b,), guidance_scale, dtype=torch.float32, device=device)
    predicted = model.transformer(packed, t, pooled, t5_states, img_ids, None, guidance)
    return {
        "loss_type": "target",
        "predicted": unpack_latents(predicted, h, w),
        "target": noise.float() - scaled.float(),
        "timestep": torch.clamp((t * 1000).to(torch.int32) - 1, 0, 999),
        "scaled_latent_image": scaled,
        "noisy_latent_image": noisy,
    }


def make_flux_train_step(model, cfg: SDStepConfig, tx, guidance_scale: float = 1.0,
                         rank_dropout=None, embeddings=None):
    """The FLUX LoRA, FINE_TUNE or EMBEDDING step (train/sd_train_step.py:
    make_train_step with the flow-matching losses and the guidance
    `guidance_scale`): LoRA adapters, or the transformer's and CLIP-L's own
    parameters, CLIP-L and T5 then running in the step on the batch's
    tokens (the reference's flux_train_step.py:148-168)."""
    def predict(model, batch, generator, cfg, coefficients, **draws):
        return flux_predict(model, batch, generator, cfg, coefficients,
                            guidance_scale=guidance_scale, **draws)

    return make_train_step(model, cfg, tx, predict,
                           losses=lambda batch, data: flow_matching_losses(batch, data, cfg.loss),
                           rank_dropout=rank_dropout, embeddings=embeddings)
