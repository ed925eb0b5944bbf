"""The Sana training step: discrete-timestep flow matching with Gemma-2
conditioning under its keep mask.

Counterpart of onetrainer_tpu/train/sana_train_step.py (reference:
modules/modelSetup/BaseSanaSetup.py:159-233): `sana_text_conditioning`
(the cached Gemma states and their mask, or Gemma on the batch's tokens
with its trained rows, the state `layer_skip` layers before the last, a
skipped state through the final norm, output embeddings patched in),
`sana_predict` (the DC-AE latents scaled; t drawn from the discrete
timesteps, sigma = (t + 1) / T, x_t = sigma * noise + (1 - sigma) * x_0 in
fp32; conditioning dropout zeroing a sample's states and its mask; the
flow target noise - x_0) and `make_sana_train_step`, the SD family's
shared step (train/sd_train_step.py:make_train_step) with the
flow-matching losses; bf16 trainable tensors take K5 under stochastic
rounding.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.math.losses import flow_matching_losses
from onetrainer_tpu_torch.math.noise import create_noise
from onetrainer_tpu_torch.math.timesteps import sample_timesteps_discrete
from onetrainer_tpu_torch.models.gemma import apply_gemma_final_norm, encode_gemma_text
from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, dropout_masks, extra_rows, keep_samples, make_train_step,
    output_embedding_scatter,
)


def sana_text_conditioning(model, batch: dict, layer_skip: int,
                           output_embedding_base_id: int = 0):
    """-> (Gemma states [B, S, 2304], their keep mask [B, S] or None)."""
    if "text_encoder_hidden_state" in batch:
        return batch["text_encoder_hidden_state"], batch.get("tokens_mask")
    mask = batch.get("tokens_mask")
    out = model.text_encoder(batch["tokens"], mask, extra_rows(batch, 0))
    hidden = encode_gemma_text(out, layer_skip)
    if layer_skip > 0:
        hidden = apply_gemma_final_norm(model.text_encoder, hidden)
    hidden = output_embedding_scatter(hidden, batch, "tokens", "", output_embedding_base_id)
    return hidden, mask


def sana_predict(model, batch: dict, generator: torch.Generator, cfg: SDStepConfig,
                 coefficients=None, *, timestep=None, noise=None,
                 dropout_keep=None) -> dict:
    """Draw t and noise, interpolate to x_t and predict the flow. `timestep`
    (ints in [0, T)), `noise` and `dropout_keep` (a 1-tuple: Gemma's keep
    mask) replace the generator's draws when given; `coefficients` is
    unused (flow matching has no noise schedule)."""
    scaled = batch["latent_image"] * cfg.vae_scaling_factor
    device = scaled.device
    b = scaled.shape[0]
    if timestep is None:
        timestep = sample_timesteps_discrete(generator, b, cfg.timestep,
                                             num_train_timesteps=cfg.num_train_timesteps)
    timestep = torch.as_tensor(timestep, device=device).to(torch.int32)
    sigma = (timestep.float() + 1.0) / cfg.num_train_timesteps
    if noise is None:
        noise = create_noise(generator, tuple(scaled.shape), scaled.dtype,
                             cfg.offset_noise_weight, cfg.perturbation_noise_weight)
    noise = torch.as_tensor(noise, device=device).to(scaled.dtype)
    s = sigma.reshape(-1, 1, 1, 1)
    noisy = (noise.float() * s + scaled.float() * (1.0 - s)).to(scaled.dtype)

    context, mask = sana_text_conditioning(model, batch, cfg.text_encoder_layer_skip,
                                           cfg.output_embedding_base_id)
    (keep,) = dropout_keep if dropout_keep is not None else dropout_masks(cfg, generator, b, 1)
    context = keep_samples(context, keep)
    if mask is not None and keep is not None:
        mask = mask * keep[:, None].to(device=mask.device, dtype=mask.dtype)

    dit_in = noisy
    if "latent_conditioning_image" in batch:
        dit_in = torch.cat([noisy, batch["latent_mask"].to(noisy.dtype),
                            batch["latent_conditioning_image"] * cfg.vae_scaling_factor],
                           dim=-1)
    predicted = model.transformer(dit_in, timestep, context, mask)
    return {
        "loss_type": "target",
        "predicted": predicted,
        "target": noise.float() - scaled.float(),
        "timestep": timestep,
        "scaled_latent_image": scaled,
        "noisy_latent_image": noisy,
    }


def make_sana_train_step(model, cfg: SDStepConfig, tx, rank_dropout=None, embeddings=None):
    """The Sana LoRA, FINE_TUNE or EMBEDDING step (see
    train/sd_train_step.py:make_train_step) with the flow-matching losses."""
    return make_train_step(
        model, cfg, tx, sana_predict,
        losses=lambda batch, data: flow_matching_losses(batch, data, cfg.loss,
                                                        cfg.num_train_timesteps),
        rank_dropout=rank_dropout, embeddings=embeddings)
