"""The SDXL training step.

Counterpart of onetrainer_tpu/train/sdxl_train_step.py: SDXL conditioning
(concat(TE1 penultimate, TE2 penultimate) [B, 77, 2048] context, TE2
pooled text embeds, add_time_ids from the batch's crop metadata), noising,
the UNet forward and the target (reference: modules/modelSetup/
BaseStableDiffusionXLSetup.py:241-330). The loss, backward, clip and
update are the SD family's shared step for LoRA and FINE_TUNE
(train/sd_train_step.py:make_train_step).
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.math.schedules import DiffusionScheduleCoefficients
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, conditioning_dropout_mask, extra_rows, make_train_step, noise_latents,
    output_embedding_scatter, prediction_data, unet_input,
)


def sdxl_text_conditioning(model, batch: dict, layer_skip: int,
                           cfg: SDStepConfig | None = None,
                           generator: torch.Generator | None = None):
    """-> (context [B, S, 2048], pooled [B, 1280]): the cached hidden states
    when the batch carries both, else both text encoders on its tokens
    (with any LoRA adapters attached to them, and each encoder's trained
    embedding rows), each one's output embeddings patched in."""
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
    out1 = model.text_encoder(batch["tokens"], None, extra_rows(batch, 0))
    out2 = model.text_encoder_2(batch["tokens_2"], None, extra_rows(batch, 1))
    h1 = encode_clip_text(out1, layer_skip)
    h2 = encode_clip_text(out2, cfg.te2_layer_skip if cfg is not None else layer_skip)
    if cfg is not None:
        h1 = output_embedding_scatter(h1, batch, "tokens", "", cfg.output_embedding_base_id)
        h2 = output_embedding_scatter(h2, batch, "tokens_2", "_2",
                                      cfg.output_embedding_base_id_2)
    h1, h2, pooled = _te_dropout(h1, h2, out2["pooled_output"])
    return torch.cat([h1, h2], dim=-1), pooled


def sdxl_predict(model, batch: dict, generator: torch.Generator,
                 cfg: SDStepConfig, coefficients: DiffusionScheduleCoefficients,
                 *, timestep=None, noise=None, latent_noise=None) -> dict:
    """Noise the batch's latents and predict with the UNet; `timestep`,
    `noise` and `latent_noise` replace the generator's draws when given
    (train/sd_train_step.py:noise_latents)."""
    noised = noise_latents(batch, generator, cfg, coefficients, timestep=timestep,
                           noise=noise, latent_noise=latent_noise)
    context, pooled = sdxl_text_conditioning(
        model, batch, cfg.text_encoder_layer_skip, cfg, generator)
    add_time_ids = torch.cat([
        batch["original_resolution"].float(),
        batch["crop_offset"].float(),
        batch["crop_resolution"].float(),
    ], dim=-1)
    predicted = model.unet(unet_input(noised["noisy"], batch, cfg),
                           noised["timestep"], context, pooled, add_time_ids)
    return prediction_data(predicted, noised, cfg, coefficients)


def make_sdxl_train_step(model, cfg: SDStepConfig, tx, rank_dropout=None, embeddings=None):
    """The SDXL LoRA, FINE_TUNE or EMBEDDING step
    (train/sd_train_step.py:make_train_step)."""
    return make_train_step(model, cfg, tx, sdxl_predict, rank_dropout=rank_dropout,
                           embeddings=embeddings)
