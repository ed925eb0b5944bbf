"""The PixArt training step: epsilon prediction with learned variance.

Counterpart of onetrainer_tpu/train/pixart_train_step.py (reference:
modules/modelSetup/BasePixArtAlphaSetup.py:200-233): `pixart_predict`
samples the cached latent distribution, scales it and noises it at a
discrete timestep (train/sd_train_step.py:noise_latents); takes the cached
T5 states, or runs T5 on the batch's tokens (`tokens_2`) with its trained
embedding rows and output embeddings patched in, at the step config's
layer skip (0: the reference's setup passes none); drops samples'
conditioning (`te_dropout`, zeroed states: the transformer takes no
caption mask, ROADMAP F21); feeds α-1024's micro-conditions from the
latent shape (resolution 8x the latent grid, aspect ratio h / w); and
splits the 8 output channels into the eps prediction and
`predicted_var_values`, which the loss stack's VB term trains
(math/losses.py:vb_losses). `make_pixart_train_step` is the SD family's
shared step (train/sd_train_step.py:make_train_step) with the diffusion
losses on the model's schedule: LoRA, FINE_TUNE or EMBEDDING; bf16
trainable tensors take K5 under stochastic rounding.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, dropout_masks, extra_rows, keep_samples, make_train_step, noise_latents,
    output_embedding_scatter,
)


def pixart_text_context(model, batch: dict, cfg: SDStepConfig) -> torch.Tensor:
    """-> the T5 states [B, S, 4096]: cached, or T5 (with its trained rows)
    on the batch's tokens at the step's layer skip, output embeddings
    patched in."""
    if "t5_hidden_state" in batch and not cfg.train_text_encoder:
        return batch["t5_hidden_state"]
    context = model.text_encoder(batch["tokens_2"], extra_rows(batch, 0),
                                 layer_skip=cfg.text_encoder_layer_skip)
    return output_embedding_scatter(context, batch, "tokens_2", "",
                                    cfg.output_embedding_base_id)


def pixart_predict(model, batch: dict, generator: torch.Generator, cfg: SDStepConfig,
                   coefficients, *, timestep=None, noise=None, latent_noise=None,
                   dropout_keep=None) -> dict:
    """Noise the batch's latents and predict eps and the variance values.
    `timestep`, `noise`, `latent_noise` and `dropout_keep` (a 1-tuple: T5's
    keep mask) replace the generator's draws when given."""
    noised = noise_latents(batch, generator, cfg, coefficients, timestep=timestep,
                           noise=noise, latent_noise=latent_noise)
    scaled, noisy = noised["scaled"], noised["noisy"]
    b, lh, lw, latent_ch = scaled.shape
    context = pixart_text_context(model, batch, cfg)
    (keep,) = dropout_keep if dropout_keep is not None else dropout_masks(cfg, generator, b, 1)
    context = keep_samples(context, keep)

    device = noisy.device
    resolution = torch.tensor([[lh * 8, lw * 8]], dtype=torch.float32,
                              device=device).expand(b, 2)
    aspect_ratio = torch.full((b, 1), float(lh) / float(lw), dtype=torch.float32,
                              device=device)
    out = model.transformer(noisy, noised["timestep"], context, resolution, aspect_ratio)
    return {
        "loss_type": "target",
        "predicted": out[..., :latent_ch],
        "predicted_var_values": out[..., latent_ch:],
        "target": noised["noise"].float(),
        "timestep": noised["timestep"],
        "scaled_latent_image": scaled,
        "noisy_latent_image": noisy,
        "prediction_type": "epsilon",
    }


def make_pixart_train_step(model, cfg: SDStepConfig, tx, rank_dropout=None, embeddings=None):
    """The PixArt LoRA, FINE_TUNE or EMBEDDING step (see
    train/sd_train_step.py:make_train_step), its losses the diffusion stack
    with the VB term on the model's noise schedule."""
    return make_train_step(model, cfg, tx, pixart_predict, rank_dropout=rank_dropout,
                           embeddings=embeddings)
