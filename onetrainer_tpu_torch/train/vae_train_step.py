"""The SD VAE fine-tune step: decode the cached latent into pixels and fit
them to the original image.

Counterpart of onetrainer_tpu/train/vae_train_step.py (reference:
modules/modelSetup/StableDiffusionFineTuneVaeSetup.py:68-101): the cached
latent distribution sampled once per step (mean + std * noise, the
logvar clamped to [-30, 20]), decoded by the trained VAE, and held by the
loss stack (`diffusion_losses` without a noise schedule: no SNR
weighting) to the batch's original pixels `batch["image"]` (NHWC in
[-1, 1], the data loader's pixel cache). The backward, clip, update (K5
for a bf16 VAE under stochastic rounding) and EMA are the SD family's
shared step (train/sd_train_step.py:make_train_step).
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.math.losses import diffusion_losses
from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, make_train_step


def vae_predict(model, batch: dict, generator: torch.Generator, cfg: SDStepConfig,
                coefficients=None, *, latent_noise=None) -> dict:
    """The decoded latent beside its target pixels; `latent_noise` replaces
    the generator's draw that samples the cached latent distribution."""
    latent = batch["latent_image"]
    if "latent_logvar" in batch:
        std = torch.exp(0.5 * torch.clamp(batch["latent_logvar"], -30.0, 20.0))
        if latent_noise is None:
            latent_noise = torch.randn(latent.shape, generator=generator,
                                       device=latent.device, dtype=latent.dtype)
        latent = latent + std * torch.as_tensor(latent_noise, device=latent.device)
    return {
        "loss_type": "target",
        "predicted": model.vae.decode(latent),
        "target": batch["image"],
        "prediction_type": "epsilon",
    }


def make_vae_train_step(model, cfg: SDStepConfig, tx):
    """The FINE_TUNE_VAE step over the trainable group {"vae": the VAE's
    parameters} (train/sd_train_step.py:make_train_step)."""
    def losses(batch, data):
        return diffusion_losses(batch, data, cfg.loss, None)

    return make_train_step(model, cfg, tx, vae_predict, losses=losses)
