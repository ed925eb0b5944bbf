"""The Würstchen v2 / Stable Cascade prior training step.

Counterpart of onetrainer_tpu/train/wuerstchen_train_step.py (reference:
modules/modelSetup/BaseWuerstchenSetup.py:158-270): continuous-time epsilon
prediction in EfficientNet latent space. `wuerstchen_predict` scales v2's
latents to (x + 1) / 42 (Cascade's stay as they are), draws a continuous
timestep (math/timesteps.py) and warps it (v2 t * 1.08 + 0.001, Cascade
t + 0.001, both clipped to [0.001, 1]), noises under the warped cosine
alpha-bar, takes the cached text states (and Cascade's pooled projection)
or runs CLIP on the batch's tokens with its trained embedding rows
(Cascade: the picked hidden state and the pooled projection; v2: the
picked hidden state through the final LayerNorm), drops samples'
conditioning (`te_dropout`: v2 zeroes the states, Cascade the states and
the pooled projection), and runs the prior (Cascade with the pooled text
and a zero image embedding). `make_wuerstchen_train_step` is the shared
step (train/sd_train_step.py:make_train_step) with the diffusion losses
over `ContinuousCoefficients`' SNR (P2, min-SNR and debiased weightings
read it): LoRA, FINE_TUNE or EMBEDDING; bf16 trainable tensors take K5
under stochastic rounding. The sampler shares `wuerstchen_alpha_cumprod`.
"""

from __future__ import annotations

import math

import torch

from onetrainer_tpu_torch.math.losses import diffusion_losses
from onetrainer_tpu_torch.math.noise import create_noise
from onetrainer_tpu_torch.math.timesteps import sample_timesteps_continuous
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.models.layers import layer_norm
from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, conditioning_dropout_mask, extra_rows, keep_samples, make_train_step,
)


def wuerstchen_alpha_cumprod(t: torch.Tensor) -> torch.Tensor:
    """The warped cosine alpha-bar(t), t in [0, 1], fp32 (reference:
    BaseWuerstchenSetup.__alpha_cumprod:158-180)."""
    s = 0.008
    init = math.cos(s / (1 + s) * math.pi * 0.5) ** 2
    ac = torch.cos((t.float() + s) / (1 + s) * math.pi * 0.5) ** 2 / init
    return ac.clamp(0.0001, 0.9999)


class ContinuousCoefficients:
    """The SNR of a continuous timestep, for the loss weightings."""

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        ac = wuerstchen_alpha_cumprod(t)
        return ac / (1.0 - ac)


def warp_timestep(t: torch.Tensor, model_type) -> torch.Tensor:
    if model_type.is_wuerstchen_v2():
        return (t * 1.08 + 0.001).clamp(0.001, 1.0)
    return (t + 0.001).clamp(0.001, 1.0)


def final_layer_norm(text_encoder, hidden: torch.Tensor) -> torch.Tensor:
    """CLIP's final LayerNorm on a picked hidden state (fp32 statistics, the
    state's dtype out), as Würstchen v2 conditions on it (reference:
    WuerstchenModel.encode_text:243-248)."""
    return layer_norm(text_encoder.text_model.final_layer_norm, hidden, hidden.dtype)


def encode_wuerstchen_text(model, text_encoder, tokens: torch.Tensor, mask=None, extra=None,
                           layer_skip: int = 0):
    """-> (the text states, the pooled projection or None): Cascade the
    picked hidden state and CLIP-G's pooled projection; v2 the picked
    hidden state through the final LayerNorm."""
    out = text_encoder(tokens, mask, extra)
    hidden = encode_clip_text(out, layer_skip)
    if model.model_type.is_stable_cascade():
        return hidden, out["pooled_output"]
    return final_layer_norm(text_encoder, hidden), None


def wuerstchen_predict(model, batch: dict, generator: torch.Generator, cfg: SDStepConfig,
                       coefficients=None, *, timestep=None, noise=None,
                       dropout_keep=None) -> dict:
    """Noise the batch's effnet latents and predict eps with the prior.
    `timestep` (before the warp), `noise` and `dropout_keep` (a 1-tuple:
    the text encoder's keep mask) replace the generator's draws when given."""
    latent = batch["latent_image"]
    device = latent.device
    cascade = model.model_type.is_stable_cascade()
    scaled = latent if cascade else (latent + 1.0) / 42.0
    b = scaled.shape[0]

    t = sample_timesteps_continuous(generator, b, cfg.timestep) if timestep is None \
        else torch.as_tensor(timestep, device=device)
    t = warp_timestep(t.to(device=device, dtype=torch.float32), model.model_type)
    if noise is None:
        noise = create_noise(generator, tuple(scaled.shape), torch.float32,
                             cfg.offset_noise_weight, cfg.perturbation_noise_weight)
    noise = torch.as_tensor(noise, device=device).float()
    ac = wuerstchen_alpha_cumprod(t).reshape(-1, 1, 1, 1)
    noisy = ac.sqrt() * scaled.float() + (1.0 - ac).sqrt() * noise

    if "text_encoder_hidden_state" in batch and not cfg.train_text_encoder:
        context = batch["text_encoder_hidden_state"]
        pooled = batch.get("pooled_text_encoder_output")
    else:
        context, pooled = encode_wuerstchen_text(
            model, model.text_encoder, batch["tokens"], batch.get("tokens_mask"),
            extra_rows(batch, 0), cfg.text_encoder_layer_skip)

    if cfg.te_dropout > 0:
        (keep,) = dropout_keep if dropout_keep is not None else \
            (conditioning_dropout_mask(generator, b, cfg.te_dropout),)
        context = keep_samples(context, keep)
        if cascade:
            pooled = keep_samples(pooled, keep)

    if cascade:
        predicted = model.prior(noisy, t, context, pooled, None)
    else:
        predicted = model.prior(noisy, t, context)
    return {
        "loss_type": "target",
        "predicted": predicted,
        "target": noise,
        "timestep": t,
        "scaled_latent_image": scaled,
        "noisy_latent_image": noisy,
        "prediction_type": "epsilon",
    }


def make_wuerstchen_train_step(model, cfg: SDStepConfig, tx, rank_dropout=None,
                               embeddings=None):
    """The prior's LoRA, FINE_TUNE or EMBEDDING step (see
    train/sd_train_step.py:make_train_step), its losses the diffusion stack
    over the continuous timestep's SNR."""
    coefficients = ContinuousCoefficients()

    def losses(batch, data):
        return diffusion_losses(batch, data, cfg.loss, coefficients)

    return make_train_step(model, cfg, tx, wuerstchen_predict, losses=losses,
                           rank_dropout=rank_dropout, embeddings=embeddings)
