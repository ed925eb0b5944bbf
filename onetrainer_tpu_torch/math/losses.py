"""The training loss stack, for the settings the port's slices use.

Counterpart of onetrainer_tpu/math/losses.py (reference:
modules/modelSetup/mixin/ModelSetupDiffusionLossMixin.py): MSE + MAE +
log-cosh per-sample losses, masked training (reference:
modules/util/loss/masked_loss.py), batch/accumulation loss scaling,
per-sample loss weights, and the timestep weightings (min-SNR-gamma,
debiased estimation, P2), the learned-variance VB term of PixArt
(`vb_losses`, the IDDPM variational bound; reference:
modules/util/loss/vb_loss.py), and the flow-matching losses of the
rectified-flow models (the SIGMA weighting). Prior preservation is not
ported and raises. Everything is fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from onetrainer_tpu_torch.math.schedules import DiffusionScheduleCoefficients
from onetrainer_tpu_torch.util.enums import LossScaler, LossWeight


@dataclass(frozen=True)
class LossConfig:
    mse_strength: float = 1.0
    mae_strength: float = 0.0
    log_cosh_strength: float = 0.0
    vb_loss_strength: float = 1.0
    loss_weight_fn: LossWeight = LossWeight.CONSTANT
    loss_weight_strength: float = 5.0
    loss_scaler: LossScaler = LossScaler.NONE
    batch_size: int = 1
    gradient_accumulation_steps: int = 1
    masked_training: bool = False
    raw_masked_training: bool = False
    unmasked_weight: float = 0.1
    normalize_masked_area_loss: bool = False
    masked_prior_preservation_weight: float = 0.0
    v_prediction: bool = False

    @staticmethod
    def from_train_config(config, v_prediction: bool = False) -> "LossConfig":
        return LossConfig(
            mse_strength=config.mse_strength,
            mae_strength=config.mae_strength,
            log_cosh_strength=config.log_cosh_strength,
            vb_loss_strength=config.vb_loss_strength,
            loss_weight_fn=config.loss_weight_fn,
            loss_weight_strength=config.loss_weight_strength,
            loss_scaler=config.loss_scaler,
            batch_size=config.batch_size,
            gradient_accumulation_steps=config.gradient_accumulation_steps,
            masked_training=config.masked_training and not config.model_type.has_conditioning_image_input(),
            raw_masked_training=config.masked_training,
            unmasked_weight=config.unmasked_weight,
            normalize_masked_area_loss=config.normalize_masked_area_loss,
            masked_prior_preservation_weight=config.masked_prior_preservation_weight,
            v_prediction=v_prediction,
        )


def log_cosh_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Numerically stable log(cosh(x)) = x + softplus(-2x) - log(2)."""
    diff = pred - target
    return diff + F.softplus(-2.0 * diff) - math.log(2.0)


def _spatial_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def masked_losses(losses: torch.Tensor, mask: torch.Tensor, unmasked_weight: float,
                  normalize_masked_area_loss: bool) -> torch.Tensor:
    """Elementwise losses weighted by the mask clamped to [unmasked_weight,
    1], divided by the clamped mask's per-sample mean when
    `normalize_masked_area_loss` (reference: masked_loss.py:5-19)."""
    clamped_mask = torch.clamp(mask, unmasked_weight, 1.0)
    losses = losses * clamped_mask
    if normalize_masked_area_loss:
        losses = losses / clamped_mask.mean(dim=tuple(range(1, clamped_mask.dim())),
                                            keepdim=True)
    return losses


# -- variational bound (IDDPM learned variance) -------------------------------

def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    res = table.to(t.device)[t.long()]
    return res.reshape(res.shape + (1,) * (ndim - res.dim()))


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (
        -1.0 + logvar2 - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def vb_losses(coefficients: DiffusionScheduleCoefficients, x_0: torch.Tensor,
              x_t: torch.Tensor, t: torch.Tensor, predicted_eps: torch.Tensor,
              predicted_var_values: torch.Tensor) -> torch.Tensor:
    """IDDPM variational bound for learned variance, elementwise, in bits:
    the KL between the true posterior q(x_{t-1} | x_t, x_0) and the
    predicted p(x_{t-1} | x_t), whose log variance interpolates between the
    posterior's and log beta_t by (v + 1) / 2, or at t = 0 the decoder's
    discretized Gaussian NLL. The eps prediction is detached, so the term
    trains the variance head alone."""
    ndim = x_t.dim()
    frozen_eps = predicted_eps.detach()
    c1 = _extract(coefficients.posterior_mean_coef1, t, ndim)
    c2 = _extract(coefficients.posterior_mean_coef2, t, ndim)
    true_mean = c1 * x_0 + c2 * x_t
    true_log_var = _extract(coefficients.posterior_log_variance_clipped, t, ndim)

    max_log = _extract(torch.log(coefficients.betas), t, ndim)
    frac = (predicted_var_values + 1.0) / 2.0
    predicted_log_var = frac * max_log + (1.0 - frac) * true_log_var

    predicted_x0 = (_extract(coefficients.sqrt_recip_alphas_cumprod, t, ndim) * x_t
                    - _extract(coefficients.sqrt_recipm1_alphas_cumprod, t, ndim) * frozen_eps)
    predicted_mean = c1 * predicted_x0 + c2 * x_t

    kl = normal_kl(true_mean, true_log_var, predicted_mean, predicted_log_var) / math.log(2.0)
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_0, predicted_mean, 0.5 * predicted_log_var) / math.log(2.0)
    t_b = t.reshape(t.shape + (1,) * (ndim - t.dim())).to(kl.device)
    return torch.where(t_b == 0, decoder_nll, kl)


def min_snr_weight(snr: torch.Tensor, gamma: float, v_prediction: bool) -> torch.Tensor:
    denom = snr + 1.0 if v_prediction else snr
    return torch.clamp(snr, max=gamma) / denom


def debiased_estimation_weight(snr: torch.Tensor, v_prediction: bool) -> torch.Tensor:
    weight = torch.clamp(snr, max=1.0e3)
    if v_prediction:
        weight = weight + 1.0
    return 1.0 / torch.sqrt(weight)


def p2_loss_weight(snr: torch.Tensor, gamma: float, v_prediction: bool) -> torch.Tensor:
    if v_prediction:
        snr = snr + 1.0
    return (1.0 + snr) ** -gamma


def _scale(cfg: LossConfig) -> float:
    batch_scale = 1 if cfg.loss_scaler in (LossScaler.NONE, LossScaler.GRADIENT_ACCUMULATION) else cfg.batch_size
    accum_scale = 1 if cfg.loss_scaler in (LossScaler.NONE, LossScaler.BATCH) else cfg.gradient_accumulation_steps
    return float(batch_scale * accum_scale)


def _weighted_stack(batch: dict, data: dict, cfg: LossConfig,
                    coefficients: DiffusionScheduleCoefficients | None = None) -> torch.Tensor:
    """Per-sample [B] sum of the enabled elementwise losses (each masked
    when `masked_training`), with `coefficients` the VB term of a
    prediction that carries `predicted_var_values`, the mask-input models'
    area normalization, the batch/accumulation scale and the per-sample
    loss weights: what the diffusion and flow-matching losses share."""
    mask = None
    if cfg.masked_training and "latent_mask" in batch:
        mask = batch["latent_mask"].float()
    predicted = data["predicted"].float()
    target = data["target"].float()
    losses = torch.zeros((predicted.shape[0],), dtype=torch.float32,
                         device=predicted.device)

    def accumulate(value: torch.Tensor, strength: float) -> torch.Tensor:
        if mask is not None:
            value = masked_losses(value, mask, cfg.unmasked_weight,
                                  cfg.normalize_masked_area_loss)
        return _spatial_mean(value) * strength

    if cfg.mse_strength != 0:
        losses = losses + accumulate((predicted - target) ** 2, cfg.mse_strength)
    if cfg.mae_strength != 0:
        losses = losses + accumulate((predicted - target).abs(), cfg.mae_strength)
    if cfg.log_cosh_strength != 0:
        losses = losses + accumulate(log_cosh_loss(predicted, target), cfg.log_cosh_strength)
    if cfg.vb_loss_strength != 0 and "predicted_var_values" in data \
            and coefficients is not None:
        vb = vb_losses(coefficients, data["scaled_latent_image"].float(),
                       data["noisy_latent_image"].float(), data["timestep"], predicted,
                       data["predicted_var_values"].float())
        losses = losses + accumulate(vb, cfg.vb_loss_strength)
    if mask is None and cfg.raw_masked_training and cfg.normalize_masked_area_loss \
            and "latent_mask" in batch:
        # the mask-input models' unmasked loss, normalized by the mask's area
        losses = losses / _spatial_mean(torch.clamp(batch["latent_mask"].float(),
                                                    cfg.unmasked_weight, 1.0))

    losses = losses * _scale(cfg)
    return losses * batch["loss_weight"].to(losses.dtype)


def diffusion_losses(
        batch: dict,
        data: dict,
        cfg: LossConfig,
        coefficients: DiffusionScheduleCoefficients | None,
) -> torch.Tensor:
    """Per-sample loss vector [B] for epsilon/v-prediction models; with
    `masked_training`, each elementwise loss weighted by the batch's latent
    mask (`masked_losses`). The SNR weightings apply; SIGMA leaves the loss
    unweighted. A prediction with `predicted_var_values` (PixArt's learned
    variance) adds the VB term at `vb_loss_strength`, masked as the others.
    A float timestep (Würstchen's continuous time) reaches
    `coefficients.snr` as it is, an integer one as an index."""
    if "prior_target" in data:
        raise NotImplementedError("prior preservation is not ported yet")

    losses = _weighted_stack(batch, data, cfg, coefficients)

    if "timestep" in data and coefficients is not None:
        t = data["timestep"]
        snr = coefficients.snr(t if t.is_floating_point() else t.long())
        if cfg.loss_weight_fn == LossWeight.MIN_SNR_GAMMA:
            losses = losses * min_snr_weight(snr, cfg.loss_weight_strength, cfg.v_prediction)
        elif cfg.loss_weight_fn == LossWeight.DEBIASED_ESTIMATION:
            losses = losses * debiased_estimation_weight(snr, cfg.v_prediction)
        elif cfg.loss_weight_fn == LossWeight.P2:
            losses = losses * p2_loss_weight(snr, cfg.loss_weight_strength, cfg.v_prediction)
        # SIGMA weights flow matching only: here the loss stays CONSTANT's,
        # as the reference's
    return losses


def flow_matching_losses(batch: dict, data: dict, cfg: LossConfig,
                         num_train_timesteps: int = 1000) -> torch.Tensor:
    """Per-sample loss vector [B] for rectified-flow models (reference:
    ModelSetupDiffusionLossMixin._flow_matching_losses): the same
    elementwise stack, masks, scale and loss weights, and the SIGMA
    weighting sigma = (t + 1) / num_train_timesteps; the SNR weightings do
    not apply to flow matching and are ignored, as the reference does."""
    if "prior_target" in data:
        raise NotImplementedError("prior preservation is not ported yet")
    losses = _weighted_stack(batch, data, cfg)
    if "timestep" in data and cfg.loss_weight_fn == LossWeight.SIGMA:
        sigmas = (data["timestep"].float() + 1.0) / num_train_timesteps
        losses = losses * sigmas
    return losses
