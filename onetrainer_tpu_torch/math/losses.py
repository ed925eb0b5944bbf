"""The training loss stack, for the settings the port's slices use.

Counterpart of onetrainer_tpu/math/losses.py (reference:
modules/modelSetup/mixin/ModelSetupDiffusionLossMixin.py): MSE + MAE +
log-cosh per-sample losses, batch/accumulation loss scaling, per-sample
loss weights, and the timestep weightings (min-SNR-gamma, debiased
estimation, P2). Masked training, prior preservation and the learned-
variance VB term are not ported and raise. Everything is fp32.
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


def diffusion_losses(
        batch: dict,
        data: dict,
        cfg: LossConfig,
        coefficients: DiffusionScheduleCoefficients | None,
) -> torch.Tensor:
    """Per-sample loss vector [B] for epsilon/v-prediction models."""
    if "latent_mask" in batch and (cfg.masked_training or cfg.raw_masked_training):
        raise NotImplementedError("masked training is not ported yet")
    if "prior_target" in data:
        raise NotImplementedError("prior preservation is not ported yet")
    if cfg.vb_loss_strength != 0 and "predicted_var_values" in data:
        raise NotImplementedError("the learned-variance VB loss is not ported yet")

    predicted = data["predicted"].float()
    target = data["target"].float()
    losses = torch.zeros((predicted.shape[0],), dtype=torch.float32,
                         device=predicted.device)
    if cfg.mse_strength != 0:
        losses = losses + _spatial_mean((predicted - target) ** 2) * cfg.mse_strength
    if cfg.mae_strength != 0:
        losses = losses + _spatial_mean((predicted - target).abs()) * cfg.mae_strength
    if cfg.log_cosh_strength != 0:
        losses = losses + _spatial_mean(log_cosh_loss(predicted, target)) * cfg.log_cosh_strength

    losses = losses * _scale(cfg)
    losses = losses * batch["loss_weight"].to(losses.dtype)

    if "timestep" in data and coefficients is not None:
        snr = coefficients.snr(data["timestep"].long())
        if cfg.loss_weight_fn == LossWeight.MIN_SNR_GAMMA:
            losses = losses * min_snr_weight(snr, cfg.loss_weight_strength, cfg.v_prediction)
        elif cfg.loss_weight_fn == LossWeight.DEBIASED_ESTIMATION:
            losses = losses * debiased_estimation_weight(snr, cfg.v_prediction)
        elif cfg.loss_weight_fn == LossWeight.P2:
            losses = losses * p2_loss_weight(snr, cfg.loss_weight_strength, cfg.v_prediction)
        elif cfg.loss_weight_fn != LossWeight.CONSTANT:
            raise NotImplementedError(f"loss weight {cfg.loss_weight_fn} is not ported yet")
    return losses
