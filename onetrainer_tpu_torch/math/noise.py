"""Noise generation and forward-noising.

Counterpart of onetrainer_tpu/math/noise.py (reference:
modules/modelSetup/mixin/ModelSetupNoiseMixin.py:18-49,
ModelSetupDiffusionMixin.py:15-57), with an explicit `torch.Generator`.
"""

from __future__ import annotations

import torch


def create_noise(
        generator: torch.Generator,
        shape: tuple[int, ...],
        dtype: torch.dtype,
        offset_noise_weight: float = 0.0,
        perturbation_noise_weight: float = 0.0,
) -> torch.Tensor:
    """Gaussian noise of the channels-last `shape` ([B, H, W, C], as the
    port's latents are) with optional offset and perturbation components,
    drawn in fp32 on the generator's device, then cast. The offset is one
    draw per (sample, channel), constant over the spatial axes, as
    OneTrainer's `_create_noise` draws [B, C, 1, 1] on NCHW latents."""
    device = generator.device
    noise = torch.randn(shape, generator=generator, device=device)
    if offset_noise_weight > 0:
        offset_shape = (shape[0],) + (1,) * (len(shape) - 2) + (shape[-1],)
        noise = noise + offset_noise_weight * torch.randn(
            offset_shape, generator=generator, device=device)
    if perturbation_noise_weight > 0:
        noise = noise + perturbation_noise_weight * torch.randn(
            shape, generator=generator, device=device)
    return noise.to(dtype)


def _broadcast_to(coeff: torch.Tensor, ndim: int) -> torch.Tensor:
    return coeff.reshape(coeff.shape + (1,) * (ndim - coeff.dim()))


def add_noise_discrete(
        scaled_latent: torch.Tensor,
        noise: torch.Tensor,
        timestep: torch.Tensor,
        sqrt_alphas_cumprod: torch.Tensor,
        sqrt_one_minus_alphas_cumprod: torch.Tensor,
) -> torch.Tensor:
    """x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps (fp32, cast back)."""
    t = timestep.long()
    sac = _broadcast_to(sqrt_alphas_cumprod[t], scaled_latent.dim())
    somac = _broadcast_to(sqrt_one_minus_alphas_cumprod[t], scaled_latent.dim())
    noisy = scaled_latent.float() * sac + noise.float() * somac
    return noisy.to(scaled_latent.dtype)
