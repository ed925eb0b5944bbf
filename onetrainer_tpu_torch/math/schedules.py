"""Diffusion schedule coefficients and beta schedules (fp32 torch tensors).

Counterpart of onetrainer_tpu/math/schedules.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiffusionScheduleCoefficients(NamedTuple):
    """All alpha-bar derived constants, including posterior coefficients."""
    num_timesteps: int
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @staticmethod
    def from_betas(betas: torch.Tensor) -> "DiffusionScheduleCoefficients":
        betas = torch.as_tensor(betas, dtype=torch.float32)
        alphas = 1.0 - betas
        alphas_cumprod = torch.cumprod(alphas, dim=0)
        alphas_cumprod_prev = torch.cat(
            [torch.ones(1, dtype=alphas_cumprod.dtype), alphas_cumprod[:-1]])
        posterior_variance = betas * (1 - alphas_cumprod_prev) / (1 - alphas_cumprod)
        posterior_log_variance_clipped = torch.log(torch.clamp(
            torch.cat([posterior_variance[1:2], posterior_variance[1:]]),
            min=1e-20))
        return DiffusionScheduleCoefficients(
            num_timesteps=int(betas.shape[0]),
            betas=betas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            sqrt_alphas_cumprod=torch.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=torch.sqrt(1 - alphas_cumprod),
            log_one_minus_alphas_cumprod=torch.log(1 - alphas_cumprod),
            sqrt_recip_alphas_cumprod=1.0 / torch.sqrt(alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=torch.sqrt(1 / alphas_cumprod - 1),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=posterior_log_variance_clipped,
            posterior_mean_coef1=betas * torch.sqrt(alphas_cumprod_prev) / (1 - alphas_cumprod),
            posterior_mean_coef2=(1 - alphas_cumprod_prev) * torch.sqrt(alphas) / (1 - alphas_cumprod),
        )

    def snr(self, timesteps: torch.Tensor) -> torch.Tensor:
        all_snr = (self.sqrt_alphas_cumprod / self.sqrt_one_minus_alphas_cumprod) ** 2
        return all_snr[timesteps]


def make_betas(
        schedule: str = "scaled_linear",
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        num_train_timesteps: int = 1000,
) -> torch.Tensor:
    """Beta schedule used by SD-family checkpoints (diffusers `scheduler_config`).
    `scaled_linear`: linspace over sqrt(beta), then squared."""
    if schedule == "scaled_linear":
        return torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                              num_train_timesteps, dtype=torch.float32) ** 2
    if schedule == "linear":
        return torch.linspace(beta_start, beta_end, num_train_timesteps,
                              dtype=torch.float32)
    if schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps, dtype=np.float64)
        f = lambda x: np.cos((x / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.minimum(1 - f(t + 1) / f(t), 0.999)
        return torch.as_tensor(betas, dtype=torch.float32)
    raise ValueError(f"unknown beta schedule {schedule}")


def rescale_betas_zero_terminal_snr(betas: torch.Tensor) -> torch.Tensor:
    """Zero-terminal-SNR rescale from "Common Diffusion Noise Schedules and
    Sample Steps are Flawed" (arXiv:2305.08891)."""
    alphas = 1.0 - betas
    alphas_cumprod = torch.cumprod(alphas, dim=0)
    sqrt_ac = torch.sqrt(alphas_cumprod)
    sqrt_ac_0 = sqrt_ac[0].clone()
    sqrt_ac_T = sqrt_ac[-1].clone()
    sqrt_ac = sqrt_ac - sqrt_ac_T
    sqrt_ac = sqrt_ac * (sqrt_ac_0 / (sqrt_ac_0 - sqrt_ac_T))
    alphas_cumprod = sqrt_ac ** 2
    alphas = alphas_cumprod[1:] / alphas_cumprod[:-1]
    alphas = torch.cat([alphas_cumprod[0:1], alphas])
    return 1.0 - alphas
