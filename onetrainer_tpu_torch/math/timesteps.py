"""Timestep sampling: distributions, noising-strength window, static and
dynamic (FLUX mu) timestep shifting, and FLUX's continuous timesteps
(`sample_timesteps_continuous`).

Counterpart of onetrainer_tpu/math/timesteps.py (reference:
modules/modelSetup/mixin/ModelSetupNoiseMixin.py:51-181). Draws come from
an explicit `torch.Generator`; the distributions are the reference's, the
numbers are not JAX's (tests feed both sides the same timesteps).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.util.enums import TimestepDistribution


@dataclass(frozen=True)
class TimestepConfig:
    distribution: TimestepDistribution = TimestepDistribution.UNIFORM
    min_noising_strength: float = 0.0
    max_noising_strength: float = 1.0
    noising_weight: float = 0.0
    noising_bias: float = 0.0
    timestep_shift: float = 1.0
    dynamic_timestep_shifting: bool = False

    @staticmethod
    def from_train_config(config) -> "TimestepConfig":
        return TimestepConfig(
            distribution=config.timestep_distribution,
            min_noising_strength=config.min_noising_strength,
            max_noising_strength=config.max_noising_strength,
            noising_weight=config.noising_weight,
            noising_bias=config.noising_bias,
            timestep_shift=config.timestep_shift,
            dynamic_timestep_shifting=config.dynamic_timestep_shifting,
        )


def flux_mu_shift(latent_width: int, latent_height: int) -> float:
    """Dynamic mu-shift from image sequence length (FLUX recipe)
    (reference: ModelSetupNoiseMixin.py:73-89)."""
    base_seq_len, max_seq_len = 256, 4096
    base_shift, max_shift = 0.5, 1.15
    patch_size = 2
    image_seq_len = (latent_width // patch_size) * (latent_height // patch_size)
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return math.exp(image_seq_len * m + b)


def _discrete_weights(cfg: TimestepConfig, num_timestep: int,
                      shift: float) -> torch.Tensor:
    """Sampling weights of the discrete distributions, with the reference's
    double shift map in SIGMOID (ModelSetupNoiseMixin.py:118-152)."""
    linspace = torch.linspace(0.0, 1.0, num_timestep, dtype=torch.float32)
    shifted = linspace / (shift - shift * linspace + linspace)
    derivative = shift / (shift + linspace - linspace * shift) ** 2
    if cfg.distribution == TimestepDistribution.COS_MAP:
        weights = 2.0 / (math.pi - 2.0 * math.pi * shifted
                         + 2.0 * math.pi * shifted ** 2)
        return weights * derivative
    if cfg.distribution == TimestepDistribution.SIGMOID:
        bias = cfg.noising_bias + 0.5
        shifted2 = shifted / (shift - shift * shifted + shifted)
        weights = 1.0 / (1.0 + torch.exp(-cfg.noising_weight * (shifted2 - bias)))
        return weights * derivative
    raise ValueError(f"not a discrete distribution: {cfg.distribution}")


def sample_timesteps_discrete(
        generator: torch.Generator,
        batch_size: int,
        cfg: TimestepConfig,
        num_train_timesteps: int = 1000,
        deterministic: bool = False,
        latent_width: int | None = None,
        latent_height: int | None = None,
) -> torch.Tensor:
    """Integer timesteps [batch_size] int32 in [0, num_train_timesteps), on
    the generator's device."""
    device = generator.device
    if deterministic:
        return torch.full((batch_size,), int(num_train_timesteps * 0.5) - 1,
                          dtype=torch.int32, device=device)
    min_timestep = int(num_train_timesteps * cfg.min_noising_strength)
    max_timestep = int(num_train_timesteps * cfg.max_noising_strength)
    num_timestep = max_timestep - min_timestep

    shift = cfg.timestep_shift
    if cfg.dynamic_timestep_shifting:
        if not latent_width or not latent_height:
            raise NotImplementedError("dynamic timestep shifting needs latent dims")
        shift = flux_mu_shift(latent_width, latent_height)

    if cfg.distribution.is_continuous():
        def uniform():
            return torch.rand((batch_size,), generator=generator, device=device)
        if cfg.distribution == TimestepDistribution.UNIFORM:
            timestep = min_timestep + (max_timestep - min_timestep) * uniform()
        elif cfg.distribution == TimestepDistribution.LOGIT_NORMAL:
            normal = torch.randn((batch_size,), generator=generator, device=device)
            normal = cfg.noising_bias + (cfg.noising_weight + 1.0) * normal
            timestep = torch.sigmoid(normal) * num_timestep + min_timestep
        elif cfg.distribution == TimestepDistribution.HEAVY_TAIL:
            u = uniform()
            u = 1.0 - u - cfg.noising_weight * (
                torch.cos(math.pi / 2.0 * u) ** 2.0 - 1.0 + u)
            timestep = u * num_timestep + min_timestep
        else:
            raise ValueError(cfg.distribution)
        timestep = (num_train_timesteps * shift * timestep
                    / ((shift - 1) * timestep + num_train_timesteps))
        return timestep.to(torch.int32)

    weights = _discrete_weights(cfg, num_timestep, shift).clamp(min=1e-30)
    samples = torch.multinomial(weights.to(device), batch_size, replacement=True,
                                generator=generator)
    return (samples + min_timestep).to(torch.int32)


def sample_timesteps_continuous(
        generator: torch.Generator,
        batch_size: int,
        cfg: TimestepConfig,
        deterministic: bool = False,
) -> torch.Tensor:
    """Continuous timesteps [batch_size] fp32 in (0, 1], discretized to 10000
    buckets as the reference does (ModelSetupNoiseMixin.py:157-181), on the
    generator's device."""
    if deterministic:
        return torch.full((batch_size,), 0.5, dtype=torch.float32, device=generator.device)
    discrete_timesteps = 10000
    discrete = sample_timesteps_discrete(
        generator, batch_size, cfg, num_train_timesteps=discrete_timesteps) + 1
    return discrete.to(torch.float32) / discrete_timesteps
