"""Shared sampler pieces: the output record and the sampling generator.

Counterpart of the `SamplerOutput` and `sample_rng_for` parts of
onetrainer_tpu/sampling/sd_sampler.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SamplerOutput:
    image: np.ndarray                     # HWC uint8


def sample_rng_for(sample_config, device: torch.device | str) -> torch.Generator:
    """Sampling generator on `device`: the configured seed, or OS entropy
    when sample_config.random_seed is set. Torch and JAX draw different
    numbers from one seed."""
    seed = sample_config.seed
    if getattr(sample_config, "random_seed", False):
        import secrets
        seed = secrets.randbits(31)
    return torch.Generator(device=device).manual_seed(seed)
