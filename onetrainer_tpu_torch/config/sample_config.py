"""Sampling settings: the reference's framework-free config, reused as is."""

from onetrainer_tpu.config.sample_config import SampleConfig

__all__ = ["SampleConfig"]
