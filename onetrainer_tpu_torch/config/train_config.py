"""Training settings: the reference's framework-free config, reused as is."""

from onetrainer_tpu.config.train_config import TrainConfig

__all__ = ["TrainConfig"]
