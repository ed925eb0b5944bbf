"""SD-family step configuration and conditioning dropout.

Counterpart of the framework-free parts of
onetrainer_tpu/train/sd_train_step.py: `SDStepConfig` (the reference's
field names and defaults, for the fields the port's SDXL LoRA step reads)
and `conditioning_dropout_mask`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from onetrainer_tpu_torch.math.losses import LossConfig
from onetrainer_tpu_torch.math.timesteps import TimestepConfig
from onetrainer_tpu_torch.util.enums import EMAMode, TrainingMethod


@dataclass(frozen=True)
class SDStepConfig:
    """Static configuration of the train step."""
    training_method: TrainingMethod
    timestep: TimestepConfig
    loss: LossConfig
    offset_noise_weight: float = 0.0
    perturbation_noise_weight: float = 0.0
    vae_scaling_factor: float = 0.18215
    prediction_type: str = "epsilon"
    text_encoder_layer_skip: int = 0
    train_text_encoder: bool = False
    num_train_timesteps: int = 1000
    te_dropout: float = 0.0
    te2_dropout: float = 0.0
    te2_layer_skip: int = 0
    stochastic_rounding: bool = False

    @staticmethod
    def from_train_config(config, prediction_type: str = "epsilon",
                          layer_skip: int = 0) -> "SDStepConfig":
        """The step's settings from a TrainConfig. Settings the reference
        honours and the port does not yet (EMA, gradient accumulation)
        raise NotImplementedError."""
        if config.ema != EMAMode.OFF:
            raise NotImplementedError("EMA is not ported yet")
        if config.gradient_accumulation_steps > 1:
            raise NotImplementedError("gradient accumulation is not ported yet")

        def _part_dropout(name: str) -> float:
            part = getattr(config, name, None)
            return float(getattr(part, "dropout_probability", 0.0) or 0.0)

        return SDStepConfig(
            training_method=config.training_method,
            timestep=TimestepConfig.from_train_config(config),
            loss=LossConfig.from_train_config(
                config, v_prediction=prediction_type == "v_prediction"),
            offset_noise_weight=config.offset_noise_weight,
            perturbation_noise_weight=config.perturbation_noise_weight,
            prediction_type=prediction_type,
            text_encoder_layer_skip=layer_skip,
            train_text_encoder=config.train_text_encoder_or_embedding(),
            te_dropout=_part_dropout("text_encoder"),
            te2_dropout=_part_dropout("text_encoder_2"),
            te2_layer_skip=int(getattr(config, "text_encoder_2_layer_skip", 0) or 0),
            stochastic_rounding=config.optimizer.stochastic_rounding,
        )


def conditioning_dropout_mask(generator: torch.Generator, batch_size: int,
                              p: float) -> torch.Tensor:
    """Per-sample keep mask for text-conditioning dropout: 0 with
    probability p, else 1 (fp32, on the generator's device)."""
    u = torch.rand((batch_size,), generator=generator, device=generator.device)
    return (u >= p).to(torch.float32)
