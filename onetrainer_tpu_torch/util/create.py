"""Factory wiring point (reference: modules/util/create.py).

Counterpart of onetrainer_tpu/util/create.py: maps a training config onto
the port's trainer. The cloud trainer is not ported.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.config.train_config import TrainConfig
from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
from onetrainer_tpu_torch.util.commands import TrainCommands


def create_trainer(config: TrainConfig, callbacks: TrainCallbacks | None = None,
                   commands: TrainCommands | None = None,
                   device: torch.device | str = "cuda"):
    """The trainer of `config`, training on `device` (the card unless the
    caller passes another)."""
    if config.cloud.enabled:
        raise NotImplementedError("the cloud trainer is not ported")
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.trainer.generic_trainer import GenericTrainer
    get_family(config.model_type)  # raises NotImplementedError when unported
    return GenericTrainer(config, callbacks, commands, device=device)
