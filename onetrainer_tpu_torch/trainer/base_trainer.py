"""Abstract trainer + TensorBoard wiring
(reference: modules/trainer/BaseTrainer.py:21-106)."""

from __future__ import annotations

import os
import subprocess
import sys
from abc import ABC, abstractmethod

from onetrainer_tpu_torch.config.train_config import TrainConfig
from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
from onetrainer_tpu_torch.util.commands import TrainCommands
from onetrainer_tpu_torch.util.timed_action import TimedActionMixin


class BaseTrainer(TimedActionMixin, ABC):
    def __init__(self, config: TrainConfig, callbacks: TrainCallbacks,
                 commands: TrainCommands):
        super().__init__()
        self.config = config
        self.callbacks = callbacks
        self.commands = commands
        self.tensorboard_subprocess = None
        self.tensorboard = None

        if config.tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                os.makedirs(self.tensorboard_dir, exist_ok=True)
                self.tensorboard = SummaryWriter(self.tensorboard_dir)
            except Exception as e:
                print(f"tensorboard writer unavailable: {e}")
            if config.tensorboard_expose or config.tensorboard_port:
                self._start_tensorboard()

    @property
    def tensorboard_dir(self) -> str:
        return os.path.join(self.config.workspace_dir, "tensorboard")

    def _start_tensorboard(self):
        try:
            host = "0.0.0.0" if self.config.tensorboard_expose else "localhost"
            self.tensorboard_subprocess = subprocess.Popen([
                sys.executable, "-m", "tensorboard.main",
                "--logdir", self.tensorboard_dir,
                "--port", str(self.config.tensorboard_port),
                "--host", host,
            ], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except Exception:
            self.tensorboard_subprocess = None

    def _stop_tensorboard(self):
        if self.tensorboard_subprocess is not None:
            self.tensorboard_subprocess.terminate()
            self.tensorboard_subprocess = None

    @abstractmethod
    def start(self): ...

    @abstractmethod
    def train(self): ...

    @abstractmethod
    def end(self): ...

    @abstractmethod
    def backup(self, train_progress): ...
