"""Scheduling of repeating / single actions in epochs, steps, or wall time
(reference: modules/util/TimedActionMixin.py)."""

import time

from onetrainer_tpu_torch.util.enums import TimeUnit
from onetrainer_tpu_torch.util.train_progress import TrainProgress


class TimedActionMixin:
    def __init__(self):
        super().__init__()
        self.__previous_action: dict[str, float] = {}
        self.__start_time: dict[str, float] = {}

    def repeating_action_needed(
            self,
            name: str,
            interval: float,
            unit: TimeUnit,
            train_progress: TrainProgress,
            start_at_zero: bool = True,
    ) -> bool:
        match unit:
            case TimeUnit.EPOCH:
                # fire once at the start of a matching epoch (reference:
                # TimedActionMixin.py:25-31 requires epoch_step == 0)
                if start_at_zero:
                    return train_progress.epoch % int(interval) == 0 \
                        and train_progress.epoch_step == 0
                return train_progress.epoch % int(interval) == 0 \
                    and train_progress.epoch_step == 0 \
                    and train_progress.epoch > 0
            case TimeUnit.STEP:
                if start_at_zero:
                    return train_progress.global_step % int(interval) == 0
                # end of each interval (reference: TimedActionMixin.py:35-36)
                return (train_progress.global_step + 1) % int(interval) == 0
            case TimeUnit.SECOND | TimeUnit.MINUTE | TimeUnit.HOUR:
                seconds = interval * {
                    TimeUnit.SECOND: 1.0,
                    TimeUnit.MINUTE: 60.0,
                    TimeUnit.HOUR: 3600.0,
                }[unit]
                now = time.time()
                if name not in self.__previous_action:
                    self.__previous_action[name] = now
                    return start_at_zero
                if now - self.__previous_action[name] >= seconds:
                    self.__previous_action[name] = now
                    return True
                return False
            case TimeUnit.ALWAYS:
                return True
            case TimeUnit.NEVER:
                return False
        return False

    def single_action_elapsed(
            self,
            name: str,
            interval: float,
            unit: TimeUnit,
            train_progress: TrainProgress,
    ) -> bool:
        match unit:
            case TimeUnit.EPOCH:
                return train_progress.epoch >= interval
            case TimeUnit.STEP:
                return train_progress.global_step >= interval
            case TimeUnit.SECOND | TimeUnit.MINUTE | TimeUnit.HOUR:
                seconds = interval * {
                    TimeUnit.SECOND: 1.0,
                    TimeUnit.MINUTE: 60.0,
                    TimeUnit.HOUR: 3600.0,
                }[unit]
                now = time.time()
                if name not in self.__start_time:
                    self.__start_time[name] = now
                return now - self.__start_time[name] >= seconds
            case TimeUnit.ALWAYS:
                return True
            case TimeUnit.NEVER:
                return False
        return False
