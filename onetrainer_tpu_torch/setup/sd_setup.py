"""Per-group learning-rate schedules of the SD-family setups.

Counterpart of `_lr_scale`, `_stop_step` and `_group_schedule` in
onetrainer_tpu/setup/sd_setup.py (reference:
modules/util/NamedParameterGroup.py, modules/util/create.py:1114-1232).
CUSTOM schedulers and schedule-free optimizers are not ported.
"""

from __future__ import annotations

from onetrainer_tpu_torch.train.lr_schedules import make_schedule, resolve_warmup_steps
from onetrainer_tpu_torch.util.enums import (
    LearningRateScaler, LearningRateScheduler, TimeUnit,
)


def _lr_scale(config) -> float:
    """sqrt batch/accum LR scaling (reference:
    modules/util/NamedParameterGroup.py parameters_for_optimizer)."""
    scaler = config.learning_rate_scaler
    scale = 1.0
    if scaler in (LearningRateScaler.BATCH, LearningRateScaler.BOTH):
        scale *= config.batch_size ** 0.5
    if scaler in (LearningRateScaler.GRADIENT_ACCUMULATION, LearningRateScaler.BOTH):
        scale *= config.gradient_accumulation_steps ** 0.5
    return scale


def _stop_step(part, steps_per_epoch: int) -> int | None:
    """stop_training_after in optimizer steps."""
    if part.stop_training_after is None or \
            part.stop_training_after_unit == TimeUnit.NEVER:
        return None
    if part.stop_training_after_unit == TimeUnit.EPOCH:
        return int(part.stop_training_after * steps_per_epoch)
    if part.stop_training_after_unit == TimeUnit.STEP:
        return int(part.stop_training_after)
    return None


def _group_schedule(config, group_lr: float | None, total_steps: int,
                    part=None, steps_per_epoch: int = 1):
    """step -> learning rate of one param group."""
    base_lr = (group_lr if group_lr is not None else config.learning_rate)
    base_lr *= _lr_scale(config)
    scheduler = config.learning_rate_scheduler
    if config.optimizer.optimizer.is_schedule_free():
        raise NotImplementedError("schedule-free optimizers are not ported yet")
    if scheduler == LearningRateScheduler.CUSTOM:
        raise NotImplementedError("CUSTOM learning-rate schedulers are not ported yet")
    warmup = resolve_warmup_steps(config.learning_rate_warmup_steps, total_steps,
                                  config.gradient_accumulation_steps)
    schedule = make_schedule(scheduler, total_steps, warmup,
                             config.learning_rate_cycles,
                             config.learning_rate_min_factor, base_lr)
    stop = _stop_step(part, steps_per_epoch) if part is not None else None
    if stop is None:
        return schedule
    return lambda step: schedule(step) * float(step < stop)
