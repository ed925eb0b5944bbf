"""Learning-rate schedules as step -> float functions.

Counterpart of onetrainer_tpu/train/lr_schedules.py (reference:
modules/util/lr_scheduler_util.py:5-95, modules/util/create.py:1114-1232):
a unit-height base curve composed with linear warmup and a min-factor
floor, multiplied by the group learning rate. The port evaluates them on
the host once per step. CUSTOM schedulers are not ported.
"""

from __future__ import annotations

import math

from onetrainer_tpu_torch.util.enums import LearningRateScheduler


def _apply_min_factor(value: float, min_factor: float) -> float:
    return min_factor + (1.0 - min_factor) * value


def make_lr_lambda(
        scheduler: LearningRateScheduler,
        scheduler_steps: int,
        num_cycles: float = 1.0,
        min_factor: float = 0.0,
):
    """Unit-height schedule factor (no warmup)."""
    steps = max(scheduler_steps, 1)

    if scheduler == LearningRateScheduler.CONSTANT:
        return lambda step: 1.0
    if scheduler == LearningRateScheduler.LINEAR:
        return lambda step: _apply_min_factor(max(0.0, (steps - step) / steps),
                                              min_factor)
    if scheduler == LearningRateScheduler.COSINE:
        return lambda step: _apply_min_factor(
            max(0.0, 0.5 * (1.0 + math.cos(step / steps * math.pi))), min_factor)
    if scheduler == LearningRateScheduler.COSINE_WITH_RESTARTS:
        def fn(step):
            progress = min(step, steps - 1) / steps
            return _apply_min_factor(max(0.0, 0.5 * (1.0 + math.cos(
                progress * 2.0 * math.pi * num_cycles))), min_factor)
        return fn
    if scheduler == LearningRateScheduler.COSINE_WITH_HARD_RESTARTS:
        def fn(step):
            progress = min(step, steps - 1) / steps
            return _apply_min_factor(max(0.0, 0.5 * (1.0 + math.cos(
                ((progress * num_cycles) % 1.0) * math.pi))), min_factor)
        return fn
    if scheduler == LearningRateScheduler.REX:
        def fn(step):
            d = 0.9
            progress = step / steps
            div = (1 - d) + d * (1 - progress)
            val = (1 - progress) / div if step < steps else 0.0
            return _apply_min_factor(max(val, 0.0), min_factor)
        return fn
    if scheduler == LearningRateScheduler.ADAFACTOR:
        return lambda step: 1.0 / math.sqrt(max(float(step), 1.0))
    raise NotImplementedError(f"scheduler {scheduler} is not ported yet")


def with_warmup(lr_lambda, warmup_steps: float):
    """Linear warmup for `warmup_steps`, then the base schedule restarted at
    0 (reference: lr_lambda_warmup)."""
    warmup_steps = float(warmup_steps)
    if warmup_steps <= 0:
        return lr_lambda

    def fn(step):
        step = float(step)
        if step < warmup_steps:
            return step / warmup_steps
        return lr_lambda(max(step - warmup_steps, 0.0))
    return fn


def make_schedule(
        scheduler: LearningRateScheduler,
        total_steps: int,
        warmup_steps: float,
        num_cycles: float,
        min_factor: float,
        base_lr: float,
):
    """step -> absolute learning rate."""
    scheduler_steps = max(int(total_steps - warmup_steps), 1)
    fn = with_warmup(make_lr_lambda(scheduler, scheduler_steps, num_cycles,
                                    min_factor), warmup_steps)
    return lambda step: base_lr * fn(float(step))


def resolve_warmup_steps(warmup_steps: float, total_steps: int,
                         gradient_accumulation_steps: int = 1) -> int:
    """The reference's warmup interpretation (modules/util/create.py:1130-1136):
    values > 1 are a literal step count (divided by gradient accumulation),
    values in (0, 1] a fraction of total optimizer steps, anything else 0."""
    if warmup_steps > 1:
        return int(warmup_steps / max(gradient_accumulation_steps, 1))
    if 0 < warmup_steps <= 1:
        return int(warmup_steps * total_steps)
    return 0
