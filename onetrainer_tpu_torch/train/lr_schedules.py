"""Learning-rate schedules as step -> float functions.

Counterpart of onetrainer_tpu/train/lr_schedules.py (reference:
modules/util/lr_scheduler_util.py:5-95, modules/util/create.py:1114-1232):
a unit-height base curve composed with linear warmup and a min-factor
floor, multiplied by the group learning rate. The port evaluates them on
the host once per step. A CUSTOM scheduler (a user's torch LRScheduler
named by import path) is replayed on the host into a table up front
(`tabulate_custom_schedule`).
"""

from __future__ import annotations

import ast
import importlib
import math

import torch

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


def load_custom_scheduler(class_name: str, scheduler_params: list[dict],
                          placeholders: dict[str, float]):
    """Import a user scheduler class and resolve its %PLACEHOLDER%
    arguments (reference: modules/util/create.py:1181-1222). -> (cls,
    kwargs)."""
    if not class_name:
        raise AssertionError("Must specify a class when using a custom LR scheduler.")
    if "." not in class_name:
        raise AssertionError("Custom class name must be in the format <module>.<class>")
    module_name, _, cls_name = class_name.rpartition(".")
    cls = getattr(importlib.import_module(module_name), cls_name)
    kwargs = {}
    for entry in scheduler_params or []:
        key, value = entry["key"], entry["value"]
        if isinstance(value, str) and value.startswith("%") and value.endswith("%"):
            value = placeholders[value.strip("%")]
        else:
            try:
                value = ast.literal_eval(value)
            except (TypeError, ValueError, SyntaxError):
                pass
        kwargs[key] = value
    return cls, kwargs


def tabulate_custom_schedule(class_name: str, scheduler_params: list[dict], base_lr: float,
                             config_lr: float, total_steps: int, warmup_steps: int,
                             num_epochs: int, steps_per_epoch: int):
    """CUSTOM scheduler -> step -> learning rate, as the JAX package's
    `tabulate_custom_schedule`: the user's torch LRScheduler drives a
    one-parameter SGD on the host for every optimizer step up front (after
    a LambdaLR warmup through SequentialLR when `warmup_steps` > 0, as the
    reference composes them, create.py:1213-1221), and the learning rates
    become an fp32 table indexed by the step (clamped to its ends), so a
    resume needs no replay. Placeholders: %LR%, %EPOCHS%,
    %STEPS_PER_EPOCH%, %TOTAL_STEPS%, %SCHEDULER_STEPS%. A class or callable
    that is no LRScheduler is a step -> factor function, times `base_lr`."""
    cls, kwargs = load_custom_scheduler(class_name, scheduler_params, {
        "LR": config_lr, "EPOCHS": num_epochs, "STEPS_PER_EPOCH": steps_per_epoch,
        "TOTAL_STEPS": total_steps, "SCHEDULER_STEPS": max(total_steps - warmup_steps, 0)})
    if not (isinstance(cls, type) and issubclass(cls, torch.optim.lr_scheduler.LRScheduler)):
        fn = cls(**kwargs) if isinstance(cls, type) else cls
        if not callable(fn):
            raise TypeError(f"custom scheduler {class_name} is neither a torch "
                            "LRScheduler nor a callable step->factor")
        return lambda step: base_lr * float(fn(float(step)))
    param = torch.zeros(1, requires_grad=True)
    opt = torch.optim.SGD([param], lr=base_lr)
    sched = cls(optimizer=opt, **kwargs)
    if warmup_steps > 0:
        warmup = torch.optim.lr_scheduler.LambdaLR(
            opt, lr_lambda=lambda s: min(s / warmup_steps, 1.0))
        sched = torch.optim.lr_scheduler.SequentialLR(
            opt, schedulers=[warmup, sched], milestones=[warmup_steps])
    lrs = []
    for _ in range(max(total_steps, 1) + 1):
        lrs.append(float(opt.param_groups[0]["lr"]))
        opt.step()
        sched.step()
    table = torch.tensor(lrs, dtype=torch.float32).tolist()
    return lambda step: table[min(max(int(step), 0), len(table) - 1)]
