"""Optimizers, ADAMW only so far.

Counterpart of the ADAMW branch of onetrainer_tpu/train/optimizers.py
(`_create_base_optimizer`) and of the clip + multi-group chain that
setup/sdxl_setup.py builds with optax. Written by hand to optax's
formulas, so the two sides take the same steps:

- clip by global norm: g * (c / |g|) when |g| >= c, else g
  (optax.clip_by_global_norm; not torch's clip_grad_norm_, which adds
  1e-6 to the norm);
- adamw: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
  u = mu_hat / (sqrt(nu_hat) + eps) + wd p, p -= lr(count) u, with
  count starting at 0 (optax.adamw).

Parameters are updated in place with multi-tensor (`torch._foreach_*`)
ops. Other optimizers, amsgrad and gradient accumulation raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from onetrainer_tpu_torch.util.enums import Optimizer


def _d(value, default):
    return default if value is None else value


@dataclass
class AdamWState:
    count: int = 0
    mu: list = field(default_factory=list)
    nu: list = field(default_factory=list)


class AdamW:
    """optax.adamw over a list of tensors, with a step -> lr schedule."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        self.schedule = learning_rate if callable(learning_rate) \
            else (lambda step, lr=learning_rate: lr)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: list[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update_(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: AdamWState) -> None:
        """One step, in place on `params` and `state`."""
        if not params:
            return
        b1, b2 = self.b1, self.b2
        lr = float(self.schedule(state.count))
        state.count += 1
        t = state.count
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(state.mu, 1.0 - b1 ** t)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)


def create_optimizer(optimizer: Optimizer, cfg, learning_rate) -> AdamW:
    """The optimizer of one param group (`cfg` is TrainOptimizerConfig;
    defaults follow the reference's per-optimizer tables)."""
    if optimizer != Optimizer.ADAMW:
        raise NotImplementedError(f"optimizer {optimizer} is not ported yet (ADAMW only)")
    if cfg.amsgrad:
        raise NotImplementedError("AdamW with amsgrad is not ported yet")
    return AdamW(learning_rate, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                 eps=_d(cfg.eps, 1e-8), weight_decay=_d(cfg.weight_decay, 1e-2))


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element, fp32 (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm, in place: g / |g| * c where |g| >= c."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)


class GroupOptimizer:
    """One optimizer per named param group, each with its own schedule,
    behind an optional global-norm clip over all groups (the optax chain
    of setup/sdxl_setup.py)."""

    def __init__(self, group_schedules: dict, optimizer: Optimizer, cfg,
                 clip_grad_norm: float | None = None):
        self.groups = {name: create_optimizer(optimizer, cfg, schedule)
                       for name, schedule in group_schedules.items()}
        self.clip_grad_norm = clip_grad_norm

    def init(self, params: dict[str, list[torch.Tensor]]) -> dict:
        return {name: opt.init(params[name]) for name, opt in self.groups.items()}

    def update_(self, params: dict[str, list[torch.Tensor]],
                grads: dict[str, list[torch.Tensor]], state: dict,
                norm: torch.Tensor) -> None:
        """Clip (when configured) and step every group, in place."""
        if self.clip_grad_norm:
            clip_by_global_norm_([g for n in self.groups for g in grads[n]],
                                 self.clip_grad_norm, norm)
        for name, opt in self.groups.items():
            opt.update_(params[name], grads[name], state[name])


def create_group_optimizer(group_schedules: dict, optimizer: Optimizer, cfg,
                           clip_grad_norm: float | None = None) -> GroupOptimizer:
    return GroupOptimizer(group_schedules, optimizer, cfg, clip_grad_norm)
