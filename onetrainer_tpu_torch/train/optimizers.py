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

The optimizer returns each step's updates, computed with multi-tensor
(`torch._foreach_*`) ops, and the caller adds them (optax.apply_updates),
or rounds them in stochastically for bf16 parameters. `updates` keeps
optax's dtypes and operation order: the moments are held in the
parameters' dtype (bf16 for bf16 adapters), the bias corrections and the
learning rate are rounded to that dtype before use, and every operation
rounds its result, so a bf16 update is what optax computes in bf16 and an
fp32 update what it computes in fp32. The global norm of bf16 gradients
is taken in bf16 too. Other optimizers, amsgrad and gradient accumulation
raise.
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
    def updates(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: AdamWState) -> list[torch.Tensor]:
        """One step's updates (to add to `params`), advancing `state`, in
        optax.adamw's order and the parameters' dtype:
        mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu;
        u = -lr * (mu / c1 / (sqrt(nu / c2) + eps) + wd p)."""
        if not params:
            return []
        dtype = params[0].dtype
        if any(p.dtype != dtype for p in params):
            raise TypeError("one optimizer group must hold one dtype")

        def rounded(x) -> float:
            return torch.as_tensor(x, dtype=torch.float32).to(dtype).item()

        def correction(decay: float, count: int) -> float:
            # 1 - decay^count in fp32 (powf, as XLA), then the moments' dtype
            f32 = torch.float32
            return rounded(1.0 - torch.tensor(decay, dtype=f32) ** torch.tensor(count, dtype=f32))

        # python scalars meet the moments as weakly typed constants: in
        # their dtype, as jnp rounds them
        b1, b2, eps = rounded(self.b1), rounded(self.b2), rounded(self.eps)
        lr = float(self.schedule(state.count))
        state.count += 1
        t = state.count
        # in place where the result rounds as the out-of-place op would
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, rounded(1.0 - self.b1)))
        squares = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squares, rounded(1.0 - self.b2))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, squares)
        del squares
        update = torch._foreach_div(state.mu, correction(self.b1, t))
        denom = torch._foreach_div(state.nu, correction(self.b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(update, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(params, rounded(self.weight_decay)))
        torch._foreach_mul_(update, rounded(-lr))
        return update


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
    """sqrt(sum of squares) over every element (optax.global_norm): fp32 on
    the tensors' device when any tensor is fp32; else, as optax over bf16
    leaves, in bf16: each tensor's sum of bf16 squares rounded to bf16, the
    sums added one by one in bf16, and the square root of the total. The
    one-by-one additions run on the host (one copy of the per-tensor sums,
    which waits for them) rather than as one launch each on the card."""
    if any(t.dtype == torch.float32 for t in tensors) or not tensors:
        norms = torch._foreach_norm([t.float() for t in tensors])
        return torch.linalg.vector_norm(torch.stack(norms))
    sums = torch.stack(torch._foreach_norm(torch._foreach_mul(tensors, tensors), 1)).cpu()
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm, in place: g / |g| * c where |g| >= c.
    A bf16 norm (bf16 gradients, on the host) divides and then multiplies
    by c in bf16, as optax."""
    if norm.dtype == torch.float32:
        factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, factor)
        return
    if norm < max_norm:
        return
    torch._foreach_div_(grads, norm.item())
    torch._foreach_mul_(grads, torch.tensor(max_norm).to(norm.dtype).item())


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

    def updates(self, params: dict[str, list[torch.Tensor]],
                grads: dict[str, list[torch.Tensor]], state: dict,
                norm: torch.Tensor) -> dict[str, list[torch.Tensor]]:
        """Clip (when configured) and return every group's updates."""
        if self.clip_grad_norm:
            clip_by_global_norm_([g for n in self.groups for g in grads[n]],
                                 self.clip_grad_norm, norm)
        return {name: opt.updates(params[name], grads[name], state[name])
                for name, opt in self.groups.items()}


def create_group_optimizer(group_schedules: dict, optimizer: Optimizer, cfg,
                           clip_grad_norm: float | None = None) -> GroupOptimizer:
    return GroupOptimizer(group_schedules, optimizer, cfg, clip_grad_norm)
