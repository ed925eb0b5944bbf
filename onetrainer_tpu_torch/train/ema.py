"""EMA of the trainable tensors.

Counterpart of onetrainer_tpu/train/ema.py (reference:
modules/module/EMAModule.py:6-86): an fp32 copy of every trainable tensor,
moved towards the trained values after the optimizer update with decay
min((1 + s) / (10 + s), max_decay), where s counts EMA updates, or, when
updates are gated on an interval or on gradient accumulation, the
optimizer-update index. The reference's EMA state is an immutable pytree
each step returns anew; here `update_ema` moves the copy in place with
multi-tensor ops on the tensors' device (EMAMode.GPU; the reference's
EMAMode.CPU, host offload, is not ported).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class EMAState:
    params: dict     # the trainable tree's structure, fp32 copies
    step: int = 0    # EMA updates so far


def _leaves(tree: dict) -> list[torch.Tensor]:
    from onetrainer_tpu_torch.train.train_state import param_groups
    return [t for group in param_groups(tree).values() for t in group]


def _copy_tree(node):
    if isinstance(node, torch.Tensor):
        return node.detach().float().clone()
    return {k: _copy_tree(v) for k, v in node.items()}


def init_ema(params: dict) -> EMAState:
    """An fp32 copy of every trainable tensor, 0 updates."""
    return EMAState(params=_copy_tree(params))


def ema_decay(state_step: int, max_decay: float) -> float:
    """min((1 + s) / (10 + s), max_decay), in fp32 as the reference."""
    step = torch.tensor(state_step, dtype=torch.float32)
    decay = torch.minimum((1.0 + step) / (10.0 + step),
                          torch.tensor(max_decay, dtype=torch.float32))
    return decay.item()


@torch.no_grad()
def update_ema(state: EMAState, params: dict, max_decay: float,
               decay_step: int | None = None) -> None:
    """One EMA update in place: e = e * decay + p * (1 - decay), in fp32.
    `decay_step` replaces the EMA-update count in the decay's warm-up."""
    decay = torch.tensor(ema_decay(state.step if decay_step is None else decay_step,
                                   max_decay), dtype=torch.float32)
    ema = _leaves(state.params)
    torch._foreach_mul_(ema, decay.item())
    torch._foreach_add_(ema, torch._foreach_mul([p.float() for p in _leaves(params)],
                                                (1.0 - decay).item()))
    state.step += 1


def maybe_update_ema(state: EMAState, params: dict, max_decay: float,
                     global_step: int, update_interval: int, accum: int = 1) -> bool:
    """The EMA update of micro-step `global_step` (counted from 0): every
    step when neither an interval nor accumulation gates it; else on the
    last micro-step of every `update_interval` x `accum`, with the decay
    warmed up on the optimizer-update index global_step // accum (the
    reference's GenericTrainer.py:737-746). -> whether it updated."""
    period = max(update_interval, 1) * max(accum, 1)
    if period <= 1:
        update_ema(state, params, max_decay)
        return True
    if (global_step + 1) % period != 0:
        return False
    update_ema(state, params, max_decay, decay_step=global_step // max(accum, 1))
    return True
