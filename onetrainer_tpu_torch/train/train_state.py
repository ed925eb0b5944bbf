"""The train state: what changes from step to step.

Counterpart of onetrainer_tpu/train/train_state.py. The reference's state
is an immutable pytree that each jitted step returns anew; here the
trainable tensors and optimizer state are updated in place by the step,
and `step` counts optimizer steps. EMA and host offload of optimizer
state are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class TrainState:
    step: int        # global optimizer step
    params: dict     # trainable groups, e.g. {"unet_lora": adapters}
    opt_state: Any


def create_train_state(params: dict, tx, ema_enabled: bool = False) -> TrainState:
    if ema_enabled:
        raise NotImplementedError("EMA is not ported yet")
    return TrainState(step=0, params=params, opt_state=tx.init(param_groups(params)))


def param_groups(params: dict) -> dict[str, list]:
    """{group: [tensors]} in a fixed order (adapter key, then tensor name)."""
    out = {}
    for group, tree in params.items():
        out[group] = [tensor for key in tree for _, tensor in sorted(tree[key].items())]
    return out
