"""The train state: what changes from step to step.

Counterpart of onetrainer_tpu/train/train_state.py. The reference's state
is an immutable pytree that each jitted step returns anew; here the
trainable tensors, the optimizer state and the EMA are updated in place
by the step, and `step` counts the steps taken (micro-steps under
gradient accumulation, as the reference's). Host offload of optimizer
and EMA state is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from onetrainer_tpu_torch.train.ema import EMAState, init_ema


@dataclass
class TrainState:
    step: int        # global step (micro-steps under gradient accumulation)
    params: dict     # trainable groups, e.g. {"unet_lora": adapters}, {"unet": tensors},
                     # {"embeddings": vectors}
    opt_state: Any
    ema: EMAState | None = None


def create_train_state(params: dict, tx, ema_enabled: bool = False) -> TrainState:
    return TrainState(step=0, params=params, opt_state=tx.init(param_groups(params)),
                      ema=init_ema(params) if ema_enabled else None)


def _entries(tree):
    """(name, tensor) of one group in `param_groups`' order."""
    if isinstance(tree, torch.Tensor):   # embedding vectors: one tensor
        yield "", tree
        return
    for key, entry in tree.items():
        if isinstance(entry, torch.Tensor):
            yield key, entry
        else:
            for name, tensor in sorted(entry.items()):
                yield f"{key}/{name}", tensor


def param_groups(params: dict) -> dict[str, list]:
    """{group: [tensors]} in a fixed order: an adapter tree ({key: {name:
    tensor}}) by adapter key, then tensor name; a FINE_TUNE group ({name:
    tensor}, one module's parameters by their diffusers names) in its own
    order, the module's; an embedding group (one [tokens, hidden] tensor)
    as that tensor."""
    return {group: [t for _, t in _entries(tree)] for group, tree in params.items()}


def param_names(params: dict) -> dict[str, list[str]]:
    """{group: [names]} in `param_groups`' order: "<key>/<tensor name>" for
    an adapter tree, the parameter's name for a FINE_TUNE group, "" for an
    embedding group."""
    return {group: [name for name, _ in _entries(tree)] for group, tree in params.items()}


def leaves_like(tree: dict, params: dict) -> list:
    """The leaves of `tree`, a tree with the keys of `params` (rounding bits,
    say), in `param_groups(params)`' order."""
    out = []
    for group, ptree in params.items():
        if isinstance(ptree, torch.Tensor):
            out.append(tree[group])
            continue
        out.extend(tree[group][key] if isinstance(entry, torch.Tensor) else tree[group][key][name]
                   for key, entry in ptree.items()
                   for name in ([None] if isinstance(entry, torch.Tensor) else sorted(entry)))
    return out
