"""Gradient-checkpoint policies for the DiT blocks.

Counterpart of onetrainer_tpu/models/remat.py. The reference names a
jax.checkpoint policy per family; the port runs two of them with
`torch.utils.checkpoint` (non-reentrant), and the loaders build their
transformers with the reference's family defaults: `SD3_POLICY` for SD3,
`FLUX_POLICY` for FLUX and `HUNYUAN_POLICY` for HunyuanVideo (the
reference's `_DEFAULTS` has no entry for either, so their default is
"full"; the port has no environment override):

- "full": the block is one recomputed segment (its attention forward runs
  again in the backward);
- "dots_nb_attn": the reference's union of "dots_nb" (keep the outputs of
  matmuls without batch dims, i.e. every weight matmul) and "attn" (keep
  the attention output). A selective-checkpoint policy sees dispatcher ops
  only, and the port's attention kernels launch inside a
  `torch.autograd.Function`, so the model keeps the attention call outside
  the recomputed segments instead: the block's two halves before and after
  it recompute, saving every `aten.mm` / `aten.addmm` output
  (`dots_nb_context`), and the attention's own saved q, k, v, o and lse
  stand in for the saved "attn_out". The attention runs once per step.

The other reference policies ("dots", "dots_nb", "attn", "tx_attn",
"depth") raise where a model is built with them.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

DIT_POLICIES = ("full", "dots_nb_attn")
# the reference's SD3 default (its measured winner)
SD3_POLICY = "dots_nb_attn"
# the reference's FLUX default (no `_DEFAULTS` entry: "full")
FLUX_POLICY = "full"
# the reference's HunyuanVideo default (no `_DEFAULTS` entry: "full"), the
# one policy its blocks run here
HUNYUAN_POLICY = "full"


_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_no_batch_dots(ctx, op, *args, **kwargs):
    if op in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_nb_context():
    """A context_fn for `checkpoint` that saves the weight matmuls'
    outputs and recomputes everything else."""
    return create_selective_checkpoint_contexts(_save_no_batch_dots)


def checkpointed(fn, *args, save_dots: bool = False):
    """fn(*args), recomputed in the backward when autograd records (a
    no-grad or inference call runs it plainly); with `save_dots` the
    weight matmuls' outputs are kept instead of recomputed."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if save_dots:
        return checkpoint(fn, *args, use_reentrant=False, context_fn=dots_nb_context)
    return checkpoint(fn, *args, use_reentrant=False)

