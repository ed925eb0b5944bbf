"""Fused stochastic-rounding bf16 update (K5), over a list of leaves.

Counterpart of onetrainer_tpu/ops/pallas_sr.py (`sr_update_pallas`, one
launch per leaf): out = stochastic_round_bf16(p + u), p bf16, u bf16 or
fp32, summed in fp32. `sr_update_leaves` takes every leaf of an optimizer
step: on CUDA tensors it launches the hand-written sm_90a kernel
(`csrc/sr_update.cu`) once per u dtype present, or raises; on CPU tensors
it runs the plain version leaf by leaf (`ops/stochastic.py:
stochastic_round_to_bf16` on the bits that `ops/stochastic.py:philox_bits`
draws from the leaf's seed). Leaf i's bits are Philox 4x32-10 keyed by its
own 64-bit seed, with the 4-element group index within the leaf as the
counter, so a leaf's result does not depend on the device or on how leaves
are batched. `sr_update(p, u, seed)` is the one-leaf call.

The reference gates its Pallas kernel to bf16 leaves of at least one
(256, 128) tile (`can_use_pallas_sr`): that is the TPU's tile size, not a
property of the function, and the kernel here takes any size, so every
bf16 leaf goes to K5 on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from onetrainer_tpu_torch.ops._build import load_library, raw_stream
from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16

# leaves per launch: the kernel holds (leaves + 1) int64 first groups in
# 48 KB of shared memory
MAX_LEAVES = 6000
_U_DTYPES = (torch.float32, torch.bfloat16)


def leaf_table(outs: list, ps: list, us: list, seed_index) -> np.ndarray:
    """The kernel's leaf table (int64): the first 4-element group of each
    leaf in the flat range of all leaves' groups, closed by the total, then
    5 values per leaf: out, p and u data pointers, element count, seed
    index. Group g of the range is group g - first[i] of the leaf i with
    first[i] <= g < first[i + 1]."""
    n = np.fromiter((p.numel() for p in ps), dtype=np.int64, count=len(ps))
    first = np.zeros(len(ps) + 1, dtype=np.int64)
    np.cumsum((n + 3) // 4, out=first[1:])
    rows = np.empty((len(ps), 5), dtype=np.int64)
    for col, tensors in enumerate((outs, ps, us)):
        rows[:, col] = np.fromiter((t.data_ptr() for t in tensors), dtype=np.int64,
                                   count=len(ps))
    rows[:, 3] = n
    rows[:, 4] = seed_index
    return np.concatenate([first, rows.reshape(-1)])


def _check(ps: list, us: list, seeds: torch.Tensor, seed_index: np.ndarray,
           outs: list) -> None:
    if not (len(ps) == len(us) == len(outs) == len(seed_index)):
        raise ValueError(f"{len(ps)} p, {len(us)} u, {len(outs)} out and "
                         f"{len(seed_index)} seed indices: one each per leaf")
    if {p.dtype for p in ps} - {torch.bfloat16} or {o.dtype for o in outs} - {torch.bfloat16}:
        raise TypeError("every p and out must be bfloat16")
    if {u.dtype for u in us} - set(_U_DTYPES):
        raise TypeError("every u must be bfloat16 or float32")
    shapes = [p.shape for p in ps]
    if shapes != [u.shape for u in us] or shapes != [o.shape for o in outs]:
        raise ValueError("each leaf's u and out must have its p's shape")
    if seeds.dtype != torch.int64 or seeds.dim() != 1:
        raise ValueError(f"seeds must be int64 [n], got {seeds.dtype} {tuple(seeds.shape)}")
    if len(seed_index) and (seed_index.min() < 0 or seed_index.max() >= seeds.numel()):
        raise ValueError(f"seed indices must lie in [0, {seeds.numel()})")
    if {t.device for group in (ps, us, outs) for t in group} - {seeds.device}:
        raise ValueError("every p, u and out must be on the seeds' device")


def _check_cuda(ps: list, us: list, outs: list) -> None:
    if not all(t.is_contiguous() for group in (ps, us, outs) for t in group):
        raise ValueError("every p, u and out must be contiguous")
    ptrs = np.fromiter((t.data_ptr() for group in (ps, us, outs) for t in group),
                       dtype=np.int64, count=3 * len(ps))
    align = np.full(3 * len(ps), 8, dtype=np.int64)
    align[len(ps):2 * len(ps)] = [16 if u.dtype == torch.float32 else 8 for u in us]
    if np.any(ptrs % align):
        raise ValueError("every p and out must be 8-byte aligned, every u 8-byte "
                         "(bf16) or 16-byte (fp32) aligned, for vector access")


def sr_update_leaves(ps: list, us: list, seeds: torch.Tensor, *,
                     seed_index=None, outs: list | None = None) -> list:
    """For every leaf i: bf16 ps[i] + us[i], rounded stochastically from
    seeds[seed_index[i]] (`seeds` an int64 vector on the leaves' device;
    seed_index defaults to 0, 1, ...) -> outs[i] (new, or given; it may be
    ps[i]). On the card one launch per u dtype present covers every leaf."""
    if outs is None:
        outs = [torch.empty_like(p) for p in ps]
    seed_index = np.arange(len(ps), dtype=np.int64) if seed_index is None \
        else np.asarray(seed_index, dtype=np.int64)
    _check(ps, us, seeds, seed_index, outs)
    if not seeds.is_cuda:
        for p, u, j, out in zip(ps, us, seed_index.tolist(), outs):
            bits = philox_bits(seeds[j], p.numel()).view(p.shape)
            out.copy_(stochastic_round_to_bf16(p.float() + u.float(), bits))
        return outs
    _check_cuda(ps, us, outs)
    for dtype in _U_DTYPES:
        chosen = [i for i, u in enumerate(us) if u.dtype == dtype]
        for lo in range(0, len(chosen), MAX_LEAVES):
            part = chosen[lo:lo + MAX_LEAVES]
            table = leaf_table([outs[i] for i in part], [ps[i] for i in part],
                               [us[i] for i in part], seed_index[part])
            groups = int(table[len(part)])
            if groups == 0:
                continue
            # one asynchronous copy from pinned memory; the caching host
            # allocator keeps the pinned block until the copy has run
            table = torch.from_numpy(table).pin_memory().to(seeds.device, non_blocking=True)
            rc = load_library().ot_sr_update(
                table.data_ptr(), len(part), groups, int(dtype == torch.float32),
                seeds.data_ptr(), raw_stream(seeds))
            if rc != 0:
                raise RuntimeError(f"sr_update kernel launch failed: cudaError {rc}")
            sr_update_leaves.launches += 1
    return outs


# kernel launches since the last reset (CUDA path only)
sr_update_leaves.launches = 0


def sr_update(p: torch.Tensor, u: torch.Tensor, seed: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """bf16 p + u, rounded stochastically from `seed` (an int64 tensor of
    one element on p's device) -> `out` (new, or given; it may be p): the
    one-leaf call of `sr_update_leaves`."""
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError(f"seed must be one int64, got {seed.dtype} {tuple(seed.shape)}")
    return sr_update_leaves([p], [u], seed.reshape(1),
                            outs=None if out is None else [out])[0]
