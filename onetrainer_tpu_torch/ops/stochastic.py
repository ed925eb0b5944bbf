"""bf16 stochastic rounding of parameter updates.

Counterpart of onetrainer_tpu/ops/stochastic.py (reference:
modules/util/bf16_stochastic_rounding.py:5-31). fp32 -> bf16 truncation
biases small updates to zero; adding 16 random bits to the dropped
mantissa before truncating makes the rounding unbiased, which lets bf16
weights train without fp32 master copies.

- `stochastic_round_to_bf16(x, bits)` is the plain version: the caller
  hands it the 16 random low bits per element (a test feeds the bits
  `jax.random.bits` drew), or a `torch.Generator` to draw them;
- `philox_bits(seed, n)` draws the bits K5 draws from one seed (Philox
  4x32-10, Salmon et al., SC'11; key = the seed's two 32-bit halves, low
  first; counter = (g, g >> 32, 0, 0) for the group g of elements 4g to
  4g + 3), so that the plain rounding on them is K5's function bit for
  bit;
- `apply_updates_stochastic` applies one optimizer step in place: fp32
  leaves add their update exactly, bf16 leaves go through K5
  (`ops/sr_update.py`, p + u in fp32 rounded stochastically, one launch
  for all of them) with a seed per leaf drawn from the step's generator,
  as the reference splits one key per leaf.

Unsigned 32-bit arithmetic is done in int64 with masks (torch's uint32
support is thin).
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)   # round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)   # key increments (Weyl sequence)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of the 64-bit product a * b, for a and b
    below 2^32, in int64 without overflow: b is split into 16-bit halves."""
    p_hi, p_lo = a * (b >> 16), a * (b & 0xFFFF)       # each < 2^48
    s = ((p_hi & 0xFFFF) << 16) + p_lo                 # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(counter: tuple, key: tuple) -> tuple:
    """Philox 4x32-10 on four int64 tensors (or ints) of 32-bit counter
    words and two 32-bit key words -> four int64 tensors of 32-bit words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seed, n: int, device=None) -> torch.Tensor:
    """The n 32-bit random words (int64) that K5 (csrc/sr_update.cu) draws
    from the 64-bit `seed` (an int, or an int64 tensor of one element):
    word i is output i % 4 of Philox 4x32-10 at counter i // 4."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        seed = int(seed)
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10((g & _MASK32, g >> 32, zero, zero), key)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def stochastic_round_to_bf16(x: torch.Tensor, bits: torch.Tensor | None = None,
                             generator: torch.Generator | None = None) -> torch.Tensor:
    """Round `x` (cast to fp32) to bf16, stochastically on the dropped 16
    mantissa bits: add `bits & 0xFFFF` (or bits drawn from `generator`) to
    the fp32 bit pattern and truncate."""
    x = x.float()
    if bits is None:
        bits = torch.randint(0, 1 << 16, x.shape, generator=generator,
                             device=generator.device, dtype=torch.int64)
    pattern = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (pattern + (bits.to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    signed = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded)
    return signed.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def draw_seeds(n: int, generator: torch.Generator) -> torch.Tensor:
    """n int64 seeds drawn from `generator` on its device (no host sync):
    one per leaf of an update."""
    seeds = torch.empty(n, dtype=torch.int64, device=generator.device)
    return seeds.random_(generator=generator)


@torch.no_grad()
def apply_updates_stochastic(params: list[torch.Tensor], updates: list[torch.Tensor],
                             generator: torch.Generator | None = None,
                             bits: list | None = None, *, seeds: torch.Tensor | None = None,
                             first: int = 0) -> None:
    """params[i] += updates[i] in place; bf16 params round stochastically.

    Each leaf gets its own seed, drawn from `generator` on its device (no
    host sync), and one K5 launch rounds every bf16 leaf on the card. A
    caller that applies one update in chunks of leaves draws the update's
    seeds once (`draw_seeds`) and passes them with each chunk's position
    `first` in the update: leaf i of the chunk takes seeds[first + i], so
    the result is bitwise what one call over every leaf gives. `bits` (one
    tensor of 16 random low bits per bf16 leaf, CPU only) replaces the
    seeds with given bits."""
    from onetrainer_tpu_torch.ops.sr_update import sr_update_leaves
    rounded = [i for i, p in enumerate(params) if p.dtype == torch.bfloat16]
    for p, u in zip(params, updates):
        if p.dtype != torch.bfloat16:
            p.add_(u.to(p.dtype))
    if bits is not None:
        for i in rounded:
            p, u = params[i], updates[i]
            if p.is_cuda:
                raise ValueError("given rounding bits take the plain version, "
                                 "which a CUDA tensor never does")
            p.copy_(stochastic_round_to_bf16(p.float() + u.float(), bits[i]))
        return
    if seeds is None:
        seeds = draw_seeds(len(params), generator)
    ps = [params[i] for i in rounded]
    # a gradient, and so its update, may come in the conv weight's
    # channels-last strides; K5 walks both tensors in one order
    sr_update_leaves(ps, [updates[i].contiguous() for i in rounded], seeds,
                     seed_index=[first + i for i in rounded], outs=ps)
