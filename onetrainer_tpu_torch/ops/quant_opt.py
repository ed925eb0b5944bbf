"""Block-wise int8 optimizer state, the `_8BIT` optimizers' storage.

Counterpart of onetrainer_tpu/ops/quant_opt.py (reference: the *_8BIT
branches of modules/util/create.py, which use bitsandbytes' 8-bit
optimizers): a float32 state tensor of at least `MIN_SIZE` elements
persists as int8 codes with one fp32 absmax scale per block of `BLOCK`
elements. The codes are spaced quadratically (signed square roots), so
small second-moment entries keep their relative resolution.

The reference's wrapper dequantizes the whole state before the update and
quantizes it after. The port works leaf by leaf inside the update
(train/optimizers.py:`LeafLocal.leaf_updates`): it dequantizes one leaf's
state, updates it, and quantizes it back into the same buffers, so only
one leaf's fp32 state exists at a time. The operations and their order are
the reference's, and `torch.round` rounds half to even as `jnp.round`
does, so the codes are the reference's bit for bit on the same values.
"""

from __future__ import annotations

import torch

BLOCK = 2048
MIN_SIZE = 16384


class Q8:
    """One quantized state tensor: `codes` [blocks, BLOCK] int8 and
    `scales` [blocks, 1] fp32 of a tensor of `shape`."""

    __slots__ = ("codes", "scales", "shape")

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, shape):
        self.codes, self.scales, self.shape = codes, scales, tuple(shape)

    def nbytes(self) -> int:
        return self.codes.numel() + 4 * self.scales.numel()


def eligible(t: torch.Tensor) -> bool:
    """Whether the reference quantizes a state tensor: fp32 and at least
    `MIN_SIZE` elements (ROADMAP F24: not the bf16 state of bf16 params)."""
    return t.dtype == torch.float32 and t.numel() >= MIN_SIZE


def _blocks(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, BLOCK)


@torch.no_grad()
def quantize_into(q: Q8, t: torch.Tensor) -> None:
    """Quantize `t` into `q`'s buffers (the reference's `quantize_leaf`):
    scale = max |block|, code = round(sign(x / s) sqrt(|x / s|) 127)
    clipped to +-127."""
    blocks = _blocks(t)
    torch.amax(blocks.abs(), dim=1, keepdim=True, out=q.scales)
    normed = blocks / torch.clamp(q.scales, min=1e-30)
    del blocks
    codes = torch.sign(normed).mul_(normed.abs_().sqrt_()).mul_(127.0)
    del normed
    q.codes.copy_(codes.round_().clamp_(-127, 127))


def quantize(t: torch.Tensor) -> Q8:
    n_blocks = -(-t.numel() // BLOCK)
    q = Q8(torch.empty((n_blocks, BLOCK), dtype=torch.int8, device=t.device),
           torch.empty((n_blocks, 1), dtype=torch.float32, device=t.device), t.shape)
    quantize_into(q, t)
    return q


@torch.no_grad()
def dequantize(q: Q8) -> torch.Tensor:
    """The fp32 tensor of `q` (the reference's `dequantize_leaf`):
    sign(c) c^2 s with c = code / 127."""
    codes = q.codes.float().div_(127.0)
    blocks = torch.sign(codes).mul_(codes.square()).mul_(q.scales)
    n = 1
    for d in q.shape:
        n *= d
    return blocks.view(-1)[:n].reshape(q.shape)
