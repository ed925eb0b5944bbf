"""Fused stochastic-rounding bf16 update (K5).

Counterpart of onetrainer_tpu/ops/pallas_sr.py (`sr_update_pallas`):
out = stochastic_round_bf16(p + u), p bf16, u bf16 or fp32, summed in
fp32. On a CUDA tensor `sr_update` launches the hand-written sm_90a kernel
(`csrc/sr_update.cu`, Philox 4x32-10 keyed by the 64-bit seed, the element
index as the counter) or raises; on a CPU tensor it runs the plain
version (`ops/stochastic.py:stochastic_round_to_bf16`) on the bits that
`ops/stochastic.py:philox_bits` draws from the seed, which are the
kernel's: one seed gives one result on either device.

The reference gates its Pallas kernel to bf16 leaves of at least one
(256, 128) tile (`can_use_pallas_sr`): that is the TPU's tile size, not a
property of the function, and the kernel here takes any size, so every
bf16 leaf goes to K5 on the card.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16


def _check(p: torch.Tensor, u: torch.Tensor, seed: torch.Tensor, out: torch.Tensor):
    if p.dtype != torch.bfloat16:
        raise TypeError(f"p must be bfloat16, got {p.dtype}")
    if u.dtype not in (torch.bfloat16, torch.float32) or u.shape != p.shape:
        raise ValueError(f"u must be bfloat16 or float32 of p's shape {tuple(p.shape)}, "
                         f"got {u.dtype} {tuple(u.shape)}")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError(f"seed must be one int64, got {seed.dtype} {tuple(seed.shape)}")
    if out.dtype != torch.bfloat16 or out.shape != p.shape:
        raise ValueError("out must be bfloat16 of p's shape")
    if not (p.device == u.device == seed.device == out.device):
        raise ValueError("p, u, seed and out must be on one device")


def sr_update(p: torch.Tensor, u: torch.Tensor, seed: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """bf16 p + u, rounded stochastically from `seed` (an int64 tensor of
    one element on p's device) -> `out` (new, or given; it may be p)."""
    if out is None:
        out = torch.empty_like(p)
    _check(p, u, seed, out)
    if not p.is_cuda:
        return out.copy_(stochastic_round_to_bf16(p.float() + u.float(),
                                                  philox_bits(seed, p.numel()).view(p.shape)))
    for name, t in (("p", p), ("u", u), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % (16 if t.dtype == torch.float32 else 8):
            raise ValueError(f"{name} is not aligned for vector access")
    from onetrainer_tpu_torch.ops._build import load_library

    rc = load_library().ot_sr_update(
        out.data_ptr(), p.data_ptr(), u.data_ptr(), int(u.dtype == torch.float32),
        seed.data_ptr(), p.numel(), torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sr_update kernel launch failed: cudaError {rc}")
    sr_update.launches += 1
    return out


# kernel launches since the last reset (CUDA path only)
sr_update.launches = 0
