"""Scale-and-translate image resizing with `jax.image.resize`'s semantics.

The reference resizes with `jax.image.resize`, which is not
`F.interpolate`: it samples at half-pixel centres, its "bicubic" is Keys'
cubic with a = -0.5 (torch's uses -0.75), and it antialiases by default,
so a downscale widens the kernel by the inverse scale (torch's
"bilinear" does not). `resize` builds the same weight matrix per
resized axis (jax/_src/image/scale.py: compute_weight_mat) and contracts
the input with it, so both sides resample alike. "nearest" picks
floor((i + 0.5) * (in * fp32(1 / out))) in fp32, as jax's compiled
division does.
"""

from __future__ import annotations

import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def weight_matrix(input_size: int, output_size: int, kernel, device=None) -> torch.Tensor:
    """The [input_size, output_size] fp32 resampling weights of one axis,
    the kernel widened by the inverse scale when it shrinks (antialiasing)."""
    inv_scale = torch.tensor(1.0 / (output_size / input_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(output_size, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale.to(device) - 0.5
    x = (sample[None, :] - torch.arange(input_size, dtype=torch.float32,
                                        device=device)[:, None]).abs() / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= input_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _nearest(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    m = x.shape[dim]
    step = torch.tensor(m, dtype=torch.float32) * torch.tensor(1.0 / size, dtype=torch.float32)
    idx = torch.floor((torch.arange(size, dtype=torch.float32) + 0.5) * step).long()
    return x.index_select(dim, idx.to(x.device))


def resize(x: torch.Tensor, size: tuple[int, ...], method: str = "bilinear",
           dims: tuple[int, ...] | None = None) -> torch.Tensor:
    """`x` resized to `size` along `dims` (default: the axes after the
    first, one size per axis), as `jax.image.resize(x, shape, method)`
    does; a float input keeps its dtype, an integer one becomes fp32."""
    dims = dims if dims is not None else tuple(range(1, 1 + len(size)))
    if not x.is_floating_point():
        x = x.float()
    for d, n in zip(dims, size):
        d = d % x.dim()
        if x.shape[d] == n:
            continue
        if method == "nearest":
            x = _nearest(x, n, d)
            continue
        w = weight_matrix(x.shape[d], n, _KERNELS[method], x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w, dims=1), -1, d)
    return x
