"""Weight quantization for frozen base models.

Counterpart of onetrainer_tpu/ops/quant.py: per-tensor absmax fp8 (e4m3)
and int8 (`QuantizedArray`), block-64 NF4 (`NF4Array`, the QLoRA format),
their dequantization, and the `quantize_tree` policy as `quantize_module`
over the port's modules. Codes and scales are bit-exact with the
reference's for the same input.

A quantized layer's weight is held in the reference's kernel layout (flax:
dense [in, out], conv [kh, kw, in, out]), because NF4's scale blocks run
over that layout's element order: the same codes and scales as the
reference's, so its quantized trees carry over unchanged
(io/weights.py:quantized_params_from_jax). `dequantized_weight` returns
the torch layout ([out, in] / [out, in, kh, kw]) as a view.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from onetrainer_tpu_torch.ops.nf4 import (
    NF4_BLOCK, NF4_CODE, nf4_dequant_flat, nf4_pad_len,
)


class QuantizedArray(NamedTuple):
    """Per-tensor absmax-scaled quantized array."""
    q: torch.Tensor       # fp8 e4m3 / int8 storage
    scale: torch.Tensor   # fp32 scalar


class NF4Array(NamedTuple):
    """Block-64 NF4: packed 4-bit codes (two per uint8, half-split) and
    per-block absmax scales. 4x smaller than bf16. The reference's other
    block sizes have no caller and are not ported."""
    q: torch.Tensor        # uint8 [nf4_pad_len(n) // 2]
    scales: torch.Tensor   # fp32 [nf4_pad_len(n) // NF4_BLOCK]
    shape: tuple


def is_quantized(x) -> bool:
    return isinstance(x, (QuantizedArray, NF4Array))


def logical_shape(x) -> tuple:
    """The unquantized shape of a (possibly quantized) tensor."""
    if isinstance(x, NF4Array):
        return tuple(x.shape)
    if isinstance(x, QuantizedArray):
        return tuple(x.q.shape)
    return tuple(x.shape)


_FP8_MAX = 448.0   # e4m3 max normal
_INT8_MAX = 127.0


def quantize_array(x: torch.Tensor, dtype: torch.dtype = torch.float8_e4m3fn
                   ) -> QuantizedArray:
    """absmax / qmax scale; fp8 rounds to nearest even, int8 rounds half
    to even and clips to +-127."""
    x32 = x.float()
    absmax = torch.clamp(x32.abs().max(), min=1e-12)
    scale = absmax / (_INT8_MAX if dtype == torch.int8 else _FP8_MAX)
    scaled = x32 / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    else:
        q = scaled.to(dtype)
    return QuantizedArray(q=q, scale=scale)


def dequantize_array(x: QuantizedArray, dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    return (x.q.float() * x.scale).to(dtype)


def quantize_nf4(x: torch.Tensor) -> NF4Array:
    """Half-split packed NF4 of `x`'s elements in their order: pad to
    `nf4_pad_len`, absmax per block, nearest code through the midpoints
    (searchsorted, left side), pack element j with element j + n/2."""
    x32 = x.float().reshape(-1)
    n = x32.numel()
    total = nf4_pad_len(n)
    x32 = torch.nn.functional.pad(x32, (0, total - n)).reshape(-1, NF4_BLOCK)
    scales = torch.clamp(x32.abs().amax(dim=1), min=1e-12)
    normed = x32 / scales[:, None]
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=x.device)
    mids = (code[1:] + code[:-1]) / 2.0
    idx = torch.searchsorted(mids, normed.contiguous()).to(torch.uint8).reshape(-1)
    half = total // 2
    packed = (idx[:half] << 4) | idx[half:]
    return NF4Array(q=packed, scales=scales, shape=tuple(x.shape))


def dequantize_nf4(x: NF4Array, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K4 (`nf4_dequant_flat`) on a CUDA tensor, its plain version on the
    CPU."""
    n = math.prod(x.shape)
    return nf4_dequant_flat(x.q, x.scales, dtype)[:n].view(x.shape)


def maybe_dequantize(x, dtype: torch.dtype = torch.bfloat16):
    if isinstance(x, NF4Array):
        return dequantize_nf4(x, dtype)
    if isinstance(x, QuantizedArray):
        return dequantize_array(x, dtype)
    return x


# -- layers ---------------------------------------------------------------------

def _to_kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """torch weight -> the reference's kernel layout."""
    return w.t() if w.dim() == 2 else w.permute(2, 3, 1, 0)


def _from_kernel_layout(k: torch.Tensor) -> torch.Tensor:
    return k.t() if k.dim() == 2 else k.permute(3, 2, 0, 1)


def weight_shape(weight) -> tuple:
    """The torch-layout shape of a layer's weight, quantized or not."""
    if not is_quantized(weight):
        return tuple(weight.shape)
    shape = logical_shape(weight)
    if len(shape) == 2:
        return shape[1], shape[0]
    kh, kw, cin, cout = shape
    return cout, cin, kh, kw


def dequantized_weight(weight, dtype: torch.dtype) -> torch.Tensor:
    """A layer's weight in torch layout and `dtype`: cast, or dequantized
    from the kernel layout (a transposed view of the fresh values)."""
    if not is_quantized(weight):
        return weight.to(dtype)
    return _from_kernel_layout(maybe_dequantize(weight, dtype))


@torch.no_grad()
def quantize_module(module: nn.Module, dtype="nf4", min_size: int = 4096) -> nn.Module:
    """The reference's `quantize_tree` policy, in place: the weight of
    every `nn.Linear`/`nn.Conv2d` (the reference's `kernel` leaves) with
    at least `min_size` elements becomes an NF4Array (`dtype` "nf4") or a
    QuantizedArray (`dtype` torch.float8_e4m3fn / torch.int8) in kernel
    layout; every other float parameter and buffer (biases, norm scales,
    small weights, embedding tables) is cast to bf16 (the reference's
    `keep_dtype`). Each layer's full-precision weight is dropped as soon
    as its quantized form exists, so the module never holds both."""
    for layer in module.modules():
        if not isinstance(layer, (nn.Linear, nn.Conv2d)):
            continue
        w = layer.weight
        if is_quantized(w) or not w.is_floating_point() or w.numel() < min_size:
            continue
        kernel = _to_kernel_layout(w.detach())
        q = quantize_nf4(kernel) if dtype == "nf4" else quantize_array(kernel, dtype)
        del layer.weight, kernel, w
        layer.weight = q
    for tensor in (*module.parameters(), *module.buffers()):
        if tensor.is_floating_point() and tensor.dtype != torch.bfloat16:
            tensor.data = tensor.data.to(torch.bfloat16)
    return module


def module_is_quantized(module: nn.Module) -> bool:
    return any(is_quantized(getattr(layer, "weight", None))
               for layer in module.modules())
