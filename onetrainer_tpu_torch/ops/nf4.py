"""NF4 dequantization (K4): packed 4-bit codes and block scales -> values.

Counterpart of onetrainer_tpu/ops/nf4_pallas.py (`nf4_dequant_flat`,
`nf4_pad_len`). On a CUDA tensor `nf4_dequant_flat` launches the
hand-written sm_90a kernel (`csrc/nf4_dequant.cu`) or raises; on a CPU
tensor it runs the plain PyTorch version beside it,
`nf4_dequant_reference`. Both compute NF4_CODE[nibble] * scale in fp32 and
cast once, so they agree bit for bit.

Packed layout (half-split, the reference's): byte j holds element j in
its high nibble and element j + n_half in its low nibble; scales are the
fp32 absmax of each block of 64 elements in the original element order.
`ops/quant.py:quantize_nf4` writes it, padding the element count with
`nf4_pad_len`.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.ops._build import load_library, raw_stream

# the 16-level NF4 codebook (Dettmers et al., QLoRA arXiv:2305.14314;
# quantiles of N(0,1) normalized to [-1, 1]; identical to bitsandbytes)
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
NF4_BLOCK = 64   # bnb default blocksize
_LANES = 128
# the reference pads each half to whole (8, 128) TPU tiles; the layout is
# part of the quantized format, so the port keeps that padding
_HALF_UNIT = 8 * _LANES
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def nf4_pad_len(n: int) -> int:
    """Total element count after padding: each half a multiple of 1024."""
    half = (n + 1) // 2
    half_padded = ((half + _HALF_UNIT - 1) // _HALF_UNIT) * _HALF_UNIT
    return 2 * half_padded


def nf4_dequant_reference(packed: torch.Tensor, scales: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: packed uint8 [n_half], scales fp32 [n_half // 32] ->
    [2 * n_half] in `out_dtype`."""
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=packed.device)
    idx = torch.cat([packed >> 4, packed & 0xF]).long()
    vals = code[idx].reshape(-1, NF4_BLOCK) * scales[:, None]
    return vals.reshape(-1).to(out_dtype)


def _check(packed: torch.Tensor, scales: torch.Tensor, out_dtype: torch.dtype):
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise ValueError(f"packed must be uint8 [n_half], got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    n_half = packed.shape[0]
    if n_half % _HALF_UNIT:
        raise ValueError(f"n_half {n_half} is not a multiple of {_HALF_UNIT} "
                         "(pad with nf4_pad_len)")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n_half * 2 // NF4_BLOCK,):
        raise ValueError(f"scales must be fp32 [{n_half * 2 // NF4_BLOCK}], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if scales.device != packed.device:
        raise ValueError("packed and scales must be on one device")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")


def nf4_dequant_flat(packed: torch.Tensor, scales: torch.Tensor,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """packed uint8 [n_half] (half-split layout, n_half a multiple of 1024),
    scales fp32 [n_half // 32] -> [2 * n_half] values in `out_dtype`."""
    _check(packed, scales, out_dtype)
    if not packed.is_cuda:
        return nf4_dequant_reference(packed, scales, out_dtype)
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed and scales must be contiguous")
    if packed.data_ptr() % 8 or scales.data_ptr() % 4:
        raise ValueError("packed must be 8-byte and scales 4-byte aligned")
    n_half = packed.shape[0]
    out = torch.empty(2 * n_half, dtype=out_dtype, device=packed.device)
    rc = load_library().ot_nf4_dequant(
        packed.data_ptr(), scales.data_ptr(), out.data_ptr(), n_half,
        int(out_dtype == torch.float32), raw_stream(packed))
    if rc != 0:
        raise RuntimeError(f"nf4_dequant kernel launch failed: cudaError {rc}")
    nf4_dequant_flat.launches += 1
    return out


# kernel launches since the last reset (CUDA path only)
nf4_dequant_flat.launches = 0
