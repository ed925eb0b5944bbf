"""Self-contained safetensors read/write over torch tensors.

Counterpart of onetrainer_tpu/io/safetensors_io.py, with the same names
and the same bytes on disk (8-byte LE header length + JSON header padded
with spaces to 8 bytes + packed buffers). Tensors are read straight into
torch: each buffer is taken from the mmap as bytes, copied, and
reinterpreted in its dtype, so bf16 and fp8 need no numpy type of their
own. The writer takes torch tensors or numpy arrays (bf16 and fp8 only as
tensors) and writes the reference's metadata headers.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Iterator

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def as_tensor(value) -> torch.Tensor:
    """A torch tensor of `value` (a tensor, a numpy array or a scalar),
    sharing memory where it can."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def tensor_bytes(value) -> memoryview:
    """The raw little-endian bytes of a tensor or array, C order, from the
    host (a tensor on the card is copied over first)."""
    t = as_tensor(value).detach().cpu().contiguous()
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


class SafetensorsFile:
    """Random-access reader over an mmapped safetensors file."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        # copy-on-write: writable to torch.frombuffer, never written back
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)
        (header_len,) = struct.unpack("<Q", self._mm[:8])
        header = json.loads(self._mm[8:8 + header_len].decode("utf-8"))
        self.metadata: dict = header.pop("__metadata__", {})
        self._entries = header
        self._data_start = 8 + header_len

    def keys(self) -> list[str]:
        return list(self._entries.keys())

    def shape(self, key: str) -> tuple[int, ...]:
        return tuple(self._entries[key]["shape"])

    def dtype(self, key: str) -> torch.dtype:
        return _DTYPES[self._entries[key]["dtype"]]

    def tensor(self, key: str, device: torch.device | str | None = None,
               dtype: torch.dtype | None = None) -> torch.Tensor:
        """The tensor `key`, a copy of its bytes on the host, then moved to
        `device` and cast to `dtype` where given (moved first: a cast on the
        card leaves one host copy per tensor)."""
        entry = self._entries[key]
        start, end = entry["data_offsets"]
        stored = _DTYPES[entry["dtype"]]
        if end > start:
            raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - start,
                                   offset=self._data_start + start).clone()
            t = raw.view(stored).reshape(entry["shape"])
        else:
            t = torch.empty(entry["shape"], dtype=stored)
        if device is not None:
            t = t.to(device)
        if dtype is not None:
            t = t.to(dtype)
        return t

    def items(self) -> Iterator[tuple[str, torch.Tensor]]:
        for key in self._entries:
            yield key, self.tensor(key)

    def close(self):
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_safetensors(path: str, device: torch.device | str | None = None,
                     float_dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Every tensor of the file, on `device` (the host by default); with
    `float_dtype`, floating tensors are cast to it and the rest kept."""
    with SafetensorsFile(path) as f:
        return {k: f.tensor(k, device, float_dtype if f.dtype(k).is_floating_point
                            else None) for k in f.keys()}


def load_metadata(path: str) -> dict:
    with SafetensorsFile(path) as f:
        return dict(f.metadata)


def save_safetensors(
        path: str,
        tensors: dict,
        metadata: dict[str, str] | None = None,
):
    """Write a safetensors file of torch tensors or numpy arrays. A 0-dim
    tensor is stored with shape [1], as the reference's writer stores it."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    ordered = []
    for name, value in tensors.items():
        t = as_tensor(value)
        ordered.append((name, t.reshape(-1) if t.ndim == 0 else t))
    for name, t in ordered:
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _DTYPE_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes

    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # pad header to 8-byte alignment (spec recommendation)
    pad = (8 - len(header_bytes) % 8) % 8
    header_bytes += b" " * pad

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for _, t in ordered:
            f.write(tensor_bytes(t))
