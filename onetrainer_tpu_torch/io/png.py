"""A standard-library PNG codec for 8-bit, non-interlaced images.

The data loader reads training images and their masks with it and the
sample script writes its output with it, so neither needs Pillow for PNG
files. It
reads gray, gray + alpha, RGB and RGBA at bit depth 8 without interlace
(zlib and the five row filters of the PNG specification); anything else
(palette, 16-bit, interlaced, or a file carrying EXIF) it declines with
None, and the caller takes Pillow. It writes gray, RGB and RGBA with
filter type 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def read_header(path: str) -> dict | None:
    """{"width", "height", "bit_depth", "colour_type", "interlace",
    "exif"} of a PNG file, or None when the file is not a PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        return None
    return _header(data)


def _header(data: bytes) -> dict:
    info = {"exif": False}
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            info.update(width=w, height=h, bit_depth=depth, colour_type=colour,
                        interlace=interlace)
        elif kind == b"eXIf":
            info["exif"] = True
    return info


def readable(info: dict | None) -> bool:
    """True when `read_png` decodes a file with this header."""
    return (info is not None and info.get("bit_depth") == 8
            and info.get("colour_type") in _CHANNELS
            and info.get("interlace") == 0 and not info["exif"])


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += 1 + stride
        if kind == 0:
            row = line.copy()
        elif kind == 1:     # Sub: a running sum per channel, mod 256
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:     # Up
            row = line + prev
        elif kind in (3, 4):
            row = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:   # Average
                    row[i] = (row[i] + ((a + b) >> 1)) & 255
                    continue
                c = up[i - bpp] if i >= bpp else 0   # Paeth
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 255
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        out[y] = row
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray | None:
    """The image as uint8 [H, W, C] (C = 1 gray, 2 gray + alpha, 3 RGB,
    4 RGBA), or None when the file is not a PNG this codec reads."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        return None
    info = _header(data)
    if not readable(info):
        return None
    channels = _CHANNELS[info["colour_type"]]
    raw = zlib.decompress(b"".join(body for kind, body in _chunks(data) if kind == b"IDAT"))
    h, w = info["height"], info["width"]
    return _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)


def read_png_rgb(path: str) -> np.ndarray | None:
    """The image as uint8 RGB [H, W, 3], as Pillow's convert("RGB") gives
    it (gray replicated, alpha dropped), or None as `read_png`."""
    image = read_png(path)
    if image is None:
        return None
    if image.shape[-1] <= 2:
        return np.repeat(image[..., :1], 3, axis=-1)
    return np.ascontiguousarray(image[..., :3])


def read_png_l(path: str) -> np.ndarray | None:
    """The image as uint8 gray [H, W], as Pillow's convert("L") gives it
    (gray as stored, alpha dropped; RGB by the ITU-R 601-2 luma in Pillow's
    integer form, (19595 R + 38470 G + 7471 B + 2^15) >> 16), or None as
    `read_png`."""
    image = read_png(path)
    if image is None:
        return None
    if image.shape[-1] <= 2:
        return np.ascontiguousarray(image[..., 0])
    rgb = image[..., :3].astype(np.uint32)
    luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000
    return (luma >> 16).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 images, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    colour = {1: 0, 3: 2, 4: 6}.get(image.shape[-1])
    if image.ndim != 3 or colour is None:
        raise ValueError(f"write_png takes [H, W], [H, W, 3] or [H, W, 4], got {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
