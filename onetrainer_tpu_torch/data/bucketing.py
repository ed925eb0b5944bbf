"""Aspect-ratio bucketing and scale/crop computation.

Same behavior class as mgds CalcAspect + AspectBucketing +
SingleAspectCalculation + ScaleCropImage + AspectBatchSorting
(reference: modules/dataLoader/mixin/DataLoaderText2ImageMixin.py:139-294):
- possible bucket resolutions for a target res, quantized (8px SD,
  64px SDXL/FLUX), aspect ratios up to 4:1 both orientations
- each image maps to the bucket with the nearest log-aspect
- scale-to-cover then crop (center, or jittered when crop-jitter is on)
- batches are formed within a bucket so every batch has one static shape
  (XLA: one compiled program per bucket resolution)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def parse_resolutions(resolution: str) -> list[int]:
    """config.resolution: '512' or '512,768' or '896x1152' entries
    (reference accepts comma-separated square sizes and WxH pairs)."""
    out = []
    for token in str(resolution).split(","):
        token = token.strip()
        if not token:
            continue
        if "x" in token:
            w, h = token.lower().split("x")
            out.append((int(h), int(w)))
        else:
            out.append((int(token), int(token)))
    return out


def possible_resolutions(target_h: int, target_w: int, quantization: int,
                         max_aspect: float = 4.0) -> list[tuple[int, int]]:
    """Bucket resolutions with ~the same pixel count as the target."""
    total = target_h * target_w
    q = quantization
    resolutions = set()
    h = q * max(1, int(math.sqrt(total / max_aspect) / q))
    while True:
        w = q * max(1, round(total / h / q))
        aspect = h / w
        if aspect > max_aspect:
            break
        resolutions.add((h, w))
        resolutions.add((w, h))
        h += q
    return sorted(resolutions)


@dataclass(frozen=True)
class ScaleCropInfo:
    bucket: tuple[int, int]          # crop resolution (h, w)
    scale: tuple[int, int]           # scale resolution (h, w), covers crop
    crop_offset: tuple[int, int]     # (top, left)


def assign_bucket(image_h: int, image_w: int,
                  buckets: list[tuple[int, int]]) -> tuple[int, int]:
    aspect = math.log(image_h / image_w)
    return min(buckets, key=lambda b: abs(math.log(b[0] / b[1]) - aspect))


def scale_crop(image_h: int, image_w: int, bucket: tuple[int, int],
               crop_jitter: bool, rng) -> ScaleCropInfo:
    bh, bw = bucket
    scale = max(bh / image_h, bw / image_w)
    sh, sw = max(bh, round(image_h * scale)), max(bw, round(image_w * scale))
    if crop_jitter:
        top = int(rng.integers(0, sh - bh + 1))
        left = int(rng.integers(0, sw - bw + 1))
    else:
        top = (sh - bh) // 2
        left = (sw - bw) // 2
    return ScaleCropInfo(bucket=(bh, bw), scale=(sh, sw), crop_offset=(top, left))


def single_aspect(target_h: int, target_w: int) -> list[tuple[int, int]]:
    return [(target_h, target_w)]


def sort_into_batches(
        bucket_keys: list,
        batch_size: int,
        rng,
        drop_incomplete: bool = True,
) -> list[list[int]]:
    """AspectBatchSorting: shuffle within buckets, emit same-bucket batches,
    shuffle batch order (reference: mgds AspectBatchSorting semantics —
    deterministic given the epoch rng)."""
    by_bucket: dict = {}
    for idx, key in enumerate(bucket_keys):
        by_bucket.setdefault(key, []).append(idx)

    batches: list[list[int]] = []
    for key in sorted(by_bucket, key=str):
        idxs = by_bucket[key]
        order = rng.permutation(len(idxs))
        idxs = [idxs[i] for i in order]
        for i in range(0, len(idxs), batch_size):
            chunk = idxs[i:i + batch_size]
            if len(chunk) == batch_size or not drop_incomplete:
                batches.append(chunk)
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]
