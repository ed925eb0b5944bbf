"""Disk cache for VAE latents and text-encoder states.

Replaces mgds DiskCache (reference: per-family data loaders'
cache_modules, e.g. modules/dataLoader/StableDiffusionBaseDataLoader.py:
65-268). One safetensors file per (sample, image variation); text
variations are separate entries inside the file. The key hashes
everything that affects the cached tensors: image path+mtime, crop/scale
resolution, variation index, augmentation-relevant concept config, and a
model tag — so config changes invalidate naturally, matching the
reference's clear_cache_before_training escape hatch without needing it.

Counterpart of onetrainer_tpu/data/cache.py over the port's safetensors
module: rows are saved from torch tensors or numpy arrays and load as
torch tensors on the host.
"""

from __future__ import annotations

import hashlib
import json
import os

import torch

from onetrainer_tpu_torch.io.safetensors_io import load_safetensors, save_safetensors


# bump whenever the decode/augment pipeline changes what cached tensors
# contain for an UNCHANGED (path, mtime, config) tuple. v2: EXIF
# orientation honored (load_image_rgb exif_transpose) — pre-fix caches
# hold rotated/mirrored latents for orientations that keep w==h buckets.
PIPELINE_VERSION = 2


class DiskCache:
    def __init__(self, cache_dir: str, model_tag: str):
        self.cache_dir = cache_dir
        self.model_tag = model_tag
        os.makedirs(cache_dir, exist_ok=True)

    def key(self, image_path: str, variation: int, extra: dict) -> str:
        try:
            mtime = os.path.getmtime(image_path)
        except OSError:
            mtime = 0.0
        payload = json.dumps({
            "pipeline": PIPELINE_VERSION,
            "path": os.path.abspath(image_path),
            "mtime": mtime,
            "variation": variation,
            "model": self.model_tag,
            **extra,
        }, sort_keys=True, default=str)
        return hashlib.sha256(payload.encode()).hexdigest()[:32]

    def path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.safetensors")

    def has(self, key: str) -> bool:
        return os.path.exists(self.path(key))

    def load(self, key: str) -> dict[str, torch.Tensor]:
        return load_safetensors(self.path(key))

    def save(self, key: str, tensors: dict):
        save_safetensors(self.path(key), tensors)

    def clear(self):
        for name in os.listdir(self.cache_dir):
            if name.endswith(".safetensors"):
                try:
                    os.remove(os.path.join(self.cache_dir, name))
                except OSError:
                    pass
