"""Masked training's inputs in the torch port against the reference
(onetrainer_tpu/data/loader.py: `load_mask`, the mask through the image's
augments and crop in `_load_pixels`, `_latent_mask`): over a dataset whose
images carry `-masklabel.png` masks (gray and RGB files, one image without
a mask), with aspect-ratio bucketing, crop jitter and random flips, the
port's loader gives every sample's pixel mask and latent mask bit for bit
as the reference's, and its cached batches carry the same `latent_mask`.
The port reads masks with its own PNG codec (gray as Pillow's
convert("L")) and downscales them in numpy as Pillow's NEAREST resize
does: both are held to Pillow here directly as well.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from onetrainer_tpu.data import loader as jax_loader
from onetrainer_tpu_torch.data import loader as pt_loader
from onetrainer_tpu_torch.io import png
from tests.test_data import make_dataset
from tests.test_torch_port_data import _configs, _encoders

MASK_VARIATIONS = 8


@pytest.fixture(scope="module")
def masked_dataset(tmp_path_factory):
    """tests/test_data.py's six images; masks for five of them: gray
    rectangles and noise, and RGB files that convert to gray."""
    torch.set_num_threads(1)
    root = make_dataset(str(tmp_path_factory.mktemp("masked")), n=6)
    rng = np.random.default_rng(1)
    for i in range(5):
        w, h = Image.open(os.path.join(root, f"img{i}.png")).size
        if i % 2:
            pixels = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(pixels, "RGB").save(os.path.join(root, f"img{i}-masklabel.png"))
        else:
            pixels = np.zeros((h, w), np.uint8)
            pixels[h // 5:h // 2, w // 3:] = 255
            pixels[::7] = (rng.random(pixels[::7].shape) * 255).astype(np.uint8)
            Image.fromarray(pixels, "L").save(os.path.join(root, f"img{i}-masklabel.png"))
    return root


def _masked_loaders(root, tmp):
    ref_cfg, port_cfg = _configs(root, os.path.join(tmp, "ref_cache"))
    port_cfg.cache_dir = os.path.join(tmp, "port_cache")
    ref_cfg.masked_training = port_cfg.masked_training = True
    # each image's augments are drawn per variation from a seed that its
    # path (the test run's temporary directory) enters: eight variations
    # make a run without a flip or a crop jitter unlikely on any path
    for cfg in (ref_cfg, port_cfg):
        cfg.concepts[0].image_variations = MASK_VARIATIONS
    enc_i, enc_t = _encoders()
    return (jax_loader.Text2ImageDataLoader(ref_cfg, enc_i, enc_t, quantization=64),
            pt_loader.Text2ImageDataLoader(port_cfg, enc_i, enc_t, quantization=64))


def test_latent_masks_match_the_reference_loader(masked_dataset, tmp_path):
    ref, port = _masked_loaders(masked_dataset, str(tmp_path))
    assert [e.mask_path for e in port.entries] == [e.mask_path for e in ref.entries]
    assert sum(e.mask_path is not None for e in port.entries) == 5
    flipped = cropped = 0
    for epoch in range(MASK_VARIATIONS):   # one variation per epoch
        if epoch >= 2 and cropped and flipped:
            break
        for ref_batch, port_batch in zip(ref.batches_for_epoch(epoch),
                                         port.batches_for_epoch(epoch)):
            for r, p in zip(ref_batch, port_batch):
                _, ref_mask, ref_info = ref._load_pixels(r)
                _, mask, info = port._load_pixels(p)
                assert mask.dtype == ref_mask.dtype and np.array_equal(mask, ref_mask)
                latent = port._latent_mask(mask)
                assert latent.dtype == np.float32 and np.array_equal(
                    latent, ref._latent_mask(ref_mask))
                assert latent.shape == (info.bucket[0] // 8, info.bucket[1] // 8, 1)
                cropped += info.crop_offset != (0, 0)
                entry = port.entries[p.entry_index]
                if entry.mask_path is not None:
                    raw = pt_loader.load_mask(entry.mask_path)
                    flipped += not np.array_equal(
                        mask, pt_loader.resize_crop(raw, info))
    assert cropped and flipped
    batches = list(port.iter_epoch(0))
    ref_batches = list(ref.iter_epoch(0))
    for got, want in zip(batches, ref_batches):
        assert np.array_equal(got["latent_mask"].numpy(), want["latent_mask"])
    assert any(float(b["latent_mask"].min()) < 1.0 for b in batches)


@pytest.mark.parametrize("mode,shape", [("RGB", (37, 53, 3)), ("RGBA", (40, 21, 4)),
                                        ("L", (33, 50)), ("LA", (19, 23, 2))])
def test_png_masks_read_as_pillow_converts_them(tmp_path, mode, shape):
    rng = np.random.default_rng(2)
    pixels = (rng.random(shape) * 255).astype(np.uint8)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(pixels, mode).save(path)
    want = np.asarray(Image.open(path).convert("L"))
    got = png.read_png_l(path)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(pt_loader.load_mask(path)[..., 0],
                          np.asarray(want, np.float32) / 255.0)


@pytest.mark.parametrize("size", [(512, 512), (37, 53), (1000, 777), (129, 257),
                                  (1344, 768), (333, 1000)])
def test_nearest_resize_matches_pillow(size):
    h, w = size
    pixels = (np.random.default_rng(h * w).random((h, w)) * 255).astype(np.uint8)
    for oh, ow in ((round(h / 8), round(w / 8)), (h // 3 + 1, w // 7 + 1), (2 * h, 3 * w),
                   (h, w), (1, 1)):
        want = np.asarray(Image.fromarray(pixels).resize((ow, oh), Image.NEAREST))
        assert np.array_equal(pt_loader.resize_nearest(pixels, ow, oh), want), (oh, ow)
