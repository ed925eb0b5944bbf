"""Parity of the torch port's data pipeline with the reference
(onetrainer_tpu/data/loader.py `Text2ImageDataLoader`, data/cache.py), and
the port's standard-library PNG codec (onetrainer_tpu_torch/io/png.py).

Both loaders take one config (the reference's, carried into the port's
copy by to_dict/from_dict) over tests/test_data.py:make_dataset, with
aspect-ratio bucketing, crop jitter, random flips, two image and text
variations and tag shuffling on, and the same deterministic numpy encode
functions (a strided slice of the pixels as the "latent", crc32 token
ids). They give the same epoch plans (entries, variations, buckets) and
bitwise-identical batches, cached and uncached: crops and flips show in
the pixels and the crop metadata.

The PNG codec decodes PNGs Pillow wrote (RGB, RGBA, gray, gray + alpha)
and rows of each of the five filter types bit for bit as Pillow does; a
PNG it writes reads back in Pillow; a resize to the image's own size,
which the port skips, is the identity in Pillow.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from onetrainer_tpu.config.concept_config import ConceptConfig
from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.data import loader as jax_loader
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.data import loader as pt_loader
from onetrainer_tpu_torch.io import png
from tests.test_data import make_dataset


def _encoders():
    def encode_images(images):
        lat = images[:, ::8, ::8, :]
        return {"latent_image": np.concatenate([lat, lat[..., :1] * 0.5], axis=-1),
                "latent_logvar": np.full(lat.shape[:3] + (4,), -2.0, np.float32)}

    def encode_text(prompt):
        ids = np.zeros((16,), np.int32)
        for i, tok in enumerate(prompt.split()[:16]):
            ids[i] = zlib.crc32(tok.encode()) % 100
        return {"tokens": ids}

    return encode_images, encode_text


def _configs(root, cache_dir, caching=True):
    config = TrainConfig.default_values()
    concept = ConceptConfig.default_values()
    concept.path = root
    concept.seed = 42
    concept.image_variations = 2
    concept.text_variations = 2
    concept.image.enable_crop_jitter = True
    concept.image.enable_random_flip = True
    concept.text.enable_tag_shuffling = True
    concept.text.keep_tags_count = 1
    config.concepts = [concept]
    config.batch_size = 2
    config.resolution = "256"
    config.aspect_ratio_bucketing = True
    config.latent_caching = caching
    config.cache_dir = cache_dir
    port = PortTrainConfig.default_values().from_dict(config.to_dict())
    return config, port


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    torch.set_num_threads(1)
    return make_dataset(str(tmp_path_factory.mktemp("ds")), n=6)


def _loaders(root, tmp, caching=True):
    ref_cfg, port_cfg = _configs(root, os.path.join(tmp, "ref_cache"), caching)
    port_cfg.cache_dir = os.path.join(tmp, "port_cache")
    enc_i, enc_t = _encoders()
    return (jax_loader.Text2ImageDataLoader(ref_cfg, enc_i, enc_t, quantization=64),
            pt_loader.Text2ImageDataLoader(port_cfg, enc_i, enc_t, quantization=64))


def _plan(batches):
    return [[(s.entry_index, s.image_variation, s.text_variation, tuple(s.bucket), s.frames)
             for s in batch] for batch in batches]


@pytest.mark.parametrize("epoch", [0, 1, 3])
def test_epoch_plans_and_pixels_match(dataset, tmp_path, epoch):
    ref, port = _loaders(dataset, str(tmp_path))
    assert [e.image_path for e in port.entries] == [e.image_path for e in ref.entries]
    assert port._sizes == ref._sizes and port.buckets == ref.buckets
    assert len(port) == len(ref)
    ref_batches, port_batches = ref.batches_for_epoch(epoch), port.batches_for_epoch(epoch)
    assert _plan(port_batches) == _plan(ref_batches) and len(ref_batches) >= 2
    for ref_batch, port_batch in zip(ref_batches, port_batches):
        for r, p in zip(ref_batch, port_batch):
            ref_img, _, ref_info = ref._load_pixels(r)
            img, mask, info = port._load_pixels(p)
            assert (info.bucket, info.scale, info.crop_offset) == \
                (ref_info.bucket, ref_info.scale, ref_info.crop_offset)
            assert img.dtype == ref_img.dtype and np.array_equal(img, ref_img)
            assert port._prompt(p) == ref._prompt(r)


def _assert_batches_equal(port_batches, ref_batches):
    assert len(port_batches) == len(ref_batches) >= 2
    for got, want in zip(port_batches, ref_batches):
        assert list(got) == list(want)
        for key, value in want.items():
            assert isinstance(got[key], torch.Tensor), key
            assert got[key].numpy().dtype == value.dtype, key
            assert np.array_equal(got[key].numpy(), value), key


@pytest.mark.parametrize("caching", [True, False], ids=["cached", "uncached"])
def test_materialized_batches_are_bitwise_equal(dataset, tmp_path, caching):
    ref, port = _loaders(dataset, str(tmp_path), caching)
    for epoch in (0, 1):
        _assert_batches_equal(list(port.iter_epoch(epoch)), list(ref.iter_epoch(epoch)))
    # a resumed epoch starts at its batch, with the same rows
    _assert_batches_equal(list(port.iter_epoch(1, start_batch=1)),
                          list(ref.iter_epoch(1, start_batch=1)))
    if caching:
        assert sorted(os.listdir(port.cache.cache_dir)) == sorted(os.listdir(ref.cache.cache_dir))


def test_cache_fill_encodes_on_the_calling_thread_only(dataset, tmp_path):
    import threading
    _, port = _loaders(dataset, str(tmp_path))
    threads = set()
    enc_i, enc_t = _encoders()
    port.encode_images = lambda x: threads.add(threading.get_ident()) or enc_i(x)
    port.encode_text = lambda p: threads.add(threading.get_ident()) or enc_t(p)
    port.ensure_cached(port.batches_for_epoch(0))
    batches = list(port.iter_epoch(0))
    assert batches and threads == {threading.get_ident()}


@pytest.mark.parametrize("what", ["depth_maps", "depth_maps_with_conditioning_image"])
def test_unported_inputs_raise(dataset, tmp_path, what):
    """Depth maps raise, with or without custom conditioning images; masks
    (tests/test_torch_port_masks.py) and conditioning images
    (tests/test_torch_port_inpaint.py) are ported."""
    _, port_cfg = _configs(dataset, str(tmp_path))
    port_cfg.model_type = type(port_cfg.model_type).STABLE_DIFFUSION_20_DEPTH
    port_cfg.custom_conditioning_image = what != "depth_maps"
    with pytest.raises(NotImplementedError, match="depth"):
        pt_loader.Text2ImageDataLoader(port_cfg, None, None)
    port_cfg = _configs(dataset, str(tmp_path))[1]
    port_cfg.masked_training = True
    assert pt_loader.Text2ImageDataLoader(port_cfg, None, None).entries


# -- the PNG codec -------------------------------------------------------------------

@pytest.mark.parametrize("mode,shape", [("RGB", (37, 53, 3)), ("RGBA", (40, 21, 4)),
                                        ("L", (33, 50)), ("LA", (19, 23, 2))])
def test_png_decodes_as_pillow_does(tmp_path, mode, shape):
    rng = np.random.default_rng(0)
    noise = (rng.random(shape) * 255).astype(np.uint8)
    smooth = np.cumsum(noise, axis=0).astype(np.uint8)   # Pillow picks other filters
    for i, image in enumerate((noise, smooth)):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(image, mode).save(path)
        with Image.open(path) as img:
            want = np.asarray(img)
            want_rgb = np.asarray(img.convert("RGB"))
        got = png.read_png(path)
        assert np.array_equal(got.reshape(want.shape), want)
        assert np.array_equal(png.read_png_rgb(path), want_rgb)
        assert pt_loader.probe_image_size(path) == (shape[1], shape[0])
        assert np.array_equal(pt_loader.load_image_rgb(path), jax_loader.load_image_rgb(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def test_png_decodes_every_row_filter(tmp_path):
    """Rows filtered with each of the five types in turn (an encoder
    written to the specification here), decoded as Pillow decodes them."""
    rng = np.random.default_rng(1)
    image = (rng.random((20, 17, 3)) * 255).astype(np.uint8)
    rows, prev, raw = image.reshape(20, -1).astype(int), np.zeros(51, int), bytearray()
    for y, row in enumerate(rows):
        kind = y % 5
        raw.append(kind)
        for i in range(len(row)):
            a = row[i - 3] if i >= 3 else 0
            c = prev[i - 3] if i >= 3 else 0
            pred = [0, a, prev[i], (a + prev[i]) >> 1, _paeth(a, prev[i], c)][kind]
            raw.append((row[i] - pred) & 255)
        prev = row
    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(png.SIGNATURE)
        f.write(png._chunk(b"IHDR", struct.pack(">IIBBBBB", 17, 20, 8, 2, 0, 0, 0)))
        f.write(png._chunk(b"IDAT", zlib.compress(bytes(raw))))
        f.write(png._chunk(b"IEND", b""))
    assert np.array_equal(png.read_png(path), image)
    assert np.array_equal(np.asarray(Image.open(path)), image)


def test_png_writer_is_read_by_pillow_and_declines_what_it_cannot_read(tmp_path):
    rng = np.random.default_rng(2)
    for shape in ((24, 31, 3), (24, 31, 4), (24, 31)):
        image = (rng.random(shape) * 255).astype(np.uint8)
        path = str(tmp_path / "w.png")
        png.write_png(path, image)
        assert np.array_equal(np.asarray(Image.open(path)), image)
        assert np.array_equal(png.read_png(path).reshape(image.shape), image)
    # palette, 16-bit and non-PNG files go to Pillow
    Image.fromarray(image).convert("P").save(str(tmp_path / "p.png"))
    Image.fromarray((rng.random((8, 8)) * 65535).astype(np.uint16)).save(
        str(tmp_path / "i16.png"))
    Image.fromarray(image).convert("RGB").save(str(tmp_path / "j.jpg"))
    for name in ("p.png", "i16.png", "j.jpg"):
        path = str(tmp_path / name)
        assert png.read_png(path) is None
        assert np.array_equal(pt_loader.load_image_rgb(path), jax_loader.load_image_rgb(path))


def test_exif_orientation_goes_through_pillow(tmp_path):
    rng = np.random.default_rng(3)
    image = Image.fromarray((rng.random((20, 30, 3)) * 255).astype(np.uint8))
    exif = Image.Exif()
    exif[0x0112] = 6   # rotate 90 degrees: w and h swap
    for name in ("e.jpg", "e.png"):
        path = str(tmp_path / name)
        image.save(path, exif=exif)
        with Image.open(path) as img:
            assert pt_loader.probe_image_size(path) == jax_loader.probe_image_size(img) \
                == (20, 30)
        assert np.array_equal(pt_loader.load_image_rgb(path), jax_loader.load_image_rgb(path))


def test_same_size_resize_is_the_identity_in_pillow():
    """The port skips the resize when the scale equals the image size; the
    reference's bilinear resize there changes nothing."""
    from onetrainer_tpu.data.bucketing import ScaleCropInfo
    rng = np.random.default_rng(4)
    image = (rng.random((40, 24, 3)) * 255).astype(np.uint8).astype(np.float32) / 255.0
    info = ScaleCropInfo(bucket=(32, 16), scale=(40, 24), crop_offset=(3, 5))
    assert np.array_equal(pt_loader.resize_crop(image, info),
                          jax_loader.resize_crop(image, info))
    gray = image[..., :1]
    assert np.array_equal(pt_loader.resize_crop(gray, info), jax_loader.resize_crop(gray, info))
    pil = Image.fromarray((image * 255).astype(np.uint8))
    assert np.array_equal(np.asarray(pil.resize((24, 40), Image.BILINEAR)), np.asarray(pil))
