"""The training data loader: scan → bucket → cache → batch → prefetch.

Counterpart of onetrainer_tpu/data/loader.py (`Text2ImageDataLoader`),
with the same epoch plans, cache keys and batches for still images and,
for the video families (`video_mode`), video clips of `config.frames`
consecutive frames from a deterministic start (images stay 1-frame clips):
every random decision derives from (config seed, concept seed, image
path, epoch, variation), so a resumed epoch draws what an uninterrupted
one would. Batches are dicts of torch tensors on the host; the train step
moves them to the model's device.

What differs from the reference:
- PNG files, images, `-masklabel.png` masks and `-condlabel.png`
  conditioning images, are read by the port's standard-library codec
  (io/png.py), which decodes bit for bit as Pillow does (a mask converted
  to gray as Pillow's convert("L")); other formats and EXIF orientation
  need Pillow, imported where they happen. The bilinear resize to the
  bucket's scale (`resize_bilinear`) and the mask's nearest-neighbour
  downscale to the latent size (`resize_nearest`) are done in numpy, bit
  for bit as Pillow does them.
- Video files are read with OpenCV, imported where a video is read or
  probed.
- Inpainting models (`conditioning_image`) cache the VAE latent of a
  conditioning image beside the image's: the `-condlabel` file when the
  config asks for custom conditioning images and the sample has one, else
  the image with its masked region blanked; FLUX.1-fill
  (`fill_mask_channels`) carries the 8x8 pixel-mask patch of each latent
  cell as 64 mask channels. The cache key of such a sample covers its mask
  and conditioning files too. Depth maps raise NotImplementedError; cached
  pixels (VAE fine-tuning) are not ported.
- The encode functions run on the thread that calls `ensure_cached` and,
  without a cache, on the one iterating `iter_epoch`; the prefetch thread
  only reads cached rows.
- `retry_transport`, a remote-transport workaround, is not ported.
"""

from __future__ import annotations

import functools
import math
import os
import queue
import threading
import zlib
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from onetrainer_tpu_torch.config.train_config import TrainConfig
from onetrainer_tpu_torch.data.augments import augment_image, augment_text
from onetrainer_tpu_torch.data.bucketing import (
    assign_bucket, parse_resolutions, possible_resolutions, scale_crop,
    sort_into_batches,
)
from onetrainer_tpu_torch.data.cache import DiskCache
from onetrainer_tpu_torch.data.concepts import (
    SUPPORTED_VIDEO_EXTENSIONS, SampleEntry, balance_entries, scan_concepts,
)
from onetrainer_tpu_torch.io import png
from onetrainer_tpu_torch.util.enums import ConceptType

_EXIF_ORIENTATION = 0x0112
_EXIF_SWAPS_WH = {5, 6, 7, 8}


def load_image_rgb(path: str) -> np.ndarray:
    """HWC float32 RGB in [0, 1], EXIF orientation honoured, as the
    reference's `load_image_rgb`."""
    pixels = png.read_png_rgb(path)
    if pixels is None:
        from PIL import Image, ImageOps
        with Image.open(path) as img:
            img = ImageOps.exif_transpose(img)
            pixels = np.asarray(img.convert("RGB"))
    return np.asarray(pixels, dtype=np.float32) / 255.0


def load_mask(path: str) -> np.ndarray:
    """HW1 float32 mask in [0, 1]: the file converted to 8-bit gray, / 255,
    EXIF orientation honoured, as the reference's `load_mask`."""
    pixels = png.read_png_l(path)
    if pixels is None:
        from PIL import Image, ImageOps
        with Image.open(path) as img:
            img = ImageOps.exif_transpose(img)
            pixels = np.asarray(img.convert("L"))
    return (np.asarray(pixels, dtype=np.float32) / 255.0)[..., None]


def load_video_frames(path: str, n_frames: int,
                      rng: np.random.Generator) -> np.ndarray:
    """[n_frames, H, W, 3] float32 RGB in [0, 1]: consecutive frames from a
    deterministic random start (one draw from `rng` always, so per-frame
    augmentation draws stay aligned), the last frame repeated when the
    video is shorter, as the reference's `load_video_frames`."""
    import cv2
    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
    draw = int(rng.integers(0, 1 << 30))
    start = draw % (total - n_frames + 1) if total > n_frames else 0
    cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    frames = []
    for _ in range(n_frames):
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0)
    cap.release()
    if not frames:
        raise OSError(f"could not read frames from {path}")
    while len(frames) < n_frames:
        frames.append(frames[-1])
    return np.stack(frames)


def _probe_video_size(path: str) -> tuple[int, int]:
    """(w, h) of a video file's frames."""
    import cv2
    cap = cv2.VideoCapture(path)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    if not (w and h):
        raise OSError(path)
    return w, h


def resize_nearest(pixels: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W] resized to [height, width] as Pillow's
    Image.resize(..., NEAREST) does it: source column int(x0 + (x + 1/2)
    sx) with sx = W / width, the positions accumulated one step at a time
    in double precision (libImaging's ImagingScaleAffine), rows alike."""
    def taps(n_in: int, n_out: int) -> np.ndarray:
        step = n_in / n_out
        pos, out = step * 0.5, []
        for _ in range(n_out):
            out.append(min(int(pos), n_in - 1))
            pos += step
        return np.asarray(out, dtype=np.int64)
    h, w = pixels.shape
    if (h, w) == (height, width):
        return pixels.copy()
    return pixels[taps(h, height)[:, None], taps(w, width)[None, :]]


# libImaging's fixed-point resampling: coefficients scaled by 2^22, sums
# rounded by adding half a step and shifted back
_PRECISION_BITS = 22


@functools.lru_cache(maxsize=64)
def _bilinear_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """(source indices [n_out, k], int32 weights [n_out, k]) of Pillow's
    BILINEAR resampling along one axis (libImaging's precompute_coeffs and
    normalize_coeffs_8bpc): a triangle filter whose support is scaled by
    max(n_in / n_out, 1), each output's weights normalized to sum 1 in
    double precision, then rounded to 22-bit fixed point. Unused taps point
    at the first source index with weight 0."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    index = np.zeros((n_out, ksize), np.int64)
    weight = np.zeros((n_out, ksize), np.int32)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        taps = []
        for x in range(xmax):
            d = abs((x + xmin - center + 0.5) * ss)
            taps.append(1.0 - d if d < 1.0 else 0.0)
        total = 0.0
        for w in taps:
            total += w
        for x, w in enumerate(taps):
            if total != 0.0:
                w /= total
            weight[xx, x] = int(0.5 + w * (1 << _PRECISION_BITS))
            index[xx, x] = xmin + x
        index[xx, xmax:] = xmin
    return index, weight


def _resample_axis(pixels: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    """One pass of Pillow's BILINEAR resampling of uint8 `pixels` along
    `axis`: per output, the fixed-point sum over its taps plus half a step,
    shifted back and clipped to 0-255 (ImagingResampleHorizontal_8bpc and
    its vertical twin)."""
    index, weight = _bilinear_taps(pixels.shape[axis], n_out)
    src = np.ascontiguousarray(np.moveaxis(pixels, axis, 0)).astype(np.int32)
    expand = (slice(None),) + (None,) * (src.ndim - 1)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(index.shape[1]):
        acc += src[index[:, k]] * weight[:, k][expand]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(pixels: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] resized to [height, width] as Pillow's
    Image.resize(..., BILINEAR) does it on an "L" or "RGB" image
    (libImaging's ImagingResample): a horizontal pass, then a vertical
    one, each only where that size changes, each rounded to uint8."""
    h, w = pixels.shape[:2]
    if w != width:
        pixels = _resample_axis(pixels, 1, width)
    if h != height:
        pixels = _resample_axis(pixels, 0, height)
    return pixels.copy() if (h, w) == (height, width) else pixels


def probe_image_size(path: str) -> tuple[int, int]:
    """(w, h) after EXIF orientation, without decoding pixels -- the
    aspect-bucket probe must agree with load_image_rgb's transpose."""
    info = png.read_header(path)
    if png.readable(info):
        return info["width"], info["height"]
    from PIL import Image
    with Image.open(path) as img:
        w, h = img.size
        try:
            if img.getexif().get(_EXIF_ORIENTATION, 1) in _EXIF_SWAPS_WH:
                w, h = h, w
        except Exception:
            pass
    return w, h


def resize_crop(image: np.ndarray, info) -> np.ndarray:
    """Scale to `info.scale` (bilinear, through uint8 as the reference
    does) and crop the bucket at `info.crop_offset`."""
    sh, sw = info.scale
    pixels = resize_bilinear((image * 255).astype(np.uint8), sw, sh)
    arr = np.asarray(pixels, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    top, left = info.crop_offset
    bh, bw = info.bucket
    return arr[top:top + bh, left:left + bw]


def _host(value) -> torch.Tensor:
    """An encode function's output (a tensor on any device, or numpy) as a
    host tensor."""
    return torch.as_tensor(value).cpu()


@dataclass
class PreparedSample:
    entry_index: int
    image_variation: int
    text_variation: int
    bucket: tuple[int, int]
    frames: int = 1
    cache_key: str | None = None
    epoch: int = 0


class Text2ImageDataLoader:
    """Text→image loader over still images, and video clips in
    `video_mode`; the family supplies the encode functions.

    encode_images(images float32 NHWC, or clips NTHWC, [-1,1] numpy) ->
        {'latent_image', 'latent_logvar', ...} tensors (any device) or
        numpy arrays; called in bucket-sized batches during cache fill.
    encode_text(prompt str) -> {'tokens', ...} likewise (e.g. the text
        encoder's hidden state when text embeddings are cached).
    They may be set after construction (the trainer sizes its schedules
    from `len(loader)` before it has a setup to encode with).
    """

    def __init__(
            self,
            config: TrainConfig,
            encode_images: Callable | None,
            encode_text: Callable | None,
            quantization: int = 8,
            encode_batch_size: int = 8,
            model_tag: str = "sd",
            latent_scale: int = 8,
            conditioning_image: bool = False,
            fill_mask_channels: bool = False,
            video_mode: bool = False,
            cache_pixels: bool = False,
    ):
        model_type = config.model_type
        if model_type.has_depth_input():
            raise NotImplementedError("the data loader's depth maps are not ported yet")
        self.latent_scale = latent_scale
        # inpainting models: a masked conditioning image per sample
        self.conditioning_image = conditioning_image
        # FLUX.1-fill: the latent mask as 64 channels of 8x8 pixel-mask patches
        self.fill_mask_channels = fill_mask_channels
        # video families: config.frames consecutive frames per video file
        self.video_mode = video_mode
        self.frames = max(int(float(config.frames or 1)), 1) if video_mode else 1
        # the VAE fine-tune: the original pixels ("image", NHWC in [-1, 1])
        # cached beside the latents as the decode's target
        self.cache_pixels = cache_pixels
        self.config = config
        self.encode_images = encode_images
        self.encode_text = encode_text
        self.encode_batch_size = encode_batch_size

        concepts = config.concepts or []
        self.entries: list[SampleEntry] = scan_concepts(
            concepts, masked_training=config.masked_training or model_type.has_mask_input(),
            custom_conditioning_image=config.custom_conditioning_image,
            allow_videos=video_mode)
        if not self.entries:
            # fail loudly: a loader with no samples would otherwise "train"
            # zero steps per epoch and silently save an untrained model
            paths = [c.path for c in concepts if getattr(c, "enabled", True)]
            raise ValueError(
                "no training samples found; check concept paths "
                f"(concepts={len(concepts)}, enabled paths={paths}). If the "
                "config JSON came from to_settings_dict, concepts live in "
                "the separate concept_file_name file.")

        self.resolutions = parse_resolutions(config.resolution)
        self.buckets: list[tuple[int, int]] = []
        for (th, tw) in self.resolutions:
            if config.aspect_ratio_bucketing:
                self.buckets.extend(possible_resolutions(th, tw, quantization))
            else:
                self.buckets.append((th, tw))
        self.buckets = sorted(set(self.buckets))

        # probe image sizes once (header read only)
        self._sizes: list[tuple[int, int]] = []
        for e in self.entries:
            try:
                w, h = (_probe_video_size if self._is_video(e.image_path)
                        else probe_image_size)(e.image_path)
            except OSError:
                w = h = max(self.resolutions[0]) if self.resolutions else 512
            self._sizes.append((h, w))

        self.cache = None
        if config.latent_caching:
            self.cache = DiskCache(config.cache_dir, model_tag)
            if config.clear_cache_before_training and os.path.isdir(config.cache_dir):
                self.cache.clear()

        self._threads = max(int(config.dataloader_threads or 1), 1)

        # RandomLatentMaskRemove: a mask-input model trains a sample fully
        # unmasked with probability config.unmasked_probability (an all-ones
        # latent mask and the conditioning latent of a blank image)
        self.mask_remove_probability = (
            float(config.unmasked_probability or 0.0)
            if model_type.has_mask_input() else 0.0)
        self._blank_cond_latents: dict[tuple, torch.Tensor] = {}

    # -- epoch plan -------------------------------------------------------------

    def _epoch_rng(self, epoch: int) -> np.random.Generator:
        # stable across processes (python's str hash is salted per process;
        # crc32 is not) — deterministic resume depends on this
        return np.random.default_rng([zlib.crc32(b"epoch"), int(epoch)])

    def plan_epoch(self, epoch: int) -> list[PreparedSample]:
        rng = self._epoch_rng(epoch)
        index_list = balance_entries(self.entries, rng)

        samples = []
        for idx in index_list:
            e = self.entries[idx]
            image_variation = epoch % max(e.concept.image_variations, 1)
            text_variation = epoch % max(e.concept.text_variations, 1)
            h, w = self._sizes[idx]
            # per-concept resolution override
            if e.concept.image.enable_resolution_override:
                res = parse_resolutions(e.concept.image.resolution_override)
                buckets = []
                for (th, tw) in res:
                    if self.config.aspect_ratio_bucketing:
                        buckets.extend(possible_resolutions(th, tw, 8))
                    else:
                        buckets.append((th, tw))
            else:
                buckets = self.buckets
            samples.append(PreparedSample(
                entry_index=idx, image_variation=image_variation,
                text_variation=text_variation, bucket=assign_bucket(h, w, buckets),
                frames=self.frames if self._is_video(e.image_path) else 1,
                epoch=epoch))
        return samples

    @staticmethod
    def _is_video(path: str) -> bool:
        return os.path.splitext(path)[1].lower() in SUPPORTED_VIDEO_EXTENSIONS

    def batches_for_epoch(self, epoch: int) -> list[list[PreparedSample]]:
        samples = self.plan_epoch(epoch)
        rng = self._epoch_rng(epoch * 2 + 1)
        batch_idx = sort_into_batches(
            [(s.bucket, s.frames) for s in samples],
            self.config.batch_size, rng)
        return [[samples[i] for i in batch] for batch in batch_idx]

    def __len__(self):
        # approximate steps per epoch (bucketing may drop incomplete batches)
        return max(len(self.plan_epoch(0)) // max(self.config.batch_size, 1), 1)

    # -- sample materialization ---------------------------------------------------

    def _sample_rng(self, entry: SampleEntry, variation: int) -> np.random.Generator:
        return np.random.default_rng(
            [entry.concept.seed % (2**31),
             zlib.crc32(entry.image_path.encode("utf-8")),
             variation])

    def _load_pixels(self, sample: PreparedSample):
        """(image HWC in [-1, 1], mask HW1 in [0, 1], scale/crop info): the
        mask goes through the image's augments, scale and crop; a sample
        without a mask file gets an all-ones mask."""
        e = self.entries[sample.entry_index]
        rng = self._sample_rng(e, sample.image_variation)
        if sample.frames > 1 or (self.video_mode and self._is_video(e.image_path)):
            return self._load_video_pixels(sample, e, rng)
        mask = load_mask(e.mask_path) if e.mask_path else None
        image, mask = augment_image(load_image_rgb(e.image_path), e.concept, rng, mask)
        info = scale_crop(image.shape[0], image.shape[1], sample.bucket,
                          e.concept.image.enable_crop_jitter, rng)
        image = resize_crop(image, info)
        if mask is None:
            mask = np.ones(image.shape[:2] + (1,), np.float32)
        else:
            mask = resize_crop(mask, info)
        return image * 2.0 - 1.0, mask, info

    def _load_video_pixels(self, sample: PreparedSample, e, rng):
        """([F, H, W, 3] clip in [-1, 1], an all-ones mask, scale/crop info):
        every frame augmented, scaled and cropped alike (a fresh generator
        per frame, seeded as the clip's, past its start-frame draw)."""
        video = load_video_frames(e.image_path, sample.frames, rng)
        out_frames, info = [], None
        for frame in video:
            frng = self._sample_rng(e, sample.image_variation)
            frng.integers(0, 1 << 30)   # the start-frame draw
            img, _ = augment_image(frame, e.concept, frng, None)
            info = scale_crop(img.shape[0], img.shape[1], sample.bucket,
                              e.concept.image.enable_crop_jitter, frng)
            out_frames.append(resize_crop(img, info))
        clip = np.stack(out_frames)
        mask = np.ones(clip.shape[1:3] + (1,), np.float32)
        return clip * 2.0 - 1.0, mask, info

    def _conditioning_pixels(self, sample: PreparedSample, image: np.ndarray,
                             mask: np.ndarray, info) -> np.ndarray | None:
        """The conditioning image in [-1, 1] of an inpainting model's sample:
        its `-condlabel` file scaled and cropped as the image, else the
        image with the masked region blanked; None for other models."""
        if not self.conditioning_image:
            return None
        e = self.entries[sample.entry_index]
        if e.cond_path:
            return resize_crop(load_image_rgb(e.cond_path), info) * 2.0 - 1.0
        return image * (1.0 - mask)

    def _prompt(self, sample: PreparedSample) -> str:
        e = self.entries[sample.entry_index]
        rng = self._sample_rng(e, 1000 + sample.text_variation)
        prompt = e.prompt(rng)
        return augment_text(prompt, e.concept, rng)

    def _cache_extra(self, sample: PreparedSample) -> dict:
        e = self.entries[sample.entry_index]
        return {
            "bucket": sample.bucket,
            "frames": sample.frames,
            "text_variation": sample.text_variation,
            "aug": e.concept.image.to_dict(),
            "text": e.concept.text.to_dict(),
            # cached TE states bake in the hidden-state layer skips —
            # changing a skip must invalidate the text cache
            "te_skips": [
                int(getattr(self.config, k, 0) or 0)
                for k in ("text_encoder_layer_skip",
                          "text_encoder_2_layer_skip",
                          "text_encoder_3_layer_skip",
                          "text_encoder_4_layer_skip")],
            **self._conditioning_key(e),
            **({"pixels": True} if self.cache_pixels else {}),
        }

    def _conditioning_key(self, e: SampleEntry) -> dict:
        """An inpainting sample's mask and conditioning files with their
        modification times: editing either changes the cached conditioning
        latent, so it changes the cache key."""
        if not self.conditioning_image:
            return {}

        def stamp(path):
            if not path:
                return None
            try:
                return [os.path.abspath(path), os.path.getmtime(path)]
            except OSError:
                return [os.path.abspath(path), 0.0]
        return {"conditioning": {"mask": stamp(e.mask_path), "cond": stamp(e.cond_path),
                                 "fill_mask_channels": self.fill_mask_channels}}

    def _blank_cond_latent(self, bucket: tuple[int, int]) -> torch.Tensor:
        """The conditioning latent of a blank (all-masked) image at `bucket`,
        encoded once per bucket: RandomLatentMaskRemove's replacement."""
        blank = self._blank_cond_latents.get(bucket)
        if blank is None:
            h, w = bucket
            blank = _host(self.encode_images(
                np.zeros((1, h, w, 3), np.float32))["latent_image"])[0]
            self._blank_cond_latents[bucket] = blank
        return blank

    def _safe_encode(self, images: np.ndarray) -> dict:
        """encode_images, halving the batch on a device out-of-memory error
        (the VAE encode has no cross-sample ops, so splitting is exact)."""
        try:
            return self.encode_images(images)
        except torch.cuda.OutOfMemoryError:
            if images.shape[0] <= 1:
                raise
        half = images.shape[0] // 2
        a = self._safe_encode(images[:half])
        b = self._safe_encode(images[half:])
        return {k: torch.cat([_host(a[k]), _host(b[k])]) for k in a}

    def _cache_key(self, sample: PreparedSample) -> str:
        if sample.cache_key is None:
            e = self.entries[sample.entry_index]
            sample.cache_key = self.cache.key(
                e.image_path, sample.image_variation, self._cache_extra(sample))
        return sample.cache_key

    def ensure_cached(self, batches: list[list[PreparedSample]],
                      on_progress: Callable[[int, int], None] | None = None):
        """Cache-fill pass: encode any missing samples, bucket-batched; the
        blank conditioning latents of mask removal are encoded here too, not
        in the prefetch thread."""
        if self.mask_remove_probability > 0 and self.conditioning_image:
            for bucket in {s.bucket for batch in batches for s in batch}:
                self._blank_cond_latent(bucket)
        if self.cache is None:
            return
        missing = [s for batch in batches for s in batch
                   if not self.cache.has(self._cache_key(s))]
        by_bucket: dict = {}
        for s in missing:
            by_bucket.setdefault((s.bucket, s.frames), []).append(s)
        done = 0
        total = len(missing)
        pool = ThreadPoolExecutor(self._threads) if self._threads > 1 else None
        for bucket, group in by_bucket.items():
            # encode_batch_size is a 512px-equivalent budget: VAE-encode
            # activations grow with pixel count
            (bh, bw), bframes = bucket
            eff = max(1, (self.encode_batch_size * 512 * 512)
                      // (bh * bw * max(bframes, 1)))
            for i in range(0, len(group), eff):
                chunk = group[i:i + eff]
                if pool is not None:
                    loaded = list(pool.map(self._load_pixels, chunk))
                else:
                    loaded = [self._load_pixels(s) for s in chunk]
                encoded = self._safe_encode(np.stack([img for img, _, _ in loaded]))
                encoded_cond = None
                if self.conditioning_image:
                    encoded_cond = self._safe_encode(np.stack([
                        self._conditioning_pixels(s, *pixels)
                        for s, pixels in zip(chunk, loaded)]))["latent_image"]
                for j, (s, (img, mask, info)) in enumerate(zip(chunk, loaded)):
                    tensors = {k: _host(v[j]) for k, v in encoded.items()}
                    if self.cache_pixels:
                        tensors["image"] = _host(np.asarray(img, np.float32))
                    tensors["latent_mask"] = self._latent_mask(mask)
                    tensors.update(self._crop_metadata(s, info))
                    if encoded_cond is not None:
                        tensors["latent_conditioning_image"] = _host(encoded_cond[j])
                    text = self.encode_text(self._prompt(s))
                    tensors.update({k: _host(v) for k, v in text.items()})
                    self.cache.save(s.cache_key, tensors)
                done += len(chunk)
                if on_progress:
                    on_progress(done, total)
        if pool is not None:
            pool.shutdown()

    def _crop_metadata(self, sample: PreparedSample, info) -> dict:
        """SDXL micro-conditioning inputs (original size, crop offset,
        target size — reference: BaseStableDiffusionXLSetup.py:241-267)."""
        h, w = self._sizes[sample.entry_index]
        return {
            "original_resolution": np.asarray([h, w], np.int32),
            "crop_offset": np.asarray(info.crop_offset, np.int32),
            "crop_resolution": np.asarray(info.bucket, np.int32),
        }

    def _latent_mask(self, mask: np.ndarray) -> np.ndarray:
        """The mask at the latent resolution: through uint8 and a
        nearest-neighbour downscale by the VAE's factor, as the reference's;
        FLUX.1-fill's as 64 channels of 8x8 pixel-mask patches."""
        if self.fill_mask_channels:
            from onetrainer_tpu_torch.sampling.inpaint import flux_fill_mask_channels
            return flux_fill_mask_channels(mask, int(self.latent_scale))
        h, w = mask.shape[:2]
        s = self.latent_scale
        pixels = resize_nearest((mask[..., 0] * 255).astype(np.uint8),
                                int(round(w / s)), int(round(h / s)))
        return (np.asarray(pixels, np.float32) / 255.0)[..., None]

    # -- batch materialization ------------------------------------------------------

    def _maybe_remove_mask(self, sample: PreparedSample, row: dict) -> dict:
        """RandomLatentMaskRemove: with `mask_remove_probability` the sample
        trains unmasked (an all-ones latent mask, the blank conditioning
        latent). Drawn per (image, epoch, variation) after the cache, as the
        reference's, so the cached rows serve both outcomes."""
        p = self.mask_remove_probability
        if p <= 0 or "latent_mask" not in row:
            return row
        e = self.entries[sample.entry_index]
        rng = np.random.default_rng([
            zlib.crc32(b"mask_remove"), zlib.crc32(e.image_path.encode("utf-8")),
            int(sample.epoch), int(sample.image_variation)])
        if rng.random() >= p:
            return row
        h, w = sample.bucket
        row = dict(row)
        row["latent_mask"] = _host(self._latent_mask(np.ones((h, w, 1), np.float32))).to(
            row["latent_mask"].dtype)
        if "latent_conditioning_image" in row:
            row["latent_conditioning_image"] = self._blank_cond_latent((h, w)).to(
                row["latent_conditioning_image"].dtype)
        return row

    def _row(self, sample: PreparedSample) -> dict:
        e = self.entries[sample.entry_index]
        if self.cache is not None:
            row = self.cache.load(self._cache_key(sample))
        else:
            img, mask, info = self._load_pixels(sample)
            row = {k: _host(v[0]) for k, v in self.encode_images(img[None]).items()}
            if self.cache_pixels:
                row["image"] = _host(np.asarray(img, np.float32))
            row["latent_mask"] = _host(self._latent_mask(mask))
            row.update({k: _host(v) for k, v in self._crop_metadata(sample, info).items()})
            cond = self._conditioning_pixels(sample, img, mask, info)
            if cond is not None:
                row["latent_conditioning_image"] = _host(
                    self.encode_images(cond[None])["latent_image"])[0]
            row.update({k: _host(v)
                        for k, v in self.encode_text(self._prompt(sample)).items()})
        row = self._maybe_remove_mask(sample, row)
        row["loss_weight"] = torch.tensor(e.concept.loss_weight, dtype=torch.float32)
        row["prior_flag"] = torch.tensor(
            1.0 if e.concept.type == ConceptType.PRIOR_PREDICTION else 0.0,
            dtype=torch.float32)
        return row

    def materialize_batch(self, batch: list[PreparedSample]) -> dict:
        """{name: host tensor [B, ...]} for one batch."""
        if self.cache is not None and self._threads > 1 and len(batch) > 1:
            # parallel cache reads (file IO releases the GIL)
            with ThreadPoolExecutor(self._threads) as pool:
                rows = list(pool.map(self._row, batch))
        else:
            rows = [self._row(s) for s in batch]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    # -- epoch iteration --------------------------------------------------------------

    def iter_epoch(self, epoch: int, start_batch: int = 0,
                   prefetch: int = 2):
        """Yield materialized batches. Cached rows are read ahead by a
        background thread; without a cache each batch is encoded on the
        calling thread when it is asked for."""
        batches = self.batches_for_epoch(epoch)
        self.ensure_cached(batches)
        pending = batches[start_batch:]
        if self.cache is None:
            for batch in pending:
                yield self.materialize_batch(batch)
            return
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = object()

        def worker():
            try:
                for batch in pending:
                    q.put(self.materialize_batch(batch))
                q.put(stop)
            except BaseException as e:  # propagate to the consumer thread
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
