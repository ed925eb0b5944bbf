"""Host-side image and text augmentations.

Behavioral equivalents of the mgds augmentation modules the reference
composes (reference: modules/dataLoader/mixin/DataLoaderText2ImageMixin.py:
192-234 — Random{Flip,Rotate,Brightness,Contrast,Saturation,Hue},
ShuffleTags/DropTags/CapitalizeTags). Images are numpy float32 HWC in
[0,1]; a per-sample numpy Generator drives every random decision so a
(concept seed, image index, variation) triple is reproducible — the
property the disk cache keys on.

Copy of onetrainer_tpu/data/augments.py (tests/test_torch_port_copies.py
holds it to the original). PIL is imported inside the three functions
that need it (hue jitter, rotation, mask rotate-crop), so the module
imports where Pillow is not installed and only those augmentations need
it.
"""

from __future__ import annotations

import re

import numpy as np
from onetrainer_tpu_torch.config.concept_config import ConceptConfig


# -- image ------------------------------------------------------------------------

def _rand_strength(rng, max_strength: float, fixed: bool) -> float:
    if fixed:
        return max_strength
    return float(rng.uniform(-max_strength, max_strength))


def _adjust_brightness(img: np.ndarray, strength: float) -> np.ndarray:
    return np.clip(img * (1.0 + strength), 0.0, 1.0)


def _adjust_contrast(img: np.ndarray, strength: float) -> np.ndarray:
    mean = img.mean(axis=(0, 1), keepdims=True)
    return np.clip((img - mean) * (1.0 + strength) + mean, 0.0, 1.0)


def _adjust_saturation(img: np.ndarray, strength: float) -> np.ndarray:
    gray = img @ np.asarray([0.299, 0.587, 0.114], dtype=img.dtype)
    gray = gray[..., None]
    return np.clip(gray + (img - gray) * (1.0 + strength), 0.0, 1.0)


def _adjust_hue(img: np.ndarray, strength: float) -> np.ndarray:
    """Rotate hue by strength*180 degrees via PIL HSV."""
    from PIL import Image
    pil = Image.fromarray((img * 255).astype(np.uint8)).convert("HSV")
    h, s, v = pil.split()
    shift = int(strength * 128)
    h = h.point(lambda x: (x + shift) % 256)
    out = Image.merge("HSV", (h, s, v)).convert("RGB")
    return np.asarray(out, dtype=np.float32) / 255.0


def augment_image(
        image: np.ndarray,              # HWC float32 [0,1]
        concept: ConceptConfig,
        rng: np.random.Generator,
        mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Apply the concept's enabled augmentations. Geometric transforms
    (flip/rotate) apply to image and mask; photometric only to image."""
    ic = concept.image

    if ic.enable_random_flip and (ic.enable_fixed_flip or rng.random() < 0.5):
        image = image[:, ::-1]
        if mask is not None:
            mask = mask[:, ::-1]

    if ic.enable_random_rotate or ic.enable_fixed_rotate:
        max_angle = ic.random_rotate_max_angle
        angle = max_angle if ic.enable_fixed_rotate else float(
            rng.uniform(-max_angle, max_angle))
        if abs(angle) > 1e-3:
            from PIL import Image
            pil = Image.fromarray((image * 255).astype(np.uint8))
            image = np.asarray(
                pil.rotate(angle, resample=Image.BILINEAR), np.float32) / 255.0
            if mask is not None:
                mp = Image.fromarray((mask[..., 0] * 255).astype(np.uint8))
                mask = (np.asarray(mp.rotate(angle, resample=Image.NEAREST),
                                   np.float32) / 255.0)[..., None]

    if ic.enable_random_brightness or ic.enable_fixed_brightness:
        image = _adjust_brightness(image, _rand_strength(
            rng, ic.random_brightness_max_strength, ic.enable_fixed_brightness))
    if ic.enable_random_contrast or ic.enable_fixed_contrast:
        image = _adjust_contrast(image, _rand_strength(
            rng, ic.random_contrast_max_strength, ic.enable_fixed_contrast))
    if ic.enable_random_saturation or ic.enable_fixed_saturation:
        image = _adjust_saturation(image, _rand_strength(
            rng, ic.random_saturation_max_strength, ic.enable_fixed_saturation))
    if ic.enable_random_hue or ic.enable_fixed_hue:
        image = _adjust_hue(image, _rand_strength(
            rng, ic.random_hue_max_strength, ic.enable_fixed_hue))

    if mask is not None and ic.enable_random_circular_mask_shrink:
        mask = random_circular_mask_shrink(mask, rng)
    if mask is not None and ic.enable_random_mask_rotate_crop:
        image, mask = random_mask_rotate_crop(
            image, mask, rng,
            min_size=min(image.shape[0], image.shape[1]) // 2)

    return image.astype(np.float32), mask


# -- mask augmentations ------------------------------------------------------------

def random_circular_mask_shrink(mask: np.ndarray, rng) -> np.ndarray:
    """Shrink the masked region to a random circle inside it
    (reference: mgds RandomCircularMaskShrink usage)."""
    ys, xs = np.nonzero(mask[..., 0] > 0.5)
    if len(ys) == 0:
        return mask
    cy, cx = float(rng.choice(ys)), float(rng.choice(xs))
    max_r = max(mask.shape[0], mask.shape[1])
    radius = float(rng.uniform(0.2, 1.0)) * max_r
    yy, xx = np.mgrid[0:mask.shape[0], 0:mask.shape[1]]
    circle = ((yy - cy) ** 2 + (xx - cx) ** 2) <= radius ** 2
    out = mask.copy()
    out[..., 0] = np.where(circle, mask[..., 0], 0.0)
    return out


def random_mask_rotate_crop(image: np.ndarray, mask: np.ndarray, rng,
                            min_size: int = 512,
                            min_padding_percent: float = 10.0,
                            max_padding_percent: float = 30.0,
                            max_rotate_angle: float = 20.0):
    """Rotate image+mask by a random small angle, then crop to the masked
    region's bounding box with random padding — focuses training on the
    masked area (reference: mgds RandomMaskRotateCrop, used at
    DataLoaderText2ImageMixin.py:127 with min_padding 10%, max 30%,
    max angle 20)."""
    angle = float(rng.uniform(-max_rotate_angle, max_rotate_angle))
    if abs(angle) > 1e-3:
        from PIL import Image
        pil = Image.fromarray((image * 255).astype(np.uint8))
        image = np.asarray(pil.rotate(angle, resample=Image.BILINEAR),
                           np.float32) / 255.0
        mp = Image.fromarray((mask[..., 0] * 255).astype(np.uint8))
        mask = (np.asarray(mp.rotate(angle, resample=Image.NEAREST),
                           np.float32) / 255.0)[..., None]

    ys, xs = np.nonzero(mask[..., 0] > 0.5)
    if len(ys) == 0:
        return image, mask
    h, w = mask.shape[:2]
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1

    def pad(extent):
        frac = float(rng.uniform(min_padding_percent, max_padding_percent)) / 100.0
        return int(round(extent * frac))

    y0 = max(0, y0 - pad(y1 - y0))
    y1 = min(h, y1 + pad(y1 - y0))
    x0 = max(0, x0 - pad(x1 - x0))
    x1 = min(w, x1 + pad(x1 - x0))
    # enforce a minimum crop size (expand symmetrically, clamped)
    if y1 - y0 < min_size:
        grow = min_size - (y1 - y0)
        y0 = max(0, y0 - grow // 2)
        y1 = min(h, y0 + max(min_size, y1 - y0))
    if x1 - x0 < min_size:
        grow = min_size - (x1 - x0)
        x0 = max(0, x0 - grow // 2)
        x1 = min(w, x0 + max(min_size, x1 - x0))
    return image[y0:y1, x0:x1], mask[y0:y1, x0:x1]


# -- text -------------------------------------------------------------------------

def _split_tags(prompt: str, delimiter: str) -> list[str]:
    return [t.strip() for t in prompt.split(delimiter) if t.strip()]


def shuffle_tags(prompt: str, delimiter: str, keep_tags_count: int,
                 rng) -> str:
    tags = _split_tags(prompt, delimiter)
    keep = tags[:keep_tags_count]
    rest = tags[keep_tags_count:]
    order = rng.permutation(len(rest))
    rest = [rest[i] for i in order]
    return (delimiter + " ").join(keep + rest)


def drop_tags(prompt: str, concept: ConceptConfig, rng) -> str:
    tc = concept.text
    tags = _split_tags(prompt, tc.tag_delimiter)
    keep = tags[:tc.keep_tags_count]
    rest = tags[tc.keep_tags_count:]

    special = [t.strip() for t in tc.tag_dropout_special_tags.split(tc.tag_delimiter)
               if t.strip()]

    def is_special(tag: str) -> bool:
        if tc.tag_dropout_special_tags_regex:
            return any(re.fullmatch(p, tag) for p in special)
        return tag in special

    mode = tc.tag_dropout_special_tags_mode  # NONE / BLACKLIST / WHITELIST
    def droppable(tag: str) -> bool:
        if mode == "BLACKLIST":
            return not is_special(tag)
        if mode == "WHITELIST":
            return is_special(tag)
        return True

    p = tc.tag_dropout_probability
    if tc.tag_dropout_mode == "FULL":
        if rng.random() < p:
            rest = [t for t in rest if not droppable(t)]
    else:  # RANDOM / RANDOM_WEIGHTED
        rest = [t for t in rest if not (droppable(t) and rng.random() < p)]
    return (tc.tag_delimiter + " ").join(keep + rest)


def randomize_caps(prompt: str, concept: ConceptConfig, rng) -> str:
    tc = concept.text
    if tc.caps_randomize_lowercase:
        prompt = prompt.lower()
    if rng.random() >= tc.caps_randomize_probability:
        return prompt
    modes = [m.strip() for m in tc.caps_randomize_mode.split(",") if m.strip()]
    if not modes:
        return prompt
    mode = modes[int(rng.integers(len(modes)))]
    if mode == "capslock":
        return prompt.upper()
    if mode == "title":
        return prompt.title()
    if mode == "first":
        return prompt[:1].upper() + prompt[1:]
    if mode == "random":
        return "".join(
            c.upper() if rng.random() < 0.2 else c for c in prompt)
    return prompt


def augment_text(prompt: str, concept: ConceptConfig, rng) -> str:
    tc = concept.text
    if tc.tag_dropout_enable:
        prompt = drop_tags(prompt, concept, rng)
    if tc.enable_tag_shuffling:
        prompt = shuffle_tags(prompt, tc.tag_delimiter, tc.keep_tags_count, rng)
    if tc.caps_randomize_enable:
        prompt = randomize_caps(prompt, concept, rng)
    return prompt
