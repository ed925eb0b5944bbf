"""Concept folder scanning, prompt sources, and balancing.

Replaces the mgds enumerate/load stages
(reference: modules/dataLoader/mixin/DataLoaderText2ImageMixin.py:49-120
and mgds CollectPaths/ModifyPath/LoadMultipleTexts/SelectInput semantics):
- images collected per concept folder (optionally recursive), with
  `-masklabel.png` / `-condlabel.*` companions excluded from the main list
- prompts from the per-image .txt ('sample'), a concept prompt file
  ('concept'), or the filename ('filename')
- balancing: REPEATS multiplies entries, SAMPLES draws N per epoch
  (reference: mgds variation-group balancing via concept.balancing)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from onetrainer_tpu_torch.config.concept_config import ConceptConfig
from onetrainer_tpu_torch.util.enums import BalancingStrategy, ConceptType

SUPPORTED_IMAGE_EXTENSIONS = {'.bmp', '.jpg', '.jpeg', '.png', '.tif', '.tiff', '.webp'}
SUPPORTED_VIDEO_EXTENSIONS = {'.webm', '.mkv', '.flv', '.avi', '.mov', '.wmv', '.mp4', '.mpeg', '.m4v'}


@dataclass
class SampleEntry:
    image_path: str
    concept: ConceptConfig
    concept_index: int
    mask_path: str | None = None
    cond_path: str | None = None
    prompts: list[str] = field(default_factory=list)

    def prompt(self, rng) -> str:
        if not self.prompts:
            return ""
        if len(self.prompts) == 1:
            return self.prompts[0]
        return self.prompts[int(rng.integers(len(self.prompts)))]


def _read_prompts(path: str) -> list[str]:
    try:
        with open(path, encoding="utf-8") as f:
            lines = [line.strip() for line in f]
        return [line for line in lines if line]
    except OSError:
        return []


def _collect_images(path: str, recursive: bool, allow_videos: bool = False) -> list[str]:
    exts = set(SUPPORTED_IMAGE_EXTENSIONS)
    if allow_videos:
        exts |= SUPPORTED_VIDEO_EXTENSIONS
    found = []
    if not os.path.isdir(path):
        return found
    if recursive:
        for root, _, files in os.walk(path):
            for name in sorted(files):
                found.append(os.path.join(root, name))
    else:
        found = [os.path.join(path, n) for n in sorted(os.listdir(path))]
    out = []
    for p in found:
        stem, ext = os.path.splitext(p)
        if ext.lower() not in exts:
            continue
        if stem.endswith("-masklabel") or stem.endswith("-condlabel"):
            continue
        out.append(p)
    return out


def scan_concept(concept: ConceptConfig, concept_index: int,
                 masked_training: bool = False,
                 custom_conditioning_image: bool = False,
                 allow_videos: bool = False) -> list[SampleEntry]:
    if not concept.enabled:
        return []
    entries = []
    concept_prompts = None
    for image_path in _collect_images(concept.path, concept.include_subdirectories,
                                      allow_videos):
        stem, _ = os.path.splitext(image_path)
        mask_path = stem + "-masklabel.png"
        if not (masked_training and os.path.exists(mask_path)):
            mask_path = None
        cond_path = None
        if custom_conditioning_image:
            for ext in SUPPORTED_IMAGE_EXTENSIONS:
                candidate = stem + "-condlabel" + ext
                if os.path.exists(candidate):
                    cond_path = candidate
                    break

        source = concept.text.prompt_source
        if source == "concept":
            if concept_prompts is None:
                concept_prompts = _read_prompts(concept.text.prompt_path)
            prompts = list(concept_prompts)
        elif source == "filename":
            prompts = [os.path.basename(stem)]
        else:  # 'sample'
            prompts = _read_prompts(stem + ".txt")
            if not prompts:
                prompts = [os.path.basename(stem)]

        entries.append(SampleEntry(
            image_path=image_path, concept=concept, concept_index=concept_index,
            mask_path=mask_path, cond_path=cond_path, prompts=prompts))
    return entries


def scan_concepts(concepts: list[ConceptConfig], masked_training: bool = False,
                  custom_conditioning_image: bool = False,
                  include_validation: bool = False,
                  allow_videos: bool = False) -> list[SampleEntry]:
    entries = []
    for i, concept in enumerate(concepts):
        if concept.type == ConceptType.VALIDATION and not include_validation:
            continue
        entries.extend(scan_concept(
            concept, i, masked_training, custom_conditioning_image, allow_videos))
    return entries


def balance_entries(entries: list[SampleEntry], rng) -> list[int]:
    """Per-epoch index list after balancing. REPEATS: each entry appears
    round(balancing) times (fractional part drawn per epoch); SAMPLES: draw
    `balancing` entries from the concept per epoch."""
    by_concept: dict[int, list[int]] = {}
    for idx, e in enumerate(entries):
        by_concept.setdefault(e.concept_index, []).append(idx)

    out: list[int] = []
    for cidx, idxs in by_concept.items():
        concept = entries[idxs[0]].concept
        strength = concept.balancing
        if concept.balancing_strategy == BalancingStrategy.SAMPLES:
            n = int(strength)
            if n >= len(idxs):
                picks = list(idxs) * (n // len(idxs))
                rest = n % len(idxs)
                if rest:
                    picks += list(rng.choice(idxs, size=rest, replace=False))
            else:
                picks = list(rng.choice(idxs, size=n, replace=False))
            out.extend(int(p) for p in picks)
        else:  # REPEATS
            whole = int(strength)
            frac = strength - whole
            for idx in idxs:
                out.extend([idx] * whole)
                if frac > 0 and rng.random() < frac:
                    out.append(idx)
    return out
