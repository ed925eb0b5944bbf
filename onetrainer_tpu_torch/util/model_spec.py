"""SAI modelspec 1.0.0 metadata for safetensors headers
(reference: modules/util/modelSpec/ModelSpec.py, resources/sd_model_spec/*.json).

Copy of onetrainer_tpu/util/model_spec.py; the tensor hash reads torch
tensors' bytes (tests/test_torch_port_copies.py holds both to the
original)."""

from __future__ import annotations

import hashlib
from datetime import datetime

from onetrainer_tpu_torch.util.enums import ModelType, TrainingMethod

_ARCHITECTURES = {
    ModelType.STABLE_DIFFUSION_15: "stable-diffusion-v1",
    ModelType.STABLE_DIFFUSION_15_INPAINTING: "stable-diffusion-v1/inpainting",
    ModelType.STABLE_DIFFUSION_20: "stable-diffusion-v2-768-v",
    ModelType.STABLE_DIFFUSION_20_BASE: "stable-diffusion-v2-512",
    ModelType.STABLE_DIFFUSION_20_INPAINTING: "stable-diffusion-v2-512/inpainting",
    ModelType.STABLE_DIFFUSION_20_DEPTH: "stable-diffusion-v2-512-depth",
    ModelType.STABLE_DIFFUSION_21: "stable-diffusion-v2-768-v",
    ModelType.STABLE_DIFFUSION_21_BASE: "stable-diffusion-v2-512",
    ModelType.STABLE_DIFFUSION_XL_10_BASE: "stable-diffusion-xl-v1-base",
    ModelType.STABLE_DIFFUSION_XL_10_BASE_INPAINTING:
        "stable-diffusion-xl-v1-base/inpainting",
    ModelType.STABLE_DIFFUSION_3: "stable-diffusion-v3-medium",
    ModelType.STABLE_DIFFUSION_35: "stable-diffusion-v3.5-medium",
    ModelType.FLUX_DEV_1: "Flux.1-dev",
    ModelType.FLUX_FILL_DEV_1: "Flux.1-dev/fill",
    ModelType.WUERSTCHEN_2: "wuerstchen-v2",
    ModelType.STABLE_CASCADE_1: "stable-cascade-v1-prior",
    ModelType.PIXART_ALPHA: "pixart-alpha",
    ModelType.PIXART_SIGMA: "pixart-sigma",
    ModelType.SANA: "sana",
    ModelType.HUNYUAN_VIDEO: "hunyuan-video",
    ModelType.HI_DREAM_FULL: "hidream-full",
}


def _git_info() -> dict[str, str]:
    """Best-effort ot_branch/ot_revision header fields (reference:
    DtypeModelSaverMixin._create_safetensors_header + git_util)."""
    import os
    import subprocess
    out = {}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for field, args in (("ot_branch", ["rev-parse", "--abbrev-ref", "HEAD"]),
                        ("ot_revision", ["rev-parse", "HEAD"])):
        try:
            r = subprocess.run(["git", "-C", root, *args],
                               capture_output=True, text=True, timeout=5)
            if r.returncode == 0:
                out[field] = r.stdout.strip()
        except Exception:
            pass
    return out


def make_modelspec_metadata(
        model_type: ModelType,
        training_method: TrainingMethod = TrainingMethod.FINE_TUNE,
        title: str = "",
        resolution: str = "",
        prediction_type: str = "",
        train_config=None,
        tensors: dict | None = None,
) -> dict[str, str]:
    arch = _ARCHITECTURES.get(model_type, str(model_type).lower())
    if training_method == TrainingMethod.LORA:
        arch += "/lora"
    impl = "diffusers" if training_method != TrainingMethod.LORA else \
        "https://github.com/Stability-AI/generative-models"
    data = {
        "modelspec.sai_model_spec": "1.0.0",
        "modelspec.architecture": arch,
        "modelspec.implementation": impl,
        "modelspec.title": title or "onetrainer-tpu model",
        "modelspec.date": datetime.now().strftime("%Y-%m-%d"),
    }
    if resolution:
        data["modelspec.resolution"] = resolution
    if prediction_type:
        data["modelspec.prediction_type"] = prediction_type
    if tensors is not None:
        # reference: DtypeModelSaverMixin.__calculate_safetensors_hash
        data["modelspec.hash_sha256"] = sha256_of_tensors(tensors)
    data.update(_git_info())
    # kohya compat keys so the A1111 webui detects model versions
    # (reference: DtypeModelSaverMixin.py:89-94)
    if model_type.is_stable_diffusion_xl():
        data["ss_base_model_version"] = "sdxl_"
    elif model_type.is_sd_v2():
        data["ss_v2"] = "True"
    # optional embedded train config (reference :70-75, include_train_config)
    if train_config is not None:
        import json as _json
        from onetrainer_tpu_torch.util.enums import ConfigPart
        part = getattr(train_config, "include_train_config", None)
        if part == ConfigPart.SETTINGS:
            data["ot_config"] = _json.dumps(
                train_config.to_settings_dict(secrets=False))
        elif part == ConfigPart.ALL:
            data["ot_config"] = _json.dumps(
                train_config.to_pack_dict(secrets=False))
    return data


def sha256_of_tensors(tensors: dict) -> str:
    """Digest of tensor BYTES only, iterated in sorted-key order — key names
    are not mixed in, matching the reference's checkpoint hash
    (modules/modelSaver/mixin/DtypeModelSaverMixin.py:47-61, which feeds
    safetensors._tobytes(tensor) per sorted key) so external tools that
    recompute modelspec.hash_sha256 agree with ours."""
    from onetrainer_tpu_torch.io.safetensors_io import tensor_bytes
    h = hashlib.sha256()
    for key in sorted(tensors):
        h.update(tensor_bytes(tensors[key]))
    return "0x" + h.hexdigest()
