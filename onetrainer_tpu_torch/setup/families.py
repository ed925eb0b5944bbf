"""Model-family registry: one adapter per family wiring loader, setup and
sampler.

Counterpart of onetrainer_tpu/setup/families.py, SDXL only so far. The
calls mirror the reference's scripts: `get_family(...)`, then
`family.load`, `family.create_setup`, `family.make_encode_fns` (the data
caches) and `setup.train_step` or `family.sample`.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

from onetrainer_tpu_torch.util.enums import ModelType


@dataclass
class ModelFamily:
    name: str
    load: Callable          # (base_dir, config) -> model
    create_setup: Callable  # (model, config, total_steps) -> setup
    make_encode_fns: Callable  # setup -> (encode_images, encode_text)
    sample: Callable        # (setup, sample_config, on_progress) -> SamplerOutput


def _sdxl_load(base_dir, config):
    raise NotImplementedError(
        "loading SDXL checkpoints is not ported yet; build the model with "
        "models.sdxl.create_sdxl_model and io.weights")


def _sdxl_create_setup(model, config, total_steps, steps_per_epoch=100):
    from onetrainer_tpu_torch.setup.sdxl_setup import create_sdxl_setup
    return create_sdxl_setup(model, config, total_steps, steps_per_epoch)


def _sdxl_encode_fns(setup):
    from onetrainer_tpu_torch.setup.sdxl_setup import make_sdxl_encode_fns
    return make_sdxl_encode_fns(setup)


def _sdxl_sample(setup, sample_config, on_progress):
    from onetrainer_tpu_torch.sampling.sdxl_sampler import sample_stable_diffusion_xl
    unet, te, te2, extra = setup.merged_inference_params()
    return sample_stable_diffusion_xl(
        setup.model, unet, te, te2, setup.model.vae,
        setup.tokenizer, setup.tokenizer_2, sample_config,
        extra_embeddings=extra, on_update_progress=on_progress)


def get_family(model_type: ModelType) -> ModelFamily:
    if model_type.is_stable_diffusion_xl():
        return ModelFamily(
            name="sdxl",
            load=_sdxl_load, create_setup=_sdxl_create_setup,
            make_encode_fns=_sdxl_encode_fns, sample=_sdxl_sample,
        )
    raise NotImplementedError(
        f"model family {model_type} is not ported to torch yet")
