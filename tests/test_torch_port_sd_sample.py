"""Parity of the torch port's SD 1.5/2.x text-to-image slice with the
reference sampler (onetrainer_tpu/sampling/sd_sampler.py
`sample_stable_diffusion`), and of the port's SD model configurations with
onetrainer_tpu/models/sd.py `create_sd_model`.

The slice runs through the port's entry points (setup/families.py:
get_family -> create_setup -> sample) on the tiny SD models of
tests/test_torch_port_train_sd.py (an SD 1.5 shape, epsilon; an SD 2.x
shape, v-prediction, linear projections, text-encoder layer skip 1) with
weights carried from the reference's trees. Torch and JAX draw different
noise from one seed, so the port's single noise draw is fed the
reference's initial latents; DDIM draws nothing after them. Both sides run
fp32. Tolerances as tests/test_torch_port_sdxl_sample.py states them:
final latents 1e-3 absolute, the uint8 image within 2 levels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.models import sd as jax_sd
from onetrainer_tpu.sampling import schedulers as jax_sched
from onetrainer_tpu.sampling.sd_sampler import sample_stable_diffusion
from onetrainer_tpu.util.enums import ModelType
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.models import sd as pt_sd
from onetrainer_tpu_torch.sampling import schedulers as pt_sched
from onetrainer_tpu_torch.sampling import sd_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_sdxl_sample import (
    IMAGE_LEVELS, LATENT_ATOL, _record_steps, _sample_config,
)
from tests.test_torch_port_train_sd import SHAPES, tiny_sd_pair

TEXT_TO_IMAGE = [ModelType.STABLE_DIFFUSION_15, ModelType.STABLE_DIFFUSION_20,
                 ModelType.STABLE_DIFFUSION_20_BASE, ModelType.STABLE_DIFFUSION_21,
                 ModelType.STABLE_DIFFUSION_21_BASE]
# SD 1.5/2.0 inpainting run since the inpainting slice
# (tests/test_torch_port_inpaint.py); SD 2.0 depth is not ported
NOT_PORTED = [ModelType.STABLE_DIFFUSION_20_DEPTH]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_sd_sample_matches_jax(monkeypatch, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jax_model, _, port = tiny_sd_pair(shape)
    force_v = SHAPES[shape][4]
    if force_v:
        jax_model.force_v_prediction()
    sc = _sample_config(32)

    jax_latents = _record_steps(monkeypatch, jax_sched)
    ref = sample_stable_diffusion(jax_model, jax_model.unet_params, jax_model.te_params,
                                  jax_model.vae_params, jax_model.tokenizer, sc)

    # the reference's initial latents (sample_rng_for + split + normal)
    _, noise_rng = jax.random.split(jax.random.PRNGKey(sc.seed))
    latent = 32 // jax_model.vae_config.spatial_scale
    noise = np.array(jax.random.normal(
        noise_rng, (1, latent, latent, jax_model.vae_config.latent_channels),
        jnp.float32))
    monkeypatch.setattr(pt_sampler, "_initial_latents",
                        lambda shape, generator, device:
                        torch.from_numpy(noise).to(device))
    port_latents = _record_steps(monkeypatch, pt_sched)

    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType(jax_model.model_type.value)
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.force_v_prediction = force_v
    family = get_family(config.model_type)
    setup = family.create_setup(port, config, 1)
    assert port.prediction_type == jax_model.prediction_type
    port_sc = PortSampleConfig.default_values().from_dict(sc.to_dict())
    out = family.sample(setup, port_sc, None)

    assert len(port_latents) == len(jax_latents) == sc.diffusion_steps
    np.testing.assert_allclose(port_latents[-1].numpy(), np.asarray(jax_latents[-1]),
                               atol=LATENT_ATOL, rtol=0)
    assert out.image.dtype == np.uint8 and out.image.shape == ref.image.shape == (32, 32, 3)
    assert np.abs(out.image.astype(int) - ref.image.astype(int)).max() <= IMAGE_LEVELS


@pytest.mark.parametrize("model_type", TEXT_TO_IMAGE, ids=lambda t: t.value)
def test_sd_model_configs_match_jax(model_type):
    """create_sd_model at the published widths: the same UNet, VAE and
    text-encoder configurations, layer skip, prediction type and betas as
    the reference's (modules on "meta": no weights are made)."""
    ref = jax_sd.create_sd_model(model_type)
    port = pt_sd.create_sd_model(pt_enums.ModelType(model_type.value), device="meta")
    for name in ("unet_config", "vae_config", "te_config"):
        ours, theirs = getattr(port, name), getattr(ref, name)
        for field in dataclasses.fields(ours):
            if field.name != "dtype":
                assert getattr(ours, field.name) == getattr(theirs, field.name), \
                    (name, field.name)
    assert port.unet_config.dtype == torch.bfloat16
    assert port.text_encoder_layer_skip == ref.text_encoder_layer_skip
    assert port.prediction_type == ref.prediction_type == "epsilon"
    np.testing.assert_allclose(port.betas.numpy(), np.asarray(ref.betas), rtol=1e-6)
    assert next(port.unet.parameters()).dtype == torch.float32


@pytest.mark.parametrize("model_type", NOT_PORTED, ids=lambda t: t.value)
def test_inpainting_and_depth_types_are_refused(model_type):
    port_type = pt_enums.ModelType(model_type.value)
    with pytest.raises(NotImplementedError):
        pt_sd.create_sd_model(port_type, device="meta")
    with pytest.raises(NotImplementedError):
        get_family(port_type)


def test_sd_load_is_not_ported():
    """The SD loader reads checkpoints now (tests/test_torch_port_io.py
    holds it to the reference); a path that holds none raises rather than
    building a model from nothing, and the depth type's load stays
    unported (its family raises)."""
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.STABLE_DIFFUSION_15
    with pytest.raises(FileNotFoundError):
        get_family(config.model_type).load("unused", config, device="cpu")
    for model_type in NOT_PORTED:
        with pytest.raises(NotImplementedError):
            get_family(pt_enums.ModelType(model_type.value)).load("unused", config)
