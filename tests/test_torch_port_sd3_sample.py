"""Parity of the torch port's SD3 sampler (onetrainer_tpu_torch/sampling/
sd3_sampler.py, through setup/families.py: get_family -> create_setup ->
sample) with the reference's `sample_sd3` on tests/test_sd3.py's tiny SD3
with the same weights, in fp32.

Torch and JAX draw different noise from one seed, so the port's single
draw (`_initial_latents`) is fed the reference's initial latents; the
Euler steps draw nothing. Tolerances: the latents the VAE decodes 1e-4
absolute (three CFG-5 Euler steps of fp32 velocities summed in another
order), the uint8 image within 2 levels (decode
rounding across a truncation boundary), the sigma schedule 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.models.vae import AutoencoderKL
from onetrainer_tpu.sampling.sd3_sampler import sample_sd3
from onetrainer_tpu.sampling.sd_sampler import sample_rng_for
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.sampling import sd3_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_sd3 import tiny_sd3_pair

LATENT_ATOL = 1e-4
IMAGE_LEVELS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sample_config():
    sc = SampleConfig.default_values()
    sc.prompt = "a red cube on a wooden table"
    sc.negative_prompt = "blurry"
    sc.height = sc.width = 32
    sc.diffusion_steps = 3
    sc.cfg_scale = 5.0
    sc.seed = 11
    return sc


def test_sd3_sigmas_match_the_reference_schedule():
    for steps in (1, 4, 28):
        sigmas = np.linspace(1.0, 1.0 / steps, steps)
        sigmas = 3.0 * sigmas / (1 + 2.0 * sigmas)
        np.testing.assert_allclose(pt_sampler.sd3_sigmas(steps)[:-1], sigmas, atol=1e-7)
        assert pt_sampler.sd3_sigmas(steps)[-1] == 0.0


class _DecodeRecorder:
    """The reference's VAE module, keeping the latents it is applied to."""

    def __init__(self, inner, seen: list):
        self.inner, self.seen = inner, seen

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def apply(self, variables, latents, method=None):
        self.seen.append(np.asarray(latents))
        return self.inner.apply(variables, latents, method=method)


def test_sd3_sample_matches_jax(monkeypatch):
    jax_model, _, port = tiny_sd3_pair(seed=3)
    sc = _sample_config()
    jax_seen, port_seen = [], []
    monkeypatch.setattr(type(jax_model), "vae", property(
        lambda self: _DecodeRecorder(AutoencoderKL(self.vae_config), jax_seen)))
    m = jax_model
    want = sample_sd3(m, m.transformer_params, m.te_params, m.te2_params, m.te3_params,
                      m.vae_params, jax_model.tokenizer, jax_model.tokenizer_2, jax_model.tokenizer_3, sc)
    vc = jax_model.vae_config
    scale = vc.spatial_scale
    initial = np.asarray(jax.random.normal(
        sample_rng_for(sc), (1, 32 // scale, 32 // scale, vc.latent_channels), jnp.float32))

    port_sc = PortSampleConfig.default_values().from_dict(sc.to_dict())
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.STABLE_DIFFUSION_3
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    setup = family.create_setup(port, config, 1)
    monkeypatch.setattr(pt_sampler, "_initial_latents",
                        lambda shape, generator, device: torch.from_numpy(initial.copy()))
    decode = port.vae.decode

    def recorded_decode(latents):
        port_seen.append(latents.numpy().copy())
        return decode(latents)
    monkeypatch.setattr(port.vae, "decode", recorded_decode)
    got = family.sample(setup, port_sc, None)

    # the latents the VAE decodes: after the last Euler step, unscaled and
    # shifted
    assert len(port_seen) == len(jax_seen) == 1
    np.testing.assert_allclose(port_seen[0], jax_seen[0], atol=LATENT_ATOL, rtol=0)
    assert got.image.shape == want.image.shape == (32, 32, 3)
    diff = np.abs(got.image.astype(np.int32) - want.image.astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS and want.image.std() > 0
