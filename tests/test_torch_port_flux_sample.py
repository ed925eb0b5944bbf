"""Parity of the torch port's FLUX sampler (onetrainer_tpu_torch/sampling/
flux_sampler.py, through setup/families.py: get_family -> create_setup ->
sample) with the reference's `sample_flux` on tests/test_flux.py's tiny
FLUX with the same weights, in fp32.

Torch and JAX draw different noise from one seed, so the port's single
draw (`_initial_latents`) is fed the reference's initial latents (its
split of the sample key); the Euler steps draw nothing. The prompt's T5
output at pad ids is zeroed (`prior_attention_mask`) on both sides.
Tolerances: the latents the VAE decodes 1e-4 absolute (three Euler steps
of fp32 velocities summed in another order), the uint8 image within 2
levels (decode rounding across a truncation boundary), the µ-shifted
sigma schedule 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.math.timesteps import flux_mu_shift
from onetrainer_tpu.models.vae import AutoencoderKL
from onetrainer_tpu.sampling.flux_sampler import sample_flux
from onetrainer_tpu.sampling.sd_sampler import sample_rng_for
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.sampling import flux_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_flux import tiny_flux_pair
from tests.test_torch_port_sd3_sample import _DecodeRecorder

LATENT_ATOL = 1e-4
IMAGE_LEVELS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_flux_sigmas_match_the_reference_schedule():
    for steps, (lw, lh) in ((1, (4, 4)), (4, (128, 128)), (28, (64, 96))):
        shift = flux_mu_shift(lw, lh)
        sigmas = np.linspace(1.0, 1.0 / steps, steps)
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        got = pt_sampler.flux_sigmas(steps, lw, lh)
        np.testing.assert_allclose(got[:-1], sigmas, atol=1e-7)
        assert got[-1] == 0.0 and got.dtype == np.float32


def test_flux_sample_matches_jax(monkeypatch):
    jax_model, _, port = tiny_flux_pair(seed=3)
    sc = SampleConfig.default_values()
    sc.prompt = "a red cube on a wooden table"
    sc.height = sc.width = 32
    sc.diffusion_steps = 3
    sc.cfg_scale = 3.5
    sc.seed = 11
    sc.prior_attention_mask = True
    jax_seen, port_seen = [], []
    monkeypatch.setattr(type(jax_model), "vae", property(
        lambda self: _DecodeRecorder(AutoencoderKL(self.vae_config), jax_seen)))
    m = jax_model
    want = sample_flux(m, m.transformer_params, m.te_params, m.te2_params, m.vae_params,
                       m.tokenizer, m.tokenizer_2, sc)
    vc = jax_model.vae_config
    scale = vc.spatial_scale
    _, noise_rng = jax.random.split(sample_rng_for(sc))
    initial = np.asarray(jax.random.normal(
        noise_rng, (1, 32 // scale, 32 // scale, vc.latent_channels), jnp.float32))

    port_sc = PortSampleConfig.default_values().from_dict(sc.to_dict())
    assert port_sc.prior_attention_mask
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.FLUX_DEV_1
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    setup = family.create_setup(port, config, 1)
    assert setup.train_step is None
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
