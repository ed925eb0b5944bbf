"""Parity of the torch port's HunyuanVideo sampler (onetrainer_tpu_torch/
sampling/hunyuan_sampler.py, through setup/families.py: get_family ->
create_setup -> sample) with the reference's `sample_hunyuan_video` on
tests/test_trainer_hunyuan.py's tiny HunyuanVideo with the same weights, in
fp32.

Torch and JAX draw different noise from one seed, so the port's single
draw (`_initial_latents`) is fed the reference's initial latents (its
split of the sample key); the Euler steps draw nothing. 7 frames are asked
for, quantized to 5 (4k + 1: 2 latent frames); the transformer's
timestep features come from one frequency table on both sides
(tests/test_torch_port_hunyuan.py: shared_timestep_table, ROADMAP F11).
Tolerances: the latents the VAE decodes 1e-4 absolute (three Euler steps
of fp32 flows summed in another order), every uint8 frame within 2 levels
(decode rounding across a truncation boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.models.video_vae import AutoencoderKLVideo
from onetrainer_tpu.sampling.hunyuan_sampler import sample_hunyuan_video
from onetrainer_tpu.sampling.sd_sampler import sample_rng_for
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.sampling import hunyuan_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_hunyuan import (  # noqa: F401  (fixtures)
    one_torch_thread, shared_timestep_table, tiny_hunyuan_pair,
)
from tests.test_torch_port_sd3_sample import _DecodeRecorder


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LATENT_ATOL = 1e-4
IMAGE_LEVELS = 2


def test_hunyuan_sample_matches_jax(monkeypatch, shared_timestep_table):
    jax_model, _, port = tiny_hunyuan_pair(seed=3)
    sc = SampleConfig.default_values()
    sc.prompt = "a red cube on a wooden table"
    sc.height = sc.width = 32
    sc.frames = 7
    sc.diffusion_steps = 3
    sc.cfg_scale = 6.0
    sc.seed = 11
    jax_seen, port_seen = [], []
    monkeypatch.setattr(type(jax_model), "vae", property(
        lambda self: _DecodeRecorder(AutoencoderKLVideo(self.vae_config), jax_seen)))
    m = jax_model
    want = sample_hunyuan_video(m, m.transformer_params, m.te_params, m.te2_params,
                                m.vae_params, m.tokenizer, m.tokenizer_2, sc)
    vc = jax_model.vae_config
    _, noise_rng = jax.random.split(sample_rng_for(sc))
    initial = np.asarray(jax.random.normal(
        noise_rng, (1, 2, 32 // vc.spatial_scale, 32 // vc.spatial_scale,
                    vc.latent_channels), jnp.float32))

    port_sc = PortSampleConfig.default_values().from_dict(sc.to_dict())
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.HUNYUAN_VIDEO
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

    # the latents the VAE decodes: after the last Euler step, unscaled
    assert len(port_seen) == len(jax_seen) == 1
    np.testing.assert_allclose(port_seen[0], jax_seen[0], atol=LATENT_ATOL, rtol=0)
    assert got.video.shape == want.video.shape == (5, 32, 32, 3)
    assert np.array_equal(got.image, got.video[0]) and got.video.dtype == np.uint8
    diff = np.abs(got.video.astype(np.int32) - want.video.astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS and want.video.std() > 0


def test_write_video_writes_the_frames(tmp_path):
    """`write_video` writes an mp4 OpenCV reads back at the frames' size
    and count."""
    import cv2
    frames = np.random.default_rng(0).integers(0, 256, (5, 32, 48, 3), dtype=np.uint8)
    path = str(tmp_path / "clip.mp4")
    pt_sampler.write_video(path, frames, fps=8.0)
    cap = cv2.VideoCapture(path)
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert size == (48, 32) and count == 5
