"""Parity of the torch port's SDXL text-to-image slice with the reference
sampler (onetrainer_tpu/sampling/sdxl_sampler.py), and of the ported
schedules and schedulers with onetrainer_tpu/math/schedules.py and
onetrainer_tpu/sampling/schedulers.py.

The slice runs through the port's entry points (setup/families.py:
get_family -> create_setup -> sample) on the tiny SDXL config with weights
carried from the reference's trees. Torch and JAX draw different noise
from one seed, so the port's single noise draw is fed the reference's
initial latents; DDIM draws nothing after them. Both sides run fp32.

Tolerances: final latents 1e-3 absolute on latents of magnitude ~10 (two
DDIM steps of a CFG-7 combination of fp32 UNet outputs; 5e-5 measured);
the uint8 image
within 2 levels (decode rounding across a truncation boundary). Schedule
tables: betas 1e-6 and alphas_cumprod 5e-6 relative (an fp32 cumulative
product over 1000 steps rounds in another order, 1.4e-6 measured); the
derived tables 5e-4 relative, because 1 - alphas_cumprod near 1 and the
cosine schedule's near-zero betas amplify that rounding (2.6e-4 measured);
ZTSNR-rescaled betas, ratios of neighbouring cumulative products, 2e-5
absolute (7.9e-6 measured). Scheduler steps: 1e-5 relative plus 5e-5
absolute on latents of scale sigma_max ~ 15 (fp32 elementwise math in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.math import schedules as jax_schedules
from onetrainer_tpu.ops import attention as jax_attn
from onetrainer_tpu.sampling import schedulers as jax_sched
from onetrainer_tpu.sampling.sdxl_sampler import sample_stable_diffusion_xl
from onetrainer_tpu.setup.tokenizer import SDTokenizer
from onetrainer_tpu.util.enums import NoiseScheduler
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.math import schedules as pt_schedules
from onetrainer_tpu_torch.sampling import schedulers as pt_sched
from onetrainer_tpu_torch.sampling import sdxl_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_models import tiny_pair

LATENT_ATOL = 1e-3
IMAGE_LEVELS = 2


def _record_steps(monkeypatch, module):
    """Wrap `module.step` to keep every latent it returns."""
    seen = []
    original = module.step

    def step(*args, **kwargs):
        out = original(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(module, "step", step)
    return seen


def _sample_config(size):
    sc = SampleConfig.default_values()
    sc.prompt = "a red cube on a wooden table"
    sc.negative_prompt = "blurry"
    sc.height = sc.width = size
    sc.diffusion_steps = 2
    sc.cfg_scale = 7.0
    sc.seed = 3
    sc.noise_scheduler = NoiseScheduler.DDIM
    return sc


@pytest.mark.parametrize("size,force_flash", [
    (32, False),   # reference on its default CPU path (XLA attention)
    (64, True),    # level-1 self-attention at 16x16 = 256 tokens: the
                   # reference runs K1 (Pallas interpret mode)
])
def test_sdxl_sample_matches_jax(monkeypatch, size, force_flash):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jax_model, (unet, te, te2, vae), port = tiny_pair()
    tok = SDTokenizer(None, max_length=16, vocab_size=100, bos=98, eos=99)
    sc = _sample_config(size)

    if force_flash:
        monkeypatch.setenv("OT_FORCE_FLASH", "1")
    jax_latents = _record_steps(monkeypatch, jax_sched)
    folded_before = jax_attn.STATS["folded"]
    ref = sample_stable_diffusion_xl(jax_model, unet, te, te2, vae, tok, tok, sc)
    assert (jax_attn.STATS["folded"] > folded_before) == force_flash

    # the reference's initial latents (sample_rng_for + split + normal)
    _, noise_rng = jax.random.split(jax.random.PRNGKey(sc.seed))
    latent = size // jax_model.vae_config.spatial_scale
    noise = np.array(jax.random.normal(
        noise_rng, (1, latent, latent, jax_model.vae_config.latent_channels),
        jnp.float32))
    monkeypatch.setattr(pt_sampler, "_initial_latents",
                        lambda shape, generator, device:
                        torch.from_numpy(noise).to(device))
    port_latents = _record_steps(monkeypatch, pt_sched)

    # the port takes its own configs, enums and tokenizer (copies of the
    # reference's), filled from the reference's
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.STABLE_DIFFUSION_XL_10_BASE
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    port.tokenizer = port.tokenizer_2 = PortSDTokenizer(
        None, max_length=16, vocab_size=100, bos=98, eos=99)
    family = get_family(config.model_type)
    port_sc = PortSampleConfig.default_values().from_dict(sc.to_dict())
    out = family.sample(family.create_setup(port, config, 1), port_sc, None)

    assert len(port_latents) == len(jax_latents) == sc.diffusion_steps
    np.testing.assert_allclose(port_latents[-1].numpy(), np.asarray(jax_latents[-1]),
                               atol=LATENT_ATOL, rtol=0)
    assert out.image.dtype == np.uint8 and out.image.shape == ref.image.shape == (
        size, size, 3)
    assert np.abs(out.image.astype(int) - ref.image.astype(int)).max() <= IMAGE_LEVELS


def test_setup_refuses_peft_methods():
    """LoRA is ported; EMBEDDING training and the other PEFT types
    (LoHa, DoRA) are not, and the setup refuses them."""
    _, _, port = tiny_pair()
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.STABLE_DIFFUSION_XL_10_BASE
    refused = [dict(training_method=pt_enums.TrainingMethod.EMBEDDING),
               dict(training_method=pt_enums.TrainingMethod.LORA,
                    peft_type=pt_enums.PeftType.LOHA),
               dict(training_method=pt_enums.TrainingMethod.LORA,
                    lora_decompose=True)]
    for fields in refused:
        case = config.clone()
        for name, value in fields.items():
            setattr(case, name, value)
        with pytest.raises(NotImplementedError):
            get_family(case.model_type).create_setup(port, case, 1)


@pytest.mark.parametrize("schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_schedules_match_jax(schedule):
    ref = jax_schedules.make_betas(schedule)
    betas = pt_schedules.make_betas(schedule)
    np.testing.assert_allclose(betas.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(
        pt_schedules.rescale_betas_zero_terminal_snr(betas).numpy(),
        np.asarray(jax_schedules.rescale_betas_zero_terminal_snr(ref)),
        rtol=0, atol=2e-5)
    ours = pt_schedules.DiffusionScheduleCoefficients.from_betas(betas)
    theirs = jax_schedules.DiffusionScheduleCoefficients.from_betas(ref)
    assert ours.num_timesteps == theirs.num_timesteps
    for name in ours._fields[1:]:
        rtol = {"betas": 1e-6, "alphas_cumprod": 5e-6,
                "alphas_cumprod_prev": 5e-6}.get(name, 5e-4)
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=rtol, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("kind", list(NoiseScheduler))
def test_scheduler_steps_match_jax(kind, prediction_type):
    """Every scheduler, step by step on the same model outputs (the
    stochastic ones without a generator: their deterministic part)."""
    steps = 6
    betas = jax_schedules.make_betas()
    jstate = jax_sched.create_scheduler(kind, betas, steps, prediction_type)
    pstate = pt_sched.create_scheduler(pt_enums.NoiseScheduler(kind.value),
                                       torch.from_numpy(np.array(betas)),
                                       steps, prediction_type)
    np.testing.assert_array_equal(pstate.timesteps, jstate.timesteps)
    if jstate.sigmas is None:
        assert pstate.sigmas is None
    else:
        np.testing.assert_allclose(pstate.sigmas, jstate.sigmas, rtol=1e-5)
    assert pstate.init_noise_sigma == pytest.approx(jstate.init_noise_sigma, rel=1e-5)

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1, 8, 8, 4)) * jstate.init_noise_sigma).astype(np.float32)
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    hist_j, hist_p = {}, {}
    for i in range(steps):
        np.testing.assert_allclose(
            pt_sched.scale_model_input(pstate, xp, i).numpy(),
            np.asarray(jax_sched.scale_model_input(jstate, xj, i)), rtol=1e-5, atol=5e-5)
        out = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
        xj = jax_sched.step(jstate, jnp.asarray(out), i, xj, history=hist_j)
        xp = pt_sched.step(pstate, torch.from_numpy(out), i, xp, history=hist_p)
        assert xp.dtype == torch.float32
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=1e-5, atol=5e-5,
                                   err_msg=f"step {i}")


def test_force_last_timestep_matches_jax():
    betas = jax_schedules.make_betas()
    for steps in (4, 7, 25):
        ref = jax_sched.create_scheduler(NoiseScheduler.DDIM, betas, steps,
                                         force_last_timestep=True)
        ours = pt_sched.create_scheduler(pt_enums.NoiseScheduler.DDIM,
                                         torch.from_numpy(np.array(betas)),
                                         steps, force_last_timestep=True)
        np.testing.assert_array_equal(ours.timesteps, ref.timesteps)


def test_euler_ancestral_noise_is_seeded_unit_normal():
    """Euler-A adds sigma_up * N(0, 1) from the caller's generator: the
    same seed repeats the draw, and the draw is unit normal."""
    state = pt_sched.create_scheduler(pt_enums.NoiseScheduler.EULER_A,
                                      pt_schedules.make_betas(), 10)
    x = torch.randn((1, 64, 64, 4), generator=torch.Generator().manual_seed(0))
    out = torch.zeros_like(x)
    plain = pt_sched.step(state, out, 0, x)
    a = pt_sched.step(state, out, 0, x, generator=torch.Generator().manual_seed(5))
    b = pt_sched.step(state, out, 0, x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    sigma, sigma_next = float(state.sigmas[0]), float(state.sigmas[1])
    sigma_up = (sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2) ** 0.5
    noise = (a - plain) / sigma_up
    assert abs(noise.mean().item()) < 0.03 and abs(noise.std().item() - 1) < 0.03
