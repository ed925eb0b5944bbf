"""Parity of the torch port's SDXL LoRA training slice with the reference
(onetrainer_tpu/setup/sdxl_setup.py `create_sdxl_setup`, LORA branch, and
onetrainer_tpu/train/sdxl_train_step.py `make_sdxl_train_step`).

Both sides are built through their setup entry points from one config
(the reference's `TrainConfig`, carried into the port's copy by
`to_dict`/`from_dict`) on a tiny SDXL with the same weights. The port's
adapters are set to the reference's initial adapters
(`io.weights.lora_params_from_jax`), and its batch comes through its own
`make_sdxl_encode_fns` from the same image and prompts. Torch and JAX draw
different numbers from one seed, so the reference's own key splits
(`train_step` :182, `loss_fn` :163, `sdxl_predict` :90) are replayed to get
the timesteps, diffusion noise and latent-sampling noise JAX drew, and the
port's step takes them as overrides. Both sides run fp32.

The UNet's first block is 64 channels wide (not the 32 of
tests/test_sdxl.py): with GroupNorm(32, 32) a resnet's time_emb_proj feeds
a per-channel constant that the norm removes, so its exact gradient is
zero and AdamW would turn each side's rounding noise into +-lr steps of
random sign.

Tolerances: loss and grad_norm 1e-4 relative (fp32 networks summed in
another order); the LoRA tensors of each group 1e-4 relative L2 after two
steps, over the group as a whole: AdamW divides by sqrt(v) + 1e-8, so an
element whose gradient is ~1e-8 moves by a share of lr that its rounding
decides, and one such element can dominate a small tensor's difference
(tests/test_torch_port_train_math.py holds the update itself per
element, on gradients without such elements); cached latents and text
embeddings 1e-4 absolute; the tx_only-checkpointed step equals the plain
one exactly (the recompute runs the same ops on the same values); the
LoRA sample (the reference's from merged weights, the port's through the
adapted layers), final latents 1e-3 absolute and the image within 2
levels, as tests/test_torch_port_sdxl_sample.py holds the base model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.math.noise import create_noise as jax_create_noise
from onetrainer_tpu.math.timesteps import sample_timesteps_discrete as jax_timesteps
from onetrainer_tpu.sampling import schedulers as jax_sched
from onetrainer_tpu.sampling.sdxl_sampler import sample_stable_diffusion_xl
from onetrainer_tpu.setup import sdxl_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import SDTokenizer
from onetrainer_tpu.util.enums import ModelType, TrainingMethod
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.weights import lora_params_from_jax, sdxl_params_from_flax
from onetrainer_tpu_torch.models.unet import BasicTransformerBlock
from onetrainer_tpu_torch.sampling import schedulers as pt_sched
from onetrainer_tpu_torch.sampling import sdxl_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.util.enums import DataType as PortDataType
from tests.test_sdxl import tiny_sdxl_model
from tests.test_torch_port_models import port_model_like, random_flax_params
from tests.test_torch_port_sdxl_sample import _record_steps, _sample_config

REL = 1e-4
CACHE_ATOL = 1e-4
LATENT_ATOL = 1e-3
IMAGE_LEVELS = 2
STEPS = 2
SEED = 5
PROMPTS = ("a red cube on a wooden table", "a photograph of a blue sphere")


def _tok(cls):
    return cls(None, max_length=16, vocab_size=100, bos=98, eos=99)


def _jax_model():
    model = tiny_sdxl_model()
    model.unet_config = dataclasses.replace(model.unet_config,
                                            block_out_channels=(64, 64))
    model.tokenizer = model.tokenizer_2 = _tok(SDTokenizer)
    return model


def _port_model(jax_model, params, remat):
    """The port's model with the reference's configs and weights; `remat`
    None or a policy name for gradient checkpointing."""
    cfg = jax_model.unet_config
    if remat is not None:
        cfg = dataclasses.replace(cfg, gradient_checkpointing=True, remat_policy=remat)
    port = port_model_like(dataclasses.replace(jax_model, unet_config=cfg))
    sdxl_params_from_flax(port, *params)
    port.tokenizer = port.tokenizer_2 = _tok(PortSDTokenizer)
    return port


def _configs(train_te: bool):
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_XL_10_BASE
    config.training_method = TrainingMethod.LORA
    config.batch_size = 2
    config.lora_rank = 4
    config.lora_alpha = 8.0
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0   # lr > 0 from the first step
    config.text_encoder.train = train_te
    config.text_encoder_2.train = train_te
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _images():
    rng = np.random.default_rng(SEED)
    return rng.uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)


def _batch(encode_images, encode_text, images, as_array):
    """A batch of two from the caches: latents of `images`, one prompt per
    sample, 32x32 crop metadata."""
    latents = encode_images(images)
    texts = [encode_text(p) for p in PROMPTS]
    batch = {name: as_array(value) for name, value in latents.items()}
    for name in texts[0]:
        batch[name] = as_array(np.stack([np.asarray(t[name]) for t in texts]))
    batch["original_resolution"] = as_array(np.full((2, 2), 32, np.int32))
    batch["crop_offset"] = as_array(np.zeros((2, 2), np.int32))
    batch["crop_resolution"] = as_array(np.full((2, 2), 32, np.int32))
    batch["loss_weight"] = as_array(np.ones((2,), np.float32))
    return batch


def _jax_draws(step_cfg, batch, rng, step):
    """The timesteps, noise and latent-sampling noise that the reference's
    step `step` draws from `rng` (its own key splits)."""
    rng_loss, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, rng_predict = jax.random.split(rng_loss)
    rng_t, rng_noise, rng_sample = jax.random.split(rng_predict, 3)
    latent = batch["latent_image"]
    return {
        "timestep": np.asarray(jax_timesteps(
            rng_t, latent.shape[0], step_cfg.timestep,
            num_train_timesteps=step_cfg.num_train_timesteps)),
        "noise": np.asarray(jax_create_noise(
            rng_noise, latent.shape, latent.dtype, step_cfg.offset_noise_weight,
            step_cfg.perturbation_noise_weight)),
        "latent_noise": np.asarray(jax.random.normal(rng_sample, latent.shape,
                                                     latent.dtype)),
    }


def _reference(train_te: bool) -> dict:
    """Two reference LoRA steps from the setup entry point."""
    jax_model = _jax_model()
    port = port_model_like(jax_model)
    params = random_flax_params(port, seed=1)
    (jax_model.unet_params, jax_model.te_params, jax_model.te2_params,
     jax_model.vae_params) = jax.tree.map(jnp.asarray, params)
    config, port_config = _configs(train_te)
    setup = jax_setup.create_sdxl_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    encode_images, encode_text = jax_setup.make_sdxl_encode_fns(setup)
    images = _images()
    batch = _batch(encode_images, encode_text, images, jnp.asarray)
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = _jax_draws(setup.step_cfg, batch, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    setup.state = state
    return dict(jax_model=jax_model, params=params, setup=setup, init=init,
                images=images, batch=jax.device_get(batch), steps=steps,
                port_config=port_config)


@pytest.fixture(scope="module")
def cached_reference():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _reference(train_te=False)


@pytest.fixture(scope="module")
def te_reference():
    return _reference(train_te=True)


def _port_run(ref, remat=None):
    """The port's setup from the same config and weights, the reference's
    initial adapters, its own cached batch, and two steps on the
    reference's draws. -> (setup, per-step metrics, lora_up max after
    step 1, BasicTransformerBlock forward calls)."""
    port = _port_model(ref["jax_model"], ref["params"], remat)
    family = get_family(ref["port_config"].model_type)
    setup = family.create_setup(port, ref["port_config"], 10)
    assert set(setup.state.params) == set(ref["init"])
    with torch.no_grad():
        for group, adapters in ref["init"].items():
            carried = lora_params_from_jax(adapters, device="cpu")
            assert set(carried) == set(setup.state.params[group])
            for key, entry in carried.items():
                for name, value in entry.items():
                    setup.state.params[group][key][name].copy_(value)

    encode_images, encode_text = family.make_encode_fns(setup)
    batch = _batch(encode_images, encode_text, torch.from_numpy(ref["images"]),
                   torch.as_tensor)
    for name, value in ref["batch"].items():
        if np.issubdtype(np.asarray(value).dtype, np.floating):
            np.testing.assert_allclose(batch[name].numpy(), value, atol=CACHE_ATOL,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(batch[name].numpy(), value, err_msg=name)

    # count transformer-block forwards, the recompute's included (module
    # hooks do not fire when torch.utils.checkpoint recomputes)
    calls = [0]
    for block in port.unet.modules():
        if isinstance(block, BasicTransformerBlock):
            def counted(*args, _forward=block.forward):
                calls[0] += 1
                return _forward(*args)
            block.forward = counted
    gen = torch.Generator().manual_seed(0)
    metrics, up_max = [], None
    for step, ref_step in enumerate(ref["steps"]):
        draws = {k: torch.from_numpy(v.copy()) for k, v in ref_step["draws"].items()}
        out = setup.train_step(setup.state, batch, gen, **draws)
        metrics.append({k: float(v) for k, v in out.items()})
        if step == 0:
            up_max = max(float(e["lora_up"].detach().abs().max())
                         for e in setup.state.params["unet_lora"].values())
    return setup, metrics, up_max, calls[0]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_matches_reference(ref, setup, metrics):
    for got, want in zip(metrics, ref["steps"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=REL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=REL)
    final = ref["steps"][-1]["params"]
    assert set(setup.state.params) == set(final)
    for group, adapters in final.items():
        assert set(setup.state.params[group]) == set(adapters)
        got = [setup.state.params[group][key][name].detach().numpy().ravel()
               for key, entry in adapters.items() for name in entry]
        want = [value.ravel() for entry in adapters.values() for value in entry.values()]
        assert _rel(np.concatenate(got), np.concatenate(want)) <= REL, group


def test_lora_steps_match_jax(cached_reference):
    setup, metrics, up_max, _ = _port_run(cached_reference)
    # gradient-flow canary (tests/test_trainer_sdxl.py): lora_up starts at
    # zero, so a non-zero up after one step proves grads reached it
    assert up_max > 0.0
    _assert_matches_reference(cached_reference, setup, metrics)


def test_tx_only_checkpointing_gives_the_same_steps(cached_reference):
    plain, plain_metrics, _, plain_calls = _port_run(cached_reference)
    remat, remat_metrics, _, remat_calls = _port_run(cached_reference, "tx_only")
    # tx_only recomputes every transformer block in the backward
    assert remat_calls == 2 * plain_calls > 0
    assert remat_metrics == plain_metrics
    for group, adapters in plain.state.params.items():
        for key, entry in adapters.items():
            for name, value in entry.items():
                assert torch.equal(value, remat.state.params[group][key][name]), key
    _assert_matches_reference(cached_reference, remat, remat_metrics)


def test_unported_remat_policy_raises(cached_reference):
    with pytest.raises(NotImplementedError):
        _port_model(cached_reference["jax_model"], cached_reference["params"], "dots")


def test_bf16_lora_weights_are_refused(cached_reference):
    # the reference rounds bf16 LoRA updates stochastically, which the
    # port's AdamW does not: it must refuse, not round to nearest
    port = _port_model(cached_reference["jax_model"], cached_reference["params"], None)
    config = PortTrainConfig.default_values().from_dict(
        cached_reference["port_config"].to_dict())
    config.lora_weight_dtype = PortDataType.BFLOAT_16
    with pytest.raises(NotImplementedError):
        get_family(config.model_type).create_setup(port, config, 10)


def test_text_encoder_lora_steps_and_merged_sample_match_jax(monkeypatch, te_reference):
    """Text encoders trained with LoRA and run inside the step on the
    batch's tokens; then both sides sample, the reference from its merged
    weights and the port through its adapted layers."""
    ref = te_reference
    setup, metrics, up_max, _ = _port_run(ref)
    assert up_max > 0.0
    assert set(setup.state.params) == {"unet_lora", "te_lora", "te2_lora"}
    _assert_matches_reference(ref, setup, metrics)

    sc = _sample_config(32)
    jax_model, jsetup = ref["jax_model"], ref["setup"]
    unet, te, te2, _ = jsetup.merged_inference_params()
    jax_latents = _record_steps(monkeypatch, jax_sched)
    image_ref = sample_stable_diffusion_xl(
        jax_model, unet, te, te2, jax_model.vae_params, jax_model.tokenizer,
        jax_model.tokenizer_2, sc).image

    _, noise_rng = jax.random.split(jax.random.PRNGKey(sc.seed))
    latent = 32 // jax_model.vae_config.spatial_scale
    noise = np.array(jax.random.normal(
        noise_rng, (1, latent, latent, jax_model.vae_config.latent_channels),
        jnp.float32))
    monkeypatch.setattr(pt_sampler, "_initial_latents",
                        lambda shape, generator, device:
                        torch.from_numpy(noise).to(device))
    port_latents = _record_steps(monkeypatch, pt_sched)
    family = get_family(ref["port_config"].model_type)
    port_sc = PortSampleConfig.default_values().from_dict(sc.to_dict())
    image = family.sample(setup, port_sc, None).image

    assert len(port_latents) == len(jax_latents) == sc.diffusion_steps
    np.testing.assert_allclose(port_latents[-1].numpy(), np.asarray(jax_latents[-1]),
                               atol=LATENT_ATOL, rtol=0)
    assert image.shape == image_ref.shape == (32, 32, 3)
    assert np.abs(image.astype(int) - image_ref.astype(int)).max() <= IMAGE_LEVELS
    # sampling runs the training modules themselves, unmerged and still
    # adapted
    assert setup.merged_inference_params()[:3] == (
        setup.model.unet, setup.model.text_encoder, setup.model.text_encoder_2)
    assert all(e["lora_up"].requires_grad
               for e in setup.state.params["unet_lora"].values())
