"""Parity of the port's training math with the reference: the clipped
multi-group AdamW (onetrainer_tpu_torch/train/optimizers.py against optax
as onetrainer_tpu/setup/sdxl_setup.py chains it), the per-group learning
rate schedules (setup/sd_setup.py, train/lr_schedules.py), the loss stack
(math/losses.py), noising (math/noise.py), timestep sampling
(math/timesteps.py, in distribution: the two sides draw from different
generators), the step and PEFT configs, and conditioning dropout.

Tolerances: AdamW parameters 5e-6 absolute per element over four steps
at lr <= 1e-2 (on gradients with no element near AdamW's eps): optax
computes the bias corrections 1 - b^t in fp32, which carries a relative
error of ~1e-7 / (1 - b2^t), up to 2.5e-5 at t = 4, into each update,
where the port computes them in fp64; schedules 1e-6 relative (fp32 on
the reference's side); losses 1e-5 relative (fp32 means over the latent); noising 1e-6 absolute;
timestep quantiles within 20 of 1000 steps for 20000 draws (about six
standard errors of a uniform quantile).
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.math import losses as jax_losses
from onetrainer_tpu.math import noise as jax_noise
from onetrainer_tpu.math import schedules as jax_schedules
from onetrainer_tpu.math import timesteps as jax_timesteps
from onetrainer_tpu.peft.lora import PeftConfig
from onetrainer_tpu.setup import sd_setup as jax_sd_setup
from onetrainer_tpu.train.optimizers import create_group_optimizer as jax_group_optimizer
from onetrainer_tpu.train.sd_train_step import SDStepConfig
from onetrainer_tpu.util import enums as E
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.math import losses as pt_losses
from onetrainer_tpu_torch.math import noise as pt_noise
from onetrainer_tpu_torch.math import schedules as pt_schedules
from onetrainer_tpu_torch.math import timesteps as pt_timesteps
from onetrainer_tpu_torch.peft import lora as pt_lora
from onetrainer_tpu_torch.setup import sd_setup as pt_sd_setup
from onetrainer_tpu_torch.train import optimizers as pt_opt
from onetrainer_tpu_torch.train import sd_train_step as pt_step
from onetrainer_tpu_torch.train.train_state import create_train_state, param_groups


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _port_config(config: TrainConfig) -> PortTrainConfig:
    return PortTrainConfig.default_values().from_dict(config.to_dict())


def _plain(value):
    """A config value with enums replaced by their values, dataclasses by
    dicts (the two sides' enum classes differ)."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name)) for f in dataclasses.fields(value)
                if f.name != "weight_dtype"}
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    return value


# ------------------------------------------------------------------ AdamW

def _tensors(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _gradients(rng, shapes, scale):
    # magnitudes in [0.5, 1.5) * scale with random signs: no element near
    # AdamW's eps, where the update's rounding is ill-conditioned
    return [(scale * rng.choice([-1.0, 1.0], s) * rng.uniform(0.5, 1.5, s)
             ).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("clip", [None, 1.0])
def test_clipped_group_adamw_matches_optax(clip):
    config = TrainConfig.default_values()
    config.learning_rate = 1e-2
    config.learning_rate_warmup_steps = 2.0
    config.optimizer.weight_decay = 0.05
    pconfig = _port_config(config)
    shapes = {"unet_lora": [(4, 6), (5, 4)], "te_lora": [(3, 2, 3, 3), (7,)]}
    group_lr = {"unet_lora": None, "te_lora": 3e-3}
    rng = np.random.default_rng(0)
    params = {g: _tensors(rng, s) for g, s in shapes.items()}

    ref_sched = {g: jax_sd_setup._group_schedule(config, lr, 20)
                 for g, lr in group_lr.items()}
    port_sched = {g: pt_sd_setup._group_schedule(pconfig, lr, 20)
                  for g, lr in group_lr.items()}
    labels = {g: [g] * len(s) for g, s in shapes.items()}
    tx = jax_group_optimizer(ref_sched, config.optimizer.optimizer,
                             config.optimizer, labels)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    ref_params = jax.tree.map(jnp.asarray, params)
    ref_state = tx.init(ref_params)
    port_tx = pt_opt.create_group_optimizer(port_sched, pconfig.optimizer.optimizer,
                                            pconfig.optimizer, clip)
    port_params = {g: [torch.from_numpy(p.copy()) for p in ps] for g, ps in params.items()}
    port_state = port_tx.init(port_params)

    for step, scale in enumerate((0.3, 2.0, 0.05, 1.0)):   # clipped and not
        grads = {g: _gradients(rng, s, scale) for g, s in shapes.items()}
        updates, ref_state = tx.update(jax.tree.map(jnp.asarray, grads), ref_state,
                                       ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        port_grads = {g: [torch.from_numpy(x.copy()) for x in gs] for g, gs in grads.items()}
        norm = pt_opt.global_norm([t for gs in port_grads.values() for t in gs])
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        updates = port_tx.updates(port_params, port_grads, port_state, norm)
        for g in shapes:
            torch._foreach_add_(port_params[g], updates[g])
        for g in shapes:
            for got, want in zip(port_params[g], ref_params[g]):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                           atol=5e-6, err_msg=f"{g} step {step}")


def test_train_state_orders_tensors_and_refuses_ema():
    """Adapter trees in key, then tensor-name order; a FINE_TUNE group in
    its own (the module's) order. The EMA is an fp32 copy of every
    trainable tensor (train/ema.py); EMA held on the CPU, which the
    reference offloads to host memory, is refused by the setups' config
    check."""
    params = {"unet_lora": {"b": {"lora_up": torch.zeros(2), "lora_down": torch.ones(3)},
                            "a": {"lora_up": torch.zeros(4), "lora_down": torch.ones(1)}},
              "unet": {"z.weight": torch.ones(5, dtype=torch.bfloat16),
                       "a.bias": torch.zeros(6, dtype=torch.bfloat16)}}
    groups = param_groups(params)
    assert [t.numel() for t in groups["unet_lora"]] == [3, 2, 1, 4]
    assert [t.numel() for t in groups["unet"]] == [5, 6]
    cfg = _port_config(TrainConfig.default_values()).optimizer
    tx = pt_opt.create_group_optimizer({"unet_lora": 1e-3, "unet": 1e-3}, cfg.optimizer, cfg)
    state = create_train_state(params, tx, ema_enabled=True)
    ema = param_groups(state.ema.params)
    assert state.ema.step == 0 and all(
        e.dtype == torch.float32 and torch.equal(e, t.float()) and e is not t
        for g in groups for e, t in zip(ema[g], groups[g]))
    config = TrainConfig.default_values()
    config.ema = E.EMAMode.CPU
    with pytest.raises(NotImplementedError, match="EMA on the CPU"):
        pt_sd_setup.refuse_unported(_port_config(config))


def test_unported_optimizers_raise():
    """Every optimizer is ported (tests/test_torch_port_optimizers.py); the
    one refusal left is the reference's own: SCHEDULE_FREE_SGD at momentum
    0, whose eval params would divide by 0."""
    cfg = _port_config(TrainConfig.default_values()).optimizer
    assert isinstance(pt_opt.create_optimizer(type(cfg.optimizer).LION, cfg, 1e-3), pt_opt.Lion)
    cfg.amsgrad = True
    assert pt_opt.create_optimizer(cfg.optimizer, cfg, 1e-3).amsgrad
    cfg.momentum = 0.0
    with pytest.raises(ValueError):
        pt_opt.create_optimizer(type(cfg.optimizer).SCHEDULE_FREE_SGD, cfg, 1e-3)


# -------------------------------------------------------------- schedules

@pytest.mark.parametrize("scheduler", [
    E.LearningRateScheduler.CONSTANT, E.LearningRateScheduler.LINEAR,
    E.LearningRateScheduler.COSINE, E.LearningRateScheduler.COSINE_WITH_RESTARTS,
    E.LearningRateScheduler.COSINE_WITH_HARD_RESTARTS, E.LearningRateScheduler.REX,
    E.LearningRateScheduler.ADAFACTOR])
@pytest.mark.parametrize("warmup", [0.0, 0.25, 4.0])
def test_group_schedules_match_jax(scheduler, warmup):
    config = TrainConfig.default_values()
    config.learning_rate = 2e-4
    config.learning_rate_scheduler = scheduler
    config.learning_rate_warmup_steps = warmup
    config.learning_rate_cycles = 2.0
    config.learning_rate_min_factor = 0.1
    config.learning_rate_scaler = E.LearningRateScaler.BATCH
    config.batch_size = 4
    config.unet.stop_training_after = 15
    config.unet.stop_training_after_unit = E.TimeUnit.STEP
    pconfig = _port_config(config)
    total = 20
    ref = jax_sd_setup._group_schedule(config, 1e-4, total, config.unet, 5)
    port = pt_sd_setup._group_schedule(pconfig, 1e-4, total, pconfig.unet, 5)
    for step in range(total + 3):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12), step


# ----------------------------------------------------------------- losses

@pytest.mark.parametrize("settings", [
    dict(),
    dict(mse_strength=0.5, mae_strength=0.3, log_cosh_strength=0.2),
    dict(loss_weight_fn=E.LossWeight.MIN_SNR_GAMMA, loss_weight_strength=5.0),
    dict(loss_weight_fn=E.LossWeight.DEBIASED_ESTIMATION),
    dict(loss_weight_fn=E.LossWeight.P2, loss_weight_strength=1.0),
    dict(loss_scaler=E.LossScaler.BATCH, batch_size=3),
], ids=["mse", "mae_logcosh", "min_snr", "debiased", "p2", "batch_scaler"])
@pytest.mark.parametrize("v_prediction", [False, True])
def test_diffusion_losses_match_jax(settings, v_prediction):
    config = TrainConfig.default_values()
    for name, value in settings.items():
        setattr(config, name, value)
    ref_cfg = jax_losses.LossConfig.from_train_config(config, v_prediction)
    port_cfg = pt_losses.LossConfig.from_train_config(_port_config(config), v_prediction)
    assert _plain(port_cfg) == _plain(ref_cfg)

    rng = np.random.default_rng(1)
    predicted, target = (rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
                         for _ in range(2))
    timestep = np.asarray([3, 480, 997], np.int32)
    weight = np.asarray([1.0, 0.5, 2.0], np.float32)
    betas = jax_schedules.make_betas()
    ref = jax_losses.diffusion_losses(
        {"loss_weight": jnp.asarray(weight)},
        {"predicted": jnp.asarray(predicted), "target": jnp.asarray(target),
         "timestep": jnp.asarray(timestep)},
        ref_cfg, jax_schedules.DiffusionScheduleCoefficients.from_betas(betas))
    got = pt_losses.diffusion_losses(
        {"loss_weight": torch.from_numpy(weight)},
        {"predicted": torch.from_numpy(predicted), "target": torch.from_numpy(target),
         "timestep": torch.from_numpy(timestep)},
        port_cfg, pt_schedules.DiffusionScheduleCoefficients.from_betas(
            torch.from_numpy(np.array(betas))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("weight_fn", list(E.LossWeight), ids=lambda w: w.value)
def test_diffusion_losses_match_jax_for_every_loss_weight(weight_fn):
    """F10: every LossWeight of an epsilon-prediction model, SIGMA included
    (the reference leaves that loss CONSTANT's), at 1e-6 relative."""
    config = TrainConfig.default_values()
    config.loss_weight_fn = weight_fn
    ref_cfg = jax_losses.LossConfig.from_train_config(config, False)
    port_cfg = pt_losses.LossConfig.from_train_config(_port_config(config), False)
    rng = np.random.default_rng(0)
    predicted, target = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
                         for _ in range(2))
    timestep = np.asarray([10, 900], np.int32)
    weight = np.ones(2, np.float32)
    betas = jax_schedules.make_betas()
    ref = jax_losses.diffusion_losses(
        {"loss_weight": jnp.asarray(weight)},
        {"predicted": jnp.asarray(predicted), "target": jnp.asarray(target),
         "timestep": jnp.asarray(timestep)},
        ref_cfg, jax_schedules.DiffusionScheduleCoefficients.from_betas(betas))
    got = pt_losses.diffusion_losses(
        {"loss_weight": torch.from_numpy(weight)},
        {"predicted": torch.from_numpy(predicted), "target": torch.from_numpy(target),
         "timestep": torch.from_numpy(timestep)},
        port_cfg, pt_schedules.DiffusionScheduleCoefficients.from_betas(
            torch.from_numpy(np.array(betas))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_unported_loss_settings_raise():
    """Masked training is ported (tests/test_torch_port_finetune_math.py),
    and the learned-variance VB term (tests/test_torch_port_pixart.py; as
    the reference's, it needs the schedule's coefficients, and without them
    the loss is the other terms'); prior preservation raises."""
    cfg = pt_losses.LossConfig(masked_training=True)
    batch = {"latent_mask": torch.ones(1, 2), "loss_weight": torch.ones(1)}
    data = {"predicted": torch.zeros(1, 2), "target": torch.zeros(1, 2)}
    plain = pt_losses.diffusion_losses(batch, data, cfg, None)
    assert plain.shape == (1,)
    with_var = pt_losses.diffusion_losses(
        batch, {**data, "predicted_var_values": torch.zeros(1, 2)}, cfg, None)
    assert torch.equal(with_var, plain)
    with pytest.raises(NotImplementedError):
        pt_losses.diffusion_losses(batch, {**data, "prior_target": torch.zeros(1, 2)},
                                   cfg, None)


# ------------------------------------------------------- noise, timesteps

def test_add_noise_matches_jax():
    rng = np.random.default_rng(2)
    latent, noise = (rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
                     for _ in range(2))
    timestep = np.asarray([0, 500, 999], np.int32)
    ref_c = jax_schedules.DiffusionScheduleCoefficients.from_betas(jax_schedules.make_betas())
    port_c = pt_schedules.DiffusionScheduleCoefficients.from_betas(pt_schedules.make_betas())
    ref = jax_noise.add_noise_discrete(jnp.asarray(latent), jnp.asarray(noise),
                                       jnp.asarray(timestep), ref_c.sqrt_alphas_cumprod,
                                       ref_c.sqrt_one_minus_alphas_cumprod)
    got = pt_noise.add_noise_discrete(torch.from_numpy(latent), torch.from_numpy(noise),
                                      torch.from_numpy(timestep),
                                      port_c.sqrt_alphas_cumprod,
                                      port_c.sqrt_one_minus_alphas_cumprod)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("offset,perturbation", [(0.0, 0.0), (0.1, 0.0), (0.0, 0.2)])
def test_create_noise_is_seeded_and_distributed_like_jax(offset, perturbation):
    # the port draws channels-last, the JAX package channels-first
    shape = (256, 16, 16, 4)
    a = pt_noise.create_noise(torch.Generator().manual_seed(3), shape, torch.float32,
                              offset, perturbation)
    b = pt_noise.create_noise(torch.Generator().manual_seed(3), shape, torch.float32,
                              offset, perturbation)
    assert torch.equal(a, b)
    ref = np.asarray(jax_noise.create_noise(jax.random.PRNGKey(3), (256, 4, 16, 16),
                                            jnp.float32, offset, perturbation))
    # the per-(sample, channel) offset shows in the spread of spatial
    # means: 1024 of them, so a relative standard error of ~2%
    assert float(a.numpy().std()) == pytest.approx(float(ref.std()), rel=0.1)
    assert float(a.numpy().mean(axis=(1, 2)).std()) == pytest.approx(
        float(ref.mean(axis=(2, 3)).std()), rel=0.1)


@pytest.mark.parametrize("through_step", [False, True], ids=["create_noise", "train_step"])
def test_offset_noise_is_per_sample_and_channel_on_nhwc_latents(through_step):
    """OneTrainer's `_create_noise` adds w * N(0, 1) of shape [B, C, 1, 1]
    to unit noise on NCHW latents: one offset per (sample, channel). On the
    train steps' NHWC latents (256, 16, 16, 4) with w = 0.5 that makes the
    per-(sample, channel) spatial means vary by 1/(16*16) + w^2 = 0.2539,
    while the per-(sample, row) means (over W and C) vary about their
    sample's mean only as unit noise does, (1/64)(1 - 1/16) = 0.01465. The
    reference's draw of shape [B, H, 1, 1] on NHWC latents gives 0.0195
    and 0.249 instead. 1024 and 3840 degrees of freedom: relative standard
    errors of 4.4% and 2.3%."""
    shape, w = (256, 16, 16, 4), 0.5
    gen = torch.Generator().manual_seed(0)
    if through_step:
        config = PortTrainConfig.default_values()
        config.offset_noise_weight = w
        cfg = pt_step.SDStepConfig.from_train_config(config)
        coefficients = pt_schedules.DiffusionScheduleCoefficients.from_betas(
            pt_schedules.make_betas())
        noise = pt_step.noise_latents({"latent_image": torch.zeros(shape)}, gen, cfg,
                              coefficients)["noise"].double()
    else:
        noise = pt_noise.create_noise(gen, shape, torch.float32, w).double()
    channel_means = noise.mean(dim=(1, 2))
    assert channel_means.var().item() == pytest.approx(1 / 256 + w ** 2, rel=0.2)
    row_means = noise.mean(dim=(2, 3))
    within = row_means - row_means.mean(dim=1, keepdim=True)
    assert (within ** 2).sum().item() / (256 * 15) == pytest.approx(15 / 16 / 64, rel=0.15)


@pytest.mark.parametrize("settings", [
    dict(),
    dict(timestep_distribution=E.TimestepDistribution.LOGIT_NORMAL, noising_weight=0.5,
         noising_bias=0.2),
    dict(timestep_distribution=E.TimestepDistribution.HEAVY_TAIL, noising_weight=0.5),
    dict(timestep_distribution=E.TimestepDistribution.SIGMOID, noising_weight=3.0),
    dict(timestep_distribution=E.TimestepDistribution.COS_MAP),
    dict(min_noising_strength=0.2, max_noising_strength=0.8, timestep_shift=2.0),
], ids=["uniform", "logit_normal", "heavy_tail", "sigmoid", "cos_map", "window_shift"])
def test_timesteps_match_jax_in_distribution(settings):
    config = TrainConfig.default_values()
    for name, value in settings.items():
        setattr(config, name, value)
    ref_cfg = jax_timesteps.TimestepConfig.from_train_config(config)
    port_cfg = pt_timesteps.TimestepConfig.from_train_config(_port_config(config))
    assert _plain(port_cfg) == _plain(ref_cfg)
    n = 20000
    ref = np.asarray(jax_timesteps.sample_timesteps_discrete(
        jax.random.PRNGKey(0), n, ref_cfg))
    got = pt_timesteps.sample_timesteps_discrete(torch.Generator().manual_seed(0), n,
                                                 port_cfg)
    assert got.dtype == torch.int32 and got.shape == (n,)
    got = got.numpy()
    assert got.min() >= 0 and got.max() < 1000
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    np.testing.assert_allclose(np.quantile(got, qs), np.quantile(ref, qs), atol=20)
    det = pt_timesteps.sample_timesteps_discrete(torch.Generator(), 3, port_cfg,
                                                 deterministic=True)
    np.testing.assert_array_equal(det.numpy(), np.asarray(
        jax_timesteps.sample_timesteps_discrete(jax.random.PRNGKey(0), 3, ref_cfg,
                                                deterministic=True)))


# ---------------------------------------------------------------- configs

def test_step_and_peft_configs_match_jax():
    config = TrainConfig.default_values()
    config.training_method = E.TrainingMethod.LORA
    config.offset_noise_weight = 0.05
    config.text_encoder.dropout_probability = 0.1
    config.lora_rank, config.lora_alpha = 8, 4.0
    config.lora_layers = "attn1, ff"
    pconfig = _port_config(config)
    ref = SDStepConfig.from_train_config(config, "v_prediction", 1)
    got = pt_step.SDStepConfig.from_train_config(pconfig, "v_prediction", 1)
    # the port keeps only the fields it reads, each equal to the reference's
    assert _plain(got) == {k: v for k, v in _plain(ref).items() if k in _plain(got)}
    ref_peft = PeftConfig.from_train_config(config)
    got_peft = pt_lora.PeftConfig.from_train_config(pconfig)
    assert _plain(got_peft) == {k: v for k, v in _plain(ref_peft).items()
                                if k in _plain(got_peft)}
    assert got_peft.weight_dtype == torch.float32


@pytest.mark.parametrize("setting,value,message", [
    ("ema", E.EMAMode.CPU, "EMA on the CPU"),
    ("masked_prior_preservation_weight", 0.5, "prior preservation"),
    ("training_method", E.TrainingMethod.FINE_TUNE_VAE, "FINE_TUNE_VAE training"),
])
def test_step_config_refuses_unported_settings(setting, value, message):
    """The step settings the port does not run raise, each named, in the
    setups' one config check (setup/sd_setup.py:refuse_unported), which
    the trainer calls before it loads the model; the EMA on the device and
    gradient accumulation are ported and pass it. The config is SDXL's,
    whose VAE fine-tune the reference does not have (EMBEDDING, refused
    here until the embedding slice, passes now)."""
    config = TrainConfig.default_values()
    config.model_type = E.ModelType.STABLE_DIFFUSION_XL_10_BASE
    config.training_method = E.TrainingMethod.LORA
    config.ema, config.gradient_accumulation_steps = E.EMAMode.GPU, 2
    pt_sd_setup.refuse_unported(_port_config(config))
    setattr(config, setting, value)
    with pytest.raises(NotImplementedError, match=message):
        pt_sd_setup.refuse_unported(_port_config(config))


def test_conditioning_dropout_mask_rate():
    mask = pt_step.conditioning_dropout_mask(torch.Generator().manual_seed(0), 20000, 0.3)
    assert set(mask.unique().tolist()) == {0.0, 1.0}
    assert float(1 - mask.mean()) == pytest.approx(0.3, abs=0.015)
