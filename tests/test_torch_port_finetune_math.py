"""Parity of the port's fine-tune math with the reference: Adafactor
(onetrainer_tpu_torch/train/optimizers.py against optax.adafactor as
onetrainer_tpu/train/optimizers.py:306-318 builds it), the clipped group
optimizer wrapped in gradient accumulation (`MultiSteps` against
optax.MultiSteps over optax.chain(clip_by_global_norm, group optimizer), as
onetrainer_tpu/setup/sd_setup.py:406-411 builds it), the EMA
(train/ema.py against onetrainer_tpu/train/ema.py), masked losses
(math/losses.py against onetrainer_tpu/math/losses.py:83-95 and the loss
stack with `masked_training`), and the stochastic rounding of a zero
update, which must leave bf16 weights bit for bit.

Tolerances: Adafactor's updates 1e-5 of each tensor's largest |update|
per element over three fp32 steps (the two sides take each reduction,
rsqrt and power in their own order; relative rounding ~1e-7 per op); the
accumulated, clipped updates likewise; the EMA 1e-6 relative (fp32 on both
sides, one rounding per multiply-add); masked losses 1e-5 relative (fp32
means over the latent).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.math import losses as jax_losses
from onetrainer_tpu.math import schedules as jax_schedules
from onetrainer_tpu.train import ema as jax_ema
from onetrainer_tpu.train.optimizers import create_group_optimizer as jax_group_optimizer
from onetrainer_tpu.train.optimizers import create_optimizer as jax_create_optimizer
from onetrainer_tpu.util import enums as E
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.math import losses as pt_losses
from onetrainer_tpu_torch.math import schedules as pt_schedules
from onetrainer_tpu_torch.ops.stochastic import apply_updates_stochastic
from onetrainer_tpu_torch.train import ema as pt_ema
from onetrainer_tpu_torch.train import optimizers as pt_opt
from onetrainer_tpu_torch.util import enums as pt_enums


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


UPDATE_REL = 1e-5
EMA_REL = 1e-6
LOSS_REL = 1e-5
# 1-D; 2-D below 128 (not factored); 2-D at and above 128 (factored, a tie
# of the two largest axes included); 4-D convs, factored and not
SHAPES = [(7,), (16, 40), (256, 130), (128, 128), (160, 130, 3, 3), (8, 4, 3, 3)]


def _optimizer_config(momentum, weight_decay, scale_parameter):
    config = TrainConfig.default_values()
    config.optimizer.optimizer = E.Optimizer.ADAFACTOR
    config.optimizer.beta1 = momentum
    config.optimizer.weight_decay = weight_decay
    config.optimizer.scale_parameter = scale_parameter
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _grads(rng, shapes):
    return [(rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
            for s in shapes]


def _assert_updates_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        g = g.float().numpy().astype(np.float64)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_REL * np.abs(w).max(),
                                   err_msg=f"{what} tensor {i} {w.shape}")


@pytest.mark.parametrize("momentum,weight_decay,scale_parameter",
                         list(itertools.product([None, 0.9], [0.0, 0.01], [False, True])))
def test_adafactor_matches_optax(momentum, weight_decay, scale_parameter):
    """Three fp32 steps over every shape class, with a schedule, against
    optax.adafactor as the reference builds it from the same config."""
    config, pconfig = _optimizer_config(momentum, weight_decay, scale_parameter)
    schedule = optax.linear_schedule(1e-2, 5e-3, 10)
    tx = jax_create_optimizer(config.optimizer.optimizer, config.optimizer, schedule)
    opt = pt_opt.create_optimizer(pconfig.optimizer.optimizer, pconfig.optimizer,
                                  lambda step: float(schedule(step)))
    assert isinstance(opt, pt_opt.Adafactor)
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    state, tstate = tx.init(jp), opt.init(tp)
    factored = [pt_opt.factored_dims(s) is not None for s in SHAPES]
    assert factored == [False, False, True, True, True, False]
    for step in range(3):
        grads = _grads(rng, SHAPES)
        want, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        got = opt.updates(tp, [torch.from_numpy(g) for g in grads], tstate)
        assert all(u.dtype == torch.float32 for u in got)
        _assert_updates_close(got, want, f"step {step}")
        jp = optax.apply_updates(jp, want)
        tp = [torch.from_numpy(np.asarray(p).copy()) for p in jp]
    assert tstate.count == 3
    assert all(v.dtype == torch.float32 for v in tstate.v_row + tstate.v_col + tstate.v)


def test_adafactor_keeps_fp32_moments_and_bf16_updates_for_bf16_params():
    """bf16 parameters: fp32 second moments; the update comes back in bf16
    (fp32 with momentum), the dtypes of optax's chain; its values within a
    bf16 rounding (2^-8 relative) of the fp32 computation on the same
    values."""
    _, pconfig = _optimizer_config(None, 0.0, False)
    opt = pt_opt.create_optimizer(pconfig.optimizer.optimizer, pconfig.optimizer, 1e-3)
    rng = np.random.default_rng(4)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
              for s in SHAPES]
    grads = [torch.from_numpy(g).to(torch.bfloat16) for g in _grads(rng, SHAPES)]
    state = opt.init(params)
    got = opt.updates(params, grads, state)
    assert all(u.dtype == torch.bfloat16 for u in got)
    assert all(t.dtype == torch.float32 for t in state.v_row + state.v_col + state.v)
    ref = opt.updates([p.float() for p in params], [g.float() for g in grads],
                      opt.init([p.float() for p in params]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().numpy(), r.numpy(), rtol=2.0 ** -8, atol=0)
    _, pconfig = _optimizer_config(0.9, 0.0, False)
    opt = pt_opt.create_optimizer(pconfig.optimizer.optimizer, pconfig.optimizer, 1e-3)
    assert all(u.dtype == torch.float32
               for u in opt.updates(params, grads, opt.init(params)))


@pytest.mark.parametrize("optimizer", ["ADAMW", "ADAFACTOR"])
def test_clipped_accumulated_group_optimizer_matches_optax(optimizer):
    """optax.MultiSteps(k=2) over the clipped group optimizer: four
    micro-steps, two updates (the mean of each pair of gradients, clipped
    at 1.0 over both groups); zero updates between, which the port returns
    as None."""
    config = TrainConfig.default_values()
    config.optimizer.optimizer = E.Optimizer[optimizer]
    config.learning_rate = 1e-2
    pconfig = PortTrainConfig.default_values().from_dict(config.to_dict())
    shapes = {"unet": [(256, 130), (7,)], "text_encoder": [(16, 40), (160, 130, 3, 3)]}
    lr = {"unet": 1e-2, "text_encoder": 3e-3}
    labels = {g: [g] * len(s) for g, s in shapes.items()}
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0), jax_group_optimizer(
        lr, config.optimizer.optimizer, config.optimizer, labels)), every_k_schedule=2)
    port_tx = pt_opt.create_group_optimizer(lr, pconfig.optimizer.optimizer,
                                            pconfig.optimizer, 1.0, accumulation_steps=2)
    assert isinstance(port_tx, pt_opt.MultiSteps)
    rng = np.random.default_rng(6)
    params = {g: [rng.standard_normal(s).astype(np.float32) for s in ss]
              for g, ss in shapes.items()}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {g: [torch.from_numpy(p.copy()) for p in ps] for g, ps in params.items()}
    state, tstate = tx.init(jp), port_tx.init(tp)
    for step, scale in enumerate((0.3, 3.0, 0.05, 0.2)):   # clipped and not
        grads = {g: [(scale * rng.standard_normal(s)).astype(np.float32) for s in ss]
                 for g, ss in shapes.items()}
        want, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        got = port_tx.updates(tp, {g: [torch.from_numpy(x) for x in gs]
                                   for g, gs in grads.items()}, tstate)
        if step % 2 == 0:
            assert got is None and tstate.mini_step == 1
            assert all(not np.any(np.asarray(w)) for w in jax.tree.leaves(want))
            continue
        assert tstate.mini_step == 0
        for g in shapes:
            _assert_updates_close(got[g], want[g], f"{g} step {step}")
        jp = optax.apply_updates(jp, want)
        tp = {g: [torch.from_numpy(np.asarray(p).copy()) for p in ps] for g, ps in jp.items()}
    assert all(opt.count == 2 for opt in tstate.inner.values())


@pytest.mark.parametrize("interval,accum", [(1, 1), (3, 1), (1, 2), (3, 2)])
def test_ema_matches_jax(interval, accum):
    """maybe_update_ema over twelve micro-steps of changing parameters: the
    same updates on the same micro-steps, the decay warmed up on the
    EMA-update count (ungated) or the optimizer-update index (gated)."""
    rng = np.random.default_rng(interval * 10 + accum)
    shapes = {"unet": {"a.weight": (4, 6), "b.bias": (5,)}, "text_encoder": {"c": (3, 2)}}
    params = {g: {k: rng.standard_normal(s).astype(np.float32) for k, s in e.items()}
              for g, e in shapes.items()}
    ref = jax_ema.init_ema(jax.tree.map(jnp.asarray, params))
    port_params = {g: {k: torch.from_numpy(v.copy()) for k, v in e.items()}
                   for g, e in params.items()}
    state = pt_ema.init_ema(port_params)
    assert state.params["unet"]["a.weight"] is not port_params["unet"]["a.weight"]
    updates = 0
    for step in range(12):
        params = {g: {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                      for k, v in e.items()} for g, e in params.items()}
        with torch.no_grad():
            for g, e in params.items():
                for k, v in e.items():
                    port_params[g][k].copy_(torch.from_numpy(v))
        ref = jax_ema.maybe_update_ema(ref, jax.tree.map(jnp.asarray, params), 0.999,
                                       jnp.asarray(step, jnp.int32), interval, accum)
        updates += pt_ema.maybe_update_ema(state, port_params, 0.999, step, interval, accum)
        assert state.step == int(ref.step) == updates
        for g, e in ref.params.items():
            for k, v in e.items():
                np.testing.assert_allclose(state.params[g][k].numpy(), np.asarray(v),
                                           rtol=EMA_REL, err_msg=f"{g}/{k} step {step}")
    assert updates == 12 // (interval * accum)
    assert pt_ema.ema_decay(3, 0.999) == pytest.approx(float(jax_ema.ema_decay(
        jnp.asarray(3), 0.999)), rel=0)


@pytest.mark.parametrize("unmasked_weight,normalize", [(0.1, False), (0.1, True), (0.4, True)])
def test_masked_losses_match_jax(unmasked_weight, normalize):
    rng = np.random.default_rng(8)
    losses = rng.random((3, 8, 8, 4)).astype(np.float32)
    mask = rng.random((3, 8, 8, 1)).astype(np.float32)
    mask[0] = 0.0                        # a sample with no masked area
    want = jax_losses.masked_losses(jnp.asarray(losses), jnp.asarray(mask),
                                    unmasked_weight, normalize)
    got = pt_losses.masked_losses(torch.from_numpy(losses), torch.from_numpy(mask),
                                  unmasked_weight, normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_REL)


@pytest.mark.parametrize("masked,raw", [(True, True), (False, True), (False, False)])
def test_masked_loss_stack_matches_jax(masked, raw):
    """The per-sample loss stack with a latent mask: masked training (MSE
    and MAE each weighted by the clamped mask, area-normalized), the
    mask-input models' unmasked loss normalized by the mask's area, and no
    masking; v-prediction with min-SNR weighting."""
    rng = np.random.default_rng(9)
    predicted, target = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
                         for _ in range(2))
    mask = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
    timestep = np.asarray([10, 700], np.int32)
    kwargs = dict(mse_strength=1.0, mae_strength=0.5, masked_training=masked,
                  raw_masked_training=raw, unmasked_weight=0.1,
                  normalize_masked_area_loss=True, v_prediction=True,
                  loss_weight_strength=5.0)
    ref_cfg = jax_losses.LossConfig(loss_weight_fn=E.LossWeight.MIN_SNR_GAMMA, **kwargs)
    port_cfg = pt_losses.LossConfig(loss_weight_fn=pt_enums.LossWeight.MIN_SNR_GAMMA,
                                    **kwargs)
    betas = jax_schedules.make_betas("scaled_linear", 0.00085, 0.012, 1000)
    batch = {"latent_mask": mask, "loss_weight": np.ones(2, np.float32)}
    data = {"predicted": predicted, "target": target, "timestep": timestep}
    want = jax_losses.diffusion_losses(
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in data.items()}, ref_cfg,
        jax_schedules.DiffusionScheduleCoefficients.from_betas(betas))
    got = pt_losses.diffusion_losses(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(v) for k, v in data.items()}, port_cfg,
        pt_schedules.DiffusionScheduleCoefficients.from_betas(
            torch.from_numpy(np.array(betas))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_REL)


def test_zero_updates_leave_bf16_weights_bit_for_bit():
    """p + 0 rounds stochastically to p: every bf16 pattern's fp32 value has
    16 zero low bits, so adding any 16 random bits and truncating gives it
    back, on given bits and on the generator's draws (the plain version
    K5 is held to). -0 + 0 is +0 in IEEE arithmetic, on both sides; the
    step adds no zero updates (test_torch_port_train_finetune.py)."""
    rng = np.random.default_rng(10)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
              for s in [(300,), (16, 40), (8, 4, 3, 3)]]
    params.append(torch.tensor([0.0, 1e-38, 3.0e38, -2.0 ** -126], dtype=torch.bfloat16))
    before = [p.clone() for p in params]
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    bits = [torch.from_numpy(rng.integers(0, 1 << 32, p.shape, dtype=np.int64)) for p in params]
    apply_updates_stochastic(params, zeros, bits=bits)
    apply_updates_stochastic(params, [z.to(torch.bfloat16) for z in zeros],
                             torch.Generator().manual_seed(1))
    for p, b in zip(params, before):
        assert torch.equal(p.view(torch.int16), b.view(torch.int16))


def _onetrainer_adafactor(params, weight_decay=0.0):
    """transformers.Adafactor as OneTrainer builds it from its defaults
    (the JAX package's onetrainer_tpu/util/optimizer_util.py:59-63
    carries the same table): lr fixed, eps (1e-30, 1e-3), clip 1.0, decay
    -0.8, no momentum, no relative step, no parameter scale."""
    from transformers.optimization import Adafactor as HFAdafactor
    return HFAdafactor(params, lr=1e-2, eps=(1e-30, 1e-3), clip_threshold=1.0,
                       decay_rate=-0.8, beta1=None, weight_decay=weight_decay,
                       scale_parameter=False, relative_step=False, warmup_init=False)


@pytest.mark.parametrize("case", ["linear", "conv", "weight_decay"])
def test_f8_reference_adafactor_differs_from_onetrainers(case):
    """F8 (ROADMAP queue 3): the reference builds optax.adafactor where
    OneTrainer builds transformers.Adafactor, from the same settings.
    Three steps of each on the same fp32 parameter and gradients:
    - a [160, 130] linear weight: both factor it over its two axes, and the
      factored estimate is symmetric in them, so they agree (to 1e-5 of
      the largest change);
    - a [64, 32, 3, 3] conv weight: transformers factors every tensor of
      two or more axes over its last two, here the 3x3 kernel; optax only
      a tensor whose two largest axes hold 128 or more, so not this one:
      they differ by more than 10% of the change;
    - weight decay 0.01 on the linear weight: transformers decays by
      lr x 0.01 x p, optax adds 0.01 x p after the learning rate, a step
      1/lr times larger: the changes differ by more than half.
    The port follows the reference (test_adafactor_matches_optax)."""
    shape = (64, 32, 3, 3) if case == "conv" else (160, 130)
    wd = 0.01 if case == "weight_decay" else 0.0
    config, _ = _optimizer_config(None, wd, False)
    config.learning_rate = 1e-2
    tx = jax_create_optimizer(config.optimizer.optimizer, config.optimizer, 1e-2)
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal(shape).astype(np.float32)
    hf_param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    hf = _onetrainer_adafactor([hf_param], weight_decay=wd)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for _ in range(3):
        g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        hf_param.grad = torch.from_numpy(g.copy())
        hf.step()
    want = np.asarray(jp, np.float64) - p0
    got = hf_param.detach().numpy().astype(np.float64) - p0
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"F8 {case}: OneTrainer's Adafactor against the reference's, rel L2 of the "
          f"change after three steps {rel:.3e}")
    if case == "linear":
        assert np.abs(got - want).max() <= UPDATE_REL * np.abs(want).max()
    elif case == "conv":
        assert rel > 0.1
    else:
        assert rel > 0.5
