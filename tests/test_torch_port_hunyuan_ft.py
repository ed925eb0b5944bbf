"""Parity of the torch port's HunyuanVideo FINE_TUNE with the reference
(onetrainer_tpu/setup/hunyuan_setup.py:164-171, the FINE_TUNE branch, and
its train step) on the tiny HunyuanVideo of tests/test_torch_port_hunyuan.py
with the same weights on both sides, built through the setup entry points
from one config: the transformer (`prior`) trains in bf16 with Adafactor
and stochastic rounding, lr 1e-3, clip 1.0, text cached; one step on the
port's cached batch (its encoders are held to the reference's in
tests/test_torch_port_hunyuan.py) with the reference's draws and its own
rounding bits. Both sides share one timestep frequency table (ROADMAP
F11: tests/test_torch_port_hunyuan.py `shared_timestep_table`).

Tolerances, as tests/test_torch_port_dit_finetune.py states them for
FLUX's bf16 fine-tune (the reference's Adafactor computes in bf16, the
port's in fp32: ROADMAP F8): the loss 1e-4 relative, the grad norm 2^-5,
each weight after the update within one bf16 step of the reference's plus
2^-5 of the reference's change, but for at most BF16_OUTSIDE of the
elements, at most BF16_OTHER_NEIGHBOUR on the other bf16 neighbour; the
attention key biases are left out (their exact gradient is zero).

Beside it: with `text_encoder.train` set, FINE_TUNE still trains the
transformer alone, as the reference's: Llama and CLIP-L stay frozen, the
text is not cached, and the step runs both on the batch's tokens, to the
loss of the cached step on the same draws (1e-5 relative); the trained
model's HunyuanVideo single file reads back bit for bit; a FINE_TUNE
config that trains no part serves sampling alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.io import hunyuan_checkpoints as jax_io
from onetrainer_tpu.setup import hunyuan_setup as jax_setup
from onetrainer_tpu.util.enums import DataType, Optimizer, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.hunyuan_checkpoints import hunyuan_transformer_state_dict
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.train import optimizers as pt_opt
from tests.test_torch_port_dit_finetune import BF16_OTHER_NEIGHBOUR, BF16_OUTSIDE
from tests.test_torch_port_hunyuan import (  # noqa: F401  (fixture)
    _batch, _clips, _configs, _jax_draws, shared_timestep_table, tiny_hunyuan_pair,
)
from tests.test_torch_port_train_finetune import (
    BF16_STEP, BF16_UPDATE_REL, NORM_REL_BF16, REL, _flat,
)
from tests.test_torch_port_train_sdxl import SEED, _rel, _round_bits

LIVE_REL = 1e-5
_KEY_BIASES = ("to_k.bias", "add_k_proj.bias")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ft_configs(train_te: bool = False):
    config, _ = _configs(train_te)
    config.training_method = TrainingMethod.FINE_TUNE
    config.clip_grad_norm = 1.0
    config.train_dtype = DataType.FLOAT_32   # bf16 weights, fp32 activations
    config.optimizer.optimizer = Optimizer.ADAFACTOR
    config.optimizer.stochastic_rounding = True
    config.prior.weight_dtype = DataType.BFLOAT_16
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _bf16_pair():
    jax_model, _, port = tiny_hunyuan_pair()
    jax_model.transformer_params = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                                jax_model.transformer_params)
    port.transformer.to(torch.bfloat16)
    return jax_model, port


def _state_dict(tree, dtype=np.float32) -> dict:
    """A reference transformer tree as the port's state dict (numpy)."""
    return hunyuan_transformer_state_dict(jax_io.hunyuan_flax_to_state_dict(
        jax.tree.map(lambda x: np.asarray(x, dtype), jax.device_get(tree))))


@pytest.fixture(scope="module")
def run(shared_timestep_table):
    """The port's FINE_TUNE setup and cached batch, the reference's one step
    on that batch and its draws, then the port's step on them."""
    jax_model, port = _bf16_pair()
    config, port_config = _ft_configs()
    family = get_family(port_config.model_type)
    setup = family.create_setup(port, port_config, 10)
    batch = _batch(*family.make_encode_fns(setup), torch.from_numpy(_clips()), torch.as_tensor)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ref = jax_setup.create_hunyuan_setup(jax_model, config, total_steps=10)
    init = _state_dict(ref.state.params["transformer"])
    rng = jax.random.PRNGKey(SEED)
    draws = _jax_draws(ref.step_cfg, jbatch, rng, 0)
    bits = jax.device_get(_round_bits(ref.state.params, rng, 0))["transformer"]
    state, metrics = ref.train_step(ref.state, ref.frozen, jbatch, rng)
    port_draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()
                  if k != "dropout_keep"}
    port_draws["dropout_keep"] = tuple(torch.from_numpy(np.array(m))
                                       for m in draws["dropout_keep"])
    port_draws["round_bits"] = {"transformer": {
        k: torch.from_numpy(np.ascontiguousarray(v).astype(np.int64))
        for k, v in _state_dict(bits, np.uint32).items()}}
    out = setup.train_step(setup.state, batch, torch.Generator().manual_seed(0),
                           **port_draws)
    return dict(setup=setup, batch=batch, draws=port_draws, init=init,
                ref_groups=set(ref.state.params), ref_loss=float(metrics["loss"]),
                ref_grad_norm=float(metrics["grad_norm"]),
                ref_after=_state_dict(state.params["transformer"]),
                loss=float(out["loss"]), grad_norm=float(out["grad_norm"]))


def test_fine_tune_step_matches_jax(run):
    setup, init = run["setup"], run["init"]
    state = setup.state
    assert set(state.params) == run["ref_groups"] == {"transformer"}
    assert set(state.params["transformer"]) == set(init)
    assert all(t.dtype == torch.bfloat16 and t.requires_grad
               for t in state.params["transformer"].values())
    assert isinstance(state.opt_state["transformer"], pt_opt.AdafactorState)
    assert setup.step_cfg.stochastic_rounding and not setup.step_cfg.train_text_encoder
    assert "text_encoder_1_hidden_state" in run["batch"]
    for name in ("text_encoder", "text_encoder_2", "vae"):
        assert not any(p.requires_grad for p in getattr(setup.model, name).parameters())
    assert run["loss"] == pytest.approx(run["ref_loss"], rel=REL)
    assert run["grad_norm"] == pytest.approx(run["ref_grad_norm"], rel=NORM_REL_BF16)
    names = [n for n in init if not n.endswith(_KEY_BIASES)]
    got = _flat({k: t.detach().float().numpy() for k, t in
                 state.params["transformer"].items()}, names)
    want, before = _flat(run["ref_after"], names), _flat(init, names)
    limit = BF16_STEP * np.abs(want) + BF16_UPDATE_REL * np.abs(want - before)
    outside = float(np.mean(np.abs(got - want) > limit))
    other = float(np.mean(got != want))
    print(f"hunyuan transformer bf16 after 1 update: {100 * other:.3f}% of {want.size} "
          f"elements on the other bf16 neighbour, {int(round(outside * want.size))} outside")
    assert outside <= BF16_OUTSIDE[1] and other <= BF16_OTHER_NEIGHBOUR[1]
    assert other < 0.5 * float(np.mean(want != before))
    assert _rel(got - before, want - before) < 0.1


def test_live_text_fine_tune_trains_the_transformer_alone(run, shared_timestep_table):
    """`text_encoder.train` under FINE_TUNE: the reference's and the port's
    setups train the transformer alone; the port caches no text and its
    step runs Llama and CLIP-L on the tokens, giving the cached step's
    loss on the same draws and moving no encoder weight."""
    jax_model, port = _bf16_pair()
    config, port_config = _ft_configs(train_te=True)
    ref = jax_setup.create_hunyuan_setup(jax_model, config, total_steps=10)
    family = get_family(port_config.model_type)
    setup = family.create_setup(port, port_config, 10)
    assert set(setup.state.params) == set(ref.state.params) == {"transformer"}
    assert setup.step_cfg.train_text_encoder and ref.step_cfg.train_text_encoder
    batch = _batch(*family.make_encode_fns(setup), torch.from_numpy(_clips()), torch.as_tensor)
    assert "text_encoder_1_hidden_state" not in batch and "tokens_1" in batch
    frozen = {name: {k: v.clone() for k, v in getattr(port, name).state_dict().items()}
              for name in ("text_encoder", "text_encoder_2")}
    draws = {k: v for k, v in run["draws"].items() if k != "round_bits"}
    loss = setup.train_step.loss(batch, None, **draws)
    # the cached loss at the same (initial) weights: a fresh cached setup
    fresh = family.create_setup(_bf16_pair()[1], _ft_configs()[1], 10)
    want = fresh.train_step.loss(run["batch"], None, **draws)
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=LIVE_REL)
    setup.train_step(setup.state, batch, torch.Generator().manual_seed(0))
    for name, sd in frozen.items():
        assert all(torch.equal(v, sd[k]) for k, v in getattr(port, name).state_dict().items())


def test_single_file_output_reads_back_bitwise(run, tmp_path):
    """The fine-tuned model's HunyuanVideo single file (fp32 and bf16
    output dtypes) loads back with the trained transformer bit for bit (its
    bf16 cast for bf16); a FINE_TUNE config that trains no part builds no
    trainer and samples from the model's own modules."""
    setup = run["setup"]
    family = get_family(setup.config.model_type)
    trained = {k: t.detach() for k, t in setup.state.params["transformer"].items()}
    for dtype in (None, torch.bfloat16):
        path = str(tmp_path / f"hv_{dtype}.safetensors")
        family.save_single_file(setup, path, save_dtype=dtype)
        again = family.load(path, setup.config, device="cpu")
        sd = again.transformer.state_dict()
        assert set(sd) == set(trained)
        for key, value in trained.items():
            assert torch.equal(sd[key].to(value.dtype), value), key
            assert torch.equal(sd[key], value.to(sd[key].dtype)), key
    _, port = _bf16_pair()
    config = _ft_configs()[1]
    config.prior.train = False
    idle = family.create_setup(port, config, 1)
    assert idle.train_step is None and idle.merged_inference_params()[0] is port.transformer
