"""Parity of the torch port's SD3 and FLUX FINE_TUNE training with the
reference (onetrainer_tpu/setup/sd3_setup.py:137-151 and
flux_setup.py:170-184, the FINE_TUNE branches, and their train steps), on
the tiny SD3 and FLUX of tests/test_torch_port_{sd3,flux}.py with the same
weights on both sides, built through the setup entry points from one
config: SD3 trains the transformer (`prior`) and CLIP-L (two groups; the
three text encoders run inside the step on the batch's tokens), FLUX the
transformer (text cached); Adafactor with the reference's defaults, clip
1.0, two steps on one batch (the port's cache: the encoders are held to
the reference's in tests/test_torch_port_{sd3,flux}.py) and the
reference's draws (timesteps, noise and latent noise from its own key
splits, as tests/test_torch_port_train_sdxl.py replays them): SD3 with fp32 parameters, FLUX with bf16 parameters and
stochastic rounding on the reference's own rounding bits. Both sides'
tokenizers map words by crc32 (tests/test_torch_port_inpaint.py:
crc32_words), so no input follows Python's hash seed.

Tolerances, as tests/test_torch_port_train_finetune.py states and
explains them: fp32, the loss and the grad norm 1e-4 relative and each
group's change from its initial weights FT_REL relative L2 after each
update (Adafactor divides by a gradient's own RMS, so an element whose
gradient is rounding noise on both sides moves by a share of lr its
rounding decides); bf16 (the reference's Adafactor computes in bf16, the
port's in fp32: ROADMAP F8), the loss 1e-4 relative before the first
update and 1e-3 after it, the grad norm 2^-5 and 2^-4, and each weight
after update k within the sum over updates j <= k of one bf16 step of the
reference's value after j plus 2^-5 of the reference's change in update
j, but for at most BF16_OUTSIDE of the elements (here, after one update
and after two: FLUX's transformer 0 and 1 of 131,344; SD3's transformer,
in bf16, 34 and 26 of 84,944 and CLIP-L 1 and 0 of 1,440: each of them
one bf16 step up on one side and down on the other, an update of about
one bf16 step whose sign the two sides' arithmetic decides); at most
BF16_OTHER_NEIGHBOUR of them on the other bf16 neighbour. In both, the
attention key biases are left out: their exact gradient is zero (softmax
is invariant to a shift of a row's logits), and Adafactor, dividing by a
gradient's own RMS, turns either side's rounding noise into a step of
about lr.

Beside them: the update applied in chunks of a few leaves (one K5 launch
each on the card) is bit for bit the update applied at once, and the
train command's FINE_TUNE of a FLUX single file, stopped after its first
epoch with a backup and resumed, ends with the weights of an
uninterrupted run, bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.setup import flux_setup as jax_flux_setup
from onetrainer_tpu.setup import sd3_setup as jax_sd3_setup
from onetrainer_tpu.util.enums import DataType, ModelType, Optimizer, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
from onetrainer_tpu_torch.scripts import train as pt_train
from onetrainer_tpu_torch.setup import families as pt_families
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.train import optimizers as pt_opt
from onetrainer_tpu_torch.train import sd_train_step as pt_step
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_data import make_dataset
from tests.test_torch_port_flux import _jax_draws as _flux_draws
from tests.test_torch_port_flux import tiny_flux_pair
from tests.test_torch_port_inpaint import crc32_words
from tests.test_torch_port_sd3 import _jax_keep_masks, tiny_sd3_pair
from tests.test_torch_port_train_finetune import (
    BF16_STEP, BF16_UPDATE_REL, FT_REL, LOSS_REL_BF16, NORM_REL_BF16, NORM_REL_BF16_UPDATED,
    REL, _flat,
)
from tests.test_torch_port_train_sdxl import PROMPTS, SEED, _jax_draws, _rel, _round_bits
from tests.test_trainer import tiny_train_config

STEPS = 2
_KEY_BIASES = ("k_proj.bias", "to_k.bias")
BF16_OUTSIDE = {1: 1e-3, 2: 1e-3}
BF16_OTHER_NEIGHBOUR = {1: 0.05, 2: 0.15}
# SD3 with fp32 parameters (two groups, the text encoders live in the
# step), FLUX with bf16 parameters (K5's path on the card): each reference
# step compiles for about half a minute on a loaded tier-1 worker
CASES = {"sd3_fp32": ("sd3", DataType.FLOAT_32), "flux_bf16": ("flux", DataType.BFLOAT_16)}
# the reference's flax tree of a FINE_TUNE group -> the port's parameter names
TO_STATE_DICT = {"transformer": jax_tf.unet_flax_to_state_dict,
                 "text_encoder": jax_tf.clip_flax_to_state_dict}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(family: str, dtype: DataType):
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_3 if family == "sd3" \
        else ModelType.FLUX_DEV_1
    config.training_method = TrainingMethod.FINE_TUNE
    config.batch_size = 2
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.clip_grad_norm = 1.0
    config.train_dtype = DataType.FLOAT_32   # bf16 weights, fp32 activations
    config.optimizer.optimizer = Optimizer.ADAFACTOR
    config.optimizer.stochastic_rounding = dtype == DataType.BFLOAT_16
    config.prior.train = True
    config.prior.weight_dtype = dtype
    config.text_encoder.train = family == "sd3"
    config.text_encoder.weight_dtype = dtype
    config.text_encoder_2.train = False
    if family == "flux":
        config.dynamic_timestep_shifting = True
        config.prior.guidance_scale = 3.5
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _pair(family: str, dtype: DataType):
    """The tiny pair with crc32 tokenizers, its trained parts in `dtype`."""
    jax_model, params, port = (tiny_sd3_pair if family == "sd3" else tiny_flux_pair)()
    tokenizers = ("tokenizer", "tokenizer_2", "tokenizer_3")[:3 if family == "sd3" else 2]
    for name in tokenizers:
        crc32_words(getattr(jax_model, name))
        crc32_words(getattr(port, name))
    trained = ("transformer", "text_encoder") if family == "sd3" else ("transformer",)
    if dtype == DataType.BFLOAT_16:
        for name in trained:
            attr = "te_params" if name == "text_encoder" else "transformer_params"
            setattr(jax_model, attr, jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                                  getattr(jax_model, attr)))
            getattr(port, name).to(torch.bfloat16)
    return jax_model, port


def _images():
    rng = np.random.default_rng(SEED)
    return rng.uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)


def _batch(encode_images, encode_text, images, as_array):
    batch = {name: as_array(value) for name, value in encode_images(images).items()}
    texts = [encode_text(p) for p in PROMPTS]
    for name in texts[0]:
        batch[name] = as_array(np.stack([np.asarray(t[name]) for t in texts]))
    batch["loss_weight"] = as_array(np.ones((2,), np.float32))
    return batch


def _state_dicts(params) -> dict:
    return {group: TO_STATE_DICT[group](jax.tree.map(
        lambda x: np.asarray(x, np.float32), jax.device_get(tree)))
        for group, tree in params.items()}


def _run(case: str) -> dict:
    """The port's setup and its cached batch (both sides' encoders are held
    to each other in tests/test_torch_port_{sd3,flux}.py), the reference's
    two steps on that batch and their draws, then the port's two steps on
    them."""
    family, dtype = CASES[case]
    jax_model, port = _pair(family, dtype)
    config, port_config = _configs(family, dtype)
    pt_family = get_family(port_config.model_type)
    port_setup = pt_family.create_setup(port, port_config, 10)
    port_batch = _batch(*pt_family.make_encode_fns(port_setup), torch.from_numpy(_images()),
                        torch.as_tensor)
    batch = {k: jnp.asarray(v.numpy()) for k, v in port_batch.items()}
    jax_setup = jax_sd3_setup if family == "sd3" else jax_flux_setup
    create = jax_setup.create_sd3_setup if family == "sd3" else jax_setup.create_flux_setup
    setup = create(jax_model, config, total_steps=10)
    init = _state_dicts(setup.state.params)
    rng = jax.random.PRNGKey(SEED)
    state, ref_steps = setup.state, []
    for step in range(STEPS):
        if family == "sd3":
            draws = _jax_draws(setup.step_cfg, batch, rng, step)
            draws["dropout_keep"] = _jax_keep_masks(setup.step_cfg, rng, step, 2)
        else:
            draws = _flux_draws(setup.step_cfg, batch, rng, step)
        if dtype == DataType.BFLOAT_16:
            bits = jax.device_get(_round_bits(state.params, rng, step))
            draws["round_bits"] = {group: {k: torch.from_numpy(
                np.ascontiguousarray(v).astype(np.int64))
                for k, v in TO_STATE_DICT[group](tree).items()}
                for group, tree in bits.items()}
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        ref_steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                              grad_norm=float(metrics["grad_norm"]),
                              params=_state_dicts(state.params)))

    gen = torch.Generator().manual_seed(0)
    steps = []
    for ref_step in ref_steps:
        draws = {}
        for k, v in ref_step["draws"].items():
            if k == "dropout_keep":
                v = tuple(None if m is None else torch.from_numpy(np.array(m)) for m in v)
            elif k != "round_bits":
                v = torch.from_numpy(np.array(v))
            draws[k] = v
        out = port_setup.train_step(port_setup.state, port_batch, gen, **draws)
        steps.append(dict(loss=float(out["loss"]), grad_norm=float(out["grad_norm"]),
                          params={group: {k: t.detach().float().numpy().copy()
                                          for k, t in tensors.items()}
                                  for group, tensors in port_setup.state.params.items()}))
    return dict(family=family, dtype=dtype, init=init, ref_steps=ref_steps,
                setup=port_setup, steps=steps)


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    return _run(request.param)


def test_fine_tune_steps_match_jax(run):
    setup, init, ref_steps, steps = run["setup"], run["init"], run["ref_steps"], run["steps"]
    groups = {"transformer", "text_encoder"} if run["family"] == "sd3" else {"transformer"}
    state = setup.state
    assert set(state.params) == groups == set(init)
    want_dtype = torch.bfloat16 if run["dtype"] == DataType.BFLOAT_16 else torch.float32
    for group in groups:
        assert set(state.params[group]) == set(init[group]), group
        assert all(t.dtype == want_dtype and t.requires_grad
                   for t in state.params[group].values())
        assert isinstance(state.opt_state[group], pt_opt.AdafactorState)
    assert setup.step_cfg.train_text_encoder is (run["family"] == "sd3")
    frozen = ("text_encoder_2", "text_encoder_3", "vae") if run["family"] == "sd3" \
        else ("text_encoder", "text_encoder_2", "vae")
    for name in frozen:
        assert not any(p.requires_grad for p in getattr(setup.model, name).parameters())
    bf16 = run["dtype"] == DataType.BFLOAT_16
    limits = {group: 0.0 for group in groups}
    before = {group: _flat(init[group], [n for n in init[group]
                                         if not n.endswith(_KEY_BIASES)])
              for group in groups}
    for i, (got, want) in enumerate(zip(steps, ref_steps)):
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_REL_BF16 if bf16 and i
                                            else REL)
        norm_rel = (NORM_REL_BF16_UPDATED if i else NORM_REL_BF16) if bf16 else REL
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=norm_rel)
        for group in groups:
            # the attention key biases' exact gradient is zero (softmax is
            # invariant to a shift of a row's logits): Adafactor turns
            # either side's rounding noise into a step of about lr
            names = [n for n in init[group] if not n.endswith(_KEY_BIASES)]
            g, w = _flat(got["params"][group], names), _flat(want["params"][group], names)
            if not bf16:
                start = _flat(init[group], names)
                assert _rel(g - start, w - start) <= FT_REL, (group, i)
                continue
            limits[group] = limits[group] + BF16_STEP * np.abs(w) \
                + BF16_UPDATE_REL * np.abs(w - before[group])
            outside = float(np.mean(np.abs(g - w) > limits[group]))
            other = float(np.mean(g != w))
            print(f"{run['family']} {group} bf16 after {i + 1} update(s): "
                  f"{100 * other:.3f}% of {w.size} elements on the other bf16 neighbour, "
                  f"{int(round(outside * w.size))} outside the bound")
            assert outside <= BF16_OUTSIDE[i + 1] and other <= BF16_OTHER_NEIGHBOUR[i + 1]
            assert other < 0.5 * float(np.mean(w != before[group]))
            before[group] = w


def test_the_update_in_chunks_is_the_update_at_once(monkeypatch):
    """Two bf16 FLUX steps with the update made and rounded in chunks of a
    few leaves (K5 once per chunk on the card; here the plain rounding on
    the same Philox bits) give the weights, bit for bit, and the Adafactor
    state of the steps that apply it at once; the generator's seeds are
    drawn once per update either way."""
    real = pt_step.apply_updates_stochastic
    results = []
    for chunk in (pt_step.UPDATE_CHUNK_ELEMENTS, 3000):
        monkeypatch.setattr(pt_step, "UPDATE_CHUNK_ELEMENTS", chunk)
        _, port = _pair("flux", DataType.BFLOAT_16)
        _, config = _configs("flux", DataType.BFLOAT_16)
        family = get_family(config.model_type)
        setup = family.create_setup(port, config, 10)
        batch = _batch(*family.make_encode_fns(setup), torch.from_numpy(_images()),
                       torch.as_tensor)
        gen = torch.Generator().manual_seed(3)
        calls = []

        def counted(params, *args, **kwargs):
            calls.append(len(params))
            return real(params, *args, **kwargs)

        monkeypatch.setattr(pt_step, "apply_updates_stochastic", counted)
        for _ in range(STEPS):
            setup.train_step(setup.state, batch, gen)
        monkeypatch.setattr(pt_step, "apply_updates_stochastic", real)
        results.append((setup, calls, torch.randint(1 << 30, (1,), generator=gen)))
    (one, one_calls, one_next), (chunked, chunked_calls, chunked_next) = results
    n = len(one.state.params["transformer"])
    assert one_calls == [n] * STEPS
    assert len(chunked_calls) > 2 * STEPS and sum(chunked_calls) == n * STEPS
    assert torch.equal(one_next, chunked_next)   # the same draws from the generator
    for key, value in one.state.params["transformer"].items():
        assert torch.equal(value.view(torch.int16),
                           chunked.state.params["transformer"][key].view(torch.int16)), key
    for name, t in one.state.opt_state["transformer"].tensors().items():
        assert torch.equal(t, chunked.state.opt_state["transformer"].tensors()[name]), name


def _cli_config(root: str, name: str, base: str, dataset: str, epochs: int) -> str:
    config = tiny_train_config(base, dataset, os.path.join(root, name, "ws"),
                               os.path.join(root, name, "cache"))
    config = PortTrainConfig.default_values().from_dict(config.to_dict())
    config.model_type = pt_enums.ModelType.FLUX_DEV_1
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.train_dtype = pt_enums.DataType.FLOAT_32
    config.gradient_checkpointing = pt_enums.GradientCheckpointingMethod.OFF
    config.optimizer.optimizer = pt_enums.Optimizer.ADAFACTOR
    config.prior.train = True
    config.text_encoder.train = config.text_encoder_2.train = False
    config.output_model_format = pt_enums.ModelFormat.SAFETENSORS
    config.output_model_destination = os.path.join(root, name, "out.safetensors")
    config.epochs = epochs
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(config.to_dict(), f)
    return path


def test_fine_tune_resume_from_a_single_file_equals_uninterrupted_training(tmp_path):
    """The train command fine-tunes a FLUX single file: two epochs at once,
    and one epoch with a backup (a BFL file `model.safetensors`) then a
    resume for the second; both end with the same transformer, bit for bit,
    in the single-file output, which the family loads again."""
    _, port = _pair("flux", DataType.FLOAT_32)
    _, config = _configs("flux", DataType.FLOAT_32)
    family = get_family(config.model_type)
    base = str(tmp_path / "flux.safetensors")
    family.save_single_file(family.create_setup(port, _fine_tune_nothing(config), 1), base)
    dataset = make_dataset(str(tmp_path / "data"), n=2)
    root = str(tmp_path)
    pt_train.main(["--config-path", _cli_config(root, "whole", base, dataset, 2),
                   "--device", "cpu"])
    first = _cli_config(root, "split", base, dataset, 1)
    pt_train.main(["--config-path", first, "--device", "cpu"])
    backups = os.listdir(os.path.join(root, "split", "ws", "backup"))
    assert len(backups) == 1
    backup = os.path.join(root, "split", "ws", "backup", backups[0])
    assert os.path.isfile(os.path.join(backup, "model.safetensors"))
    assert any(k.startswith("double_blocks.")
               for k in load_safetensors(os.path.join(backup, "model.safetensors")))
    with open(first) as f:
        data = json.load(f)
    data["epochs"], data["continue_last_backup"] = 2, True
    with open(first, "w") as f:
        json.dump(data, f)
    pt_train.main(["--config-path", first, "--device", "cpu"])
    whole = load_safetensors(os.path.join(root, "whole", "out.safetensors"))
    split = load_safetensors(os.path.join(root, "split", "out.safetensors"))
    start = load_safetensors(base)
    assert set(whole) == set(split)
    for key, value in whole.items():
        assert torch.equal(value, split[key]), key
    # the transformer trained (the bundled VAE and text encoders are frozen)
    transformer = [k for k in whole if not k.startswith(("first_stage_model.",
                                                         "text_encoders."))]
    moved = sum(not torch.equal(whole[k], start[k]) for k in transformer)
    assert moved > len(transformer) // 2
    again = family.load(os.path.join(root, "split", "out.safetensors"), config, device="cpu")
    trained = pt_families.merged_state_dicts(
        family.create_setup(again, _fine_tune_nothing(config), 1))["transformer"]
    assert all(not torch.equal(t, port.transformer.state_dict()[k])
               for k, t in trained.items() if k.endswith("to_q.weight"))


def _fine_tune_nothing(config):
    config = PortTrainConfig.default_values().from_dict(config.to_dict())
    config.prior.train = config.text_encoder.train = False
    return config
