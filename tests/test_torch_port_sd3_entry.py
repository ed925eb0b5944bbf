"""The port's SD3 entry points on a tiny diffusers directory:
`family.load` / `family.save_model` (onetrainer_tpu_torch/io/
sd3_checkpoints.py) against the reference's `load_sd3_diffusers`, the
port's train command (LoRA, backup, resume) and its sample command.

The directory holds tests/test_sd3.py's tiny SD3 with seeded weights
(tests/test_torch_port_sd3.py:write_sd3_dir). Loading is bitwise: the
port's modules hold the file's tensors, the reference's trees the same
ones. The model the port saves (a FINE_TUNE setup that trains nothing,
fp16) loads into the reference bit for bit as the fp16 cast of the
port's weights. The train command runs two epochs of one step each (LoRA
r4 on the transformer, text and latents cached, fp32) uninterrupted, and
again as one epoch with a backup and a resume from it: the resumed
adapters and optimizer state equal the uninterrupted run's within 1e-6
relative L2 (the same computation on the same draws; the generator is
re-seeded per step). The family's SAI single file round-trips bitwise,
and a FINE_TUNE config that trains a part (the transformer as `prior`,
or CLIP-L) builds that part's group, whose step moves it alone; the
train command no longer refuses it. Torch runs one thread.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.io.sd3_checkpoints import load_sd3_diffusers as jax_load
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
from onetrainer_tpu_torch.scripts import sample as pt_sample
from onetrainer_tpu_torch.scripts import train as pt_train
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_data import make_dataset
from tests.test_torch_port_sd3 import tiny_sd3_pair, write_sd3_dir
from tests.test_trainer import tiny_train_config

_TO_STATE_DICT = {"transformer": jax_tf.unet_flax_to_state_dict,
                  "vae": jax_tf.vae_flax_to_state_dict,
                  "text_encoder": jax_tf.clip_flax_to_state_dict,
                  "text_encoder_2": jax_tf.clip_flax_to_state_dict,
                  "text_encoder_3": jax_tf.t5_flax_to_state_dict}
_PARAMS = {"transformer": "transformer_params", "vae": "vae_params",
           "text_encoder": "te_params", "text_encoder_2": "te2_params",
           "text_encoder_3": "te3_params"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sd3_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd3")
    _, _, port = tiny_sd3_pair(seed=6)
    base = str(root / "ckpt")
    write_sd3_dir(base, port)
    return dict(root=str(root), base=base)


def _config(model_type=pt_enums.ModelType.STABLE_DIFFUSION_3):
    config = PortTrainConfig.default_values()
    config.model_type = model_type
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    config.train_dtype = pt_enums.DataType.FLOAT_32
    return config


def _reference_state_dicts(path: str, dtype=np.float32) -> dict:
    import jax.numpy as jnp
    loaded = jax_load(path, weight_dtype=dtype, compute_dtype=jnp.float32, device=False)
    return {name: _TO_STATE_DICT[name](jax.device_get(loaded[attr]))
            for name, attr in _PARAMS.items()}


def test_load_and_save_match_the_reference_bitwise(sd3_dir, tmp_path):
    family = get_family(pt_enums.ModelType.STABLE_DIFFUSION_3)
    model = family.load(sd3_dir["base"], _config(), device="cpu")
    assert model.transformer_config.remat_policy == "dots_nb_attn"
    assert model.te_config.projection_dim == 6 and model.vae_config.shift_factor == 0.0609
    ref = _reference_state_dicts(sd3_dir["base"])
    for name, module in model.modules().items():
        got = module.state_dict()
        assert set(got) == set(ref[name]), name
        for key, value in ref[name].items():
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)

    setup = family.create_setup(model, _config(), 1)
    assert setup.train_step is None
    out = str(tmp_path / "saved")
    family.save_model(setup, out, sd3_dir["base"], save_dtype=torch.float16)
    assert json.load(open(os.path.join(out, "transformer", "config.json"))) == json.load(
        open(os.path.join(sd3_dir["base"], "transformer", "config.json")))
    saved = _reference_state_dicts(out, np.float16)
    for name, module in model.modules().items():
        for key, value in module.state_dict().items():
            np.testing.assert_array_equal(
                np.asarray(saved[name][key]), value.to(torch.float16).numpy(), err_msg=key)
    # the SAI single file: every part back bit for bit
    single = str(tmp_path / "sd3.safetensors")
    family.save_single_file(setup, single)
    assert any(k.startswith("model.diffusion_model.joint_blocks.")
               for k in load_safetensors(single))
    again = family.load(single, _config(), device="cpu")
    for name, module in model.modules().items():
        for key, value in module.state_dict().items():
            assert torch.equal(again.modules()[name].state_dict()[key], value), key


def _train_config(root, name, base, ds, epochs):
    config = tiny_train_config(base, ds, os.path.join(root, name, "ws"),
                               os.path.join(root, name, "cache"))
    config = PortTrainConfig.default_values().from_dict(config.to_dict())
    config.model_type = pt_enums.ModelType.STABLE_DIFFUSION_3
    config.train_dtype = pt_enums.DataType.FLOAT_32
    config.gradient_checkpointing = pt_enums.GradientCheckpointingMethod.OFF
    config.prior.train = True
    config.text_encoder.train = config.text_encoder_2.train = False
    config.epochs = epochs
    return config


def _run(root, config, name):
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(config.to_dict(), f)
    return pt_train.main(["--config-path", path, "--device", "cpu"])


def _state(trainer) -> dict:
    state = trainer.setup.state
    out = {f"params/{g}/{k}/{n}": t.detach().numpy().copy()
           for g, tree in state.params.items() for k, e in tree.items() for n, t in e.items()}
    for g, opt in state.opt_state.items():
        out.update({f"{g}/mu/{i}": t.numpy().copy() for i, t in enumerate(opt.mu)})
        out.update({f"{g}/nu/{i}": t.numpy().copy() for i, t in enumerate(opt.nu)})
    return out


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_train_command_resumes_to_the_uninterrupted_run(sd3_dir):
    root, base = sd3_dir["root"], sd3_dir["base"]
    ds = make_dataset(os.path.join(root, "ds"), n=2)
    whole = _run(root, _train_config(root, "whole", base, ds, 2), "whole")
    assert whole.train_progress.global_step == 2
    lora = load_safetensors(whole.config.output_model_destination)
    assert any(k.startswith("lora_transformer_transformer_blocks_0_attn_to_q") for k in lora)
    cached = [load_safetensors(os.path.join(whole.config.cache_dir, f))
              for f in os.listdir(whole.config.cache_dir)]
    # CLIP's 16 rows, then T5's 77 (its tokenizer's default length)
    assert len(cached) == 2 and all(r["sd3_context"].shape == (16 + 77, 24)
                                    and r["sd3_pooled"].shape == (16,) for r in cached)

    first = _run(root, _train_config(root, "split", base, ds, 1), "split1")
    assert first.train_progress.global_step == 1
    config = _train_config(root, "split", base, ds, 2)
    config.continue_last_backup = True
    resumed = _run(root, config, "split2")
    assert resumed.train_progress.to_dict() == whole.train_progress.to_dict()
    want, got = _state(whole), _state(resumed)
    assert set(got) == set(want) and any(k.startswith("params/transformer_lora") for k in got)
    for key, value in want.items():
        if np.any(value):
            assert _rel_l2(got[key], value) <= 1e-6, key
        else:
            assert not np.any(got[key]), key


@pytest.mark.parametrize("part", ["prior", "text_encoder"])
def test_fine_tune_training_is_refused(sd3_dir, tmp_path, part):
    """SD3 FINE_TUNE is ported (it was refused until the DiT fine-tune
    slice): a config that trains the transformer (`prior`) or CLIP-L, the
    reference's FINE_TUNE groups, builds that group alone from the
    module's parameters; one step moves it and leaves every other part as
    it was; the train command passes its refusals and reaches the load."""
    config = _config()
    getattr(config, part).train = True
    config.text_encoder_2.train = False   # CLIP-G trains under LoRA only
    config.learning_rate_warmup_steps = 0.0
    family = get_family(pt_enums.ModelType.STABLE_DIFFUSION_3)
    model = family.load(sd3_dir["base"], _config(), device="cpu")
    setup = family.create_setup(model, config, 1)
    group = "transformer" if part == "prior" else "text_encoder"
    assert set(setup.state.params) == {group}
    assert setup.step_cfg.train_text_encoder is (part == "text_encoder")
    before = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in model.modules().items()}
    encode_images, encode_text = family.make_encode_fns(setup)
    images = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    batch = {k: torch.as_tensor(v) for k, v in encode_images(images).items()}
    texts = [encode_text(p) for p in ("a cat", "a red dog")]
    batch.update({k: torch.as_tensor(np.stack([np.asarray(t[k]) for t in texts]))
                  for k in texts[0]})
    batch["loss_weight"] = torch.ones(2)
    metrics = setup.train_step(setup.state, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    for name, module in model.modules().items():
        changed = any(not torch.equal(v, before[name][k])
                      for k, v in module.state_dict().items())
        assert changed is (name == group), name
    config.base_model_name = str(tmp_path / "absent")
    config.workspace_dir = str(tmp_path / "ws")
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(config.to_dict(), f)
    with pytest.raises(FileNotFoundError):
        pt_train.main(["--config-path", path, "--device", "cpu"])


def test_sample_command_writes_a_non_constant_image(sd3_dir, tmp_path):
    dest = str(tmp_path / "sd3.png")
    out = pt_sample.main(["--model-type", "STABLE_DIFFUSION_3", "--base-model-name",
                          sd3_dir["base"], "--prompt", "a cat", "--destination", dest,
                          "--steps", "2", "--width", "32", "--height", "32",
                          "--device", "cpu"])
    assert out.image.shape == (32, 32, 3) and out.image.std() > 0
    assert os.path.getsize(dest) > 0
