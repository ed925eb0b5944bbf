"""The torch port's train and sample entry points against the reference
(onetrainer_tpu/trainer/generic_trainer.py, scripts/train.py,
scripts/sample.py), on a tiny SD 1.5 checkpoint written as
tests/test_trainer.py:write_tiny_checkpoint writes one, over
tests/test_data.py:make_dataset, both trained in fp32 on the CPU.

1. `python -m onetrainer_tpu_torch.scripts.train` (its `main`, `--device
   cpu`) beside the reference's GenericTrainer on the same files and
   config: the same status sequence, the same number of steps, the same
   LoRA output keys, shapes and output dtype, the same modelspec keys.
2. The port's LoRA file, loaded into the reference through its own
   continue-from-LoRA path (peft/lora.py:apply_lora_checkpoint), gives the
   UNet output of the port's adapted UNet within rel L2 1e-5.
3. One epoch + backup + resume + one epoch equals two uninterrupted
   epochs: adapters and AdamW moments within rel L2 1e-6. The backup holds
   no model; the resume reads the base from base_model_name.
4. Every configuration the port's trainer does not run refuses.
5. The port's sample script writes a non-constant PNG.
6. F7 (ROADMAP queue 3): the reference's LoRA resume loads its backup's
   merged model (base + dW) as the base and restores the adapters on top,
   so its UNet then carries base + 2 dW; the port's resume carries base +
   dW, as OneTrainer's does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.io.torch_flax import unet_flax_to_state_dict
from onetrainer_tpu.setup.families import get_family as jax_get_family
from onetrainer_tpu.trainer.generic_trainer import GenericTrainer as JaxTrainer
from onetrainer_tpu.util.callbacks import TrainCallbacks as JaxCallbacks
from onetrainer_tpu.util.enums import DataType, GradientCheckpointingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.safetensors_io import SafetensorsFile, load_safetensors
from onetrainer_tpu_torch.scripts import sample as pt_sample
from onetrainer_tpu_torch.scripts import train as pt_train
from onetrainer_tpu_torch.setup.families import merged_state_dicts
from onetrainer_tpu_torch.trainer.generic_trainer import GenericTrainer
from onetrainer_tpu_torch.util import enums as pt_enums
from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
from onetrainer_tpu_torch.util.create import create_trainer
from tests.test_data import make_dataset
from tests.test_train_step import tiny_sd_model
from tests.test_trainer import tiny_train_config, write_tiny_checkpoint


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _config(root, name, base, ds):
    """tests/test_trainer.py's tiny LoRA config (2 epochs of 2 steps, batch
    2, r4 a8, lr 1e-3, latents and text cached, backup before the final
    save), trained in fp32 without checkpointing, with its own workspace."""
    config = tiny_train_config(base, ds, os.path.join(root, name, "ws"),
                               os.path.join(root, name, "cache"))
    config.train_dtype = DataType.FLOAT_32
    config.gradient_checkpointing = GradientCheckpointingMethod.OFF
    config.output_dtype = DataType.BFLOAT_16
    return config


def _port(config) -> PortTrainConfig:
    return PortTrainConfig.default_values().from_dict(config.to_dict())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference trainer and the port's CLI, each trained once on the
    same checkpoint and dataset."""
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("trainer"))
    base, ds = os.path.join(root, "ckpt"), make_dataset(os.path.join(root, "ds"), n=4)
    write_tiny_checkpoint(base, tiny_sd_model())

    ref_config = _config(root, "ref", base, ds)
    ref_statuses = []
    ref = JaxTrainer(ref_config, JaxCallbacks(on_update_status=ref_statuses.append))
    ref.start()
    ref.train()
    ref.end()

    port_config = _config(root, "port", base, ds)
    config_path = os.path.join(root, "port.json")
    with open(config_path, "w") as f:
        json.dump(port_config.to_dict(), f)
    port_statuses = []
    port = pt_train.main(["--config-path", config_path, "--device", "cpu"],
                         TrainCallbacks(on_update_status=port_statuses.append))
    return dict(root=root, base=base, ds=ds, ref=ref, ref_statuses=ref_statuses,
                port=port, port_statuses=port_statuses)


def test_cli_matches_the_reference_trainer(runs):
    ref, port = runs["ref"], runs["port"]
    assert runs["port_statuses"] == runs["ref_statuses"]
    assert runs["port_statuses"][:4] == ["loading the model", "creating the data loader",
                                         "epoch 0: caching", "training epoch 0"]
    assert port.train_progress.to_dict() == ref.train_progress.to_dict()
    assert port.train_progress.global_step == 4 and port.setup.state.step == 4
    ref_path, port_path = (t.config.output_model_destination for t in (ref, port))
    with SafetensorsFile(ref_path) as r, SafetensorsFile(port_path) as p:
        assert sorted(p.keys()) == sorted(r.keys())
        for key in r.keys():
            assert (p.shape(key), p.dtype(key)) == (r.shape(key), r.dtype(key)), key
        assert {p.dtype(k) for k in p.keys()} == {torch.bfloat16}
        assert set(p.metadata) == set(r.metadata)
        for key in ("modelspec.architecture", "modelspec.implementation",
                    "modelspec.resolution", "format"):
            assert p.metadata[key] == r.metadata[key], key
    lora = load_safetensors(port_path)
    assert max(float(v.float().abs().max()) for k, v in lora.items()
               if k.endswith("lora_up.weight")) > 0


def _unet_inputs():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2, 4, 4, 4), dtype=np.float32),
            np.asarray([10, 600], np.int32),
            rng.standard_normal((2, 16, 32), dtype=np.float32))


def _jax_unet_out(model, params, inputs):
    return np.asarray(jax.jit(model.unet.apply)({"params": params},
                                                *map(jnp.asarray, inputs)))


def test_port_lora_file_loads_into_the_reference(runs):
    port = runs["port"]
    config = _config(runs["root"], "ref_continue", runs["base"], runs["ds"])
    config.lora_model_name = port.config.output_model_destination
    config.output_dtype = DataType.FLOAT_32
    family = jax_get_family(config.model_type)
    model = family.load(runs["base"], config)
    setup = family.create_setup(model, config, 10)
    unet_params, _, _ = setup.merged_inference_params()
    inputs = _unet_inputs()
    ref = _jax_unet_out(model, unet_params, inputs)
    with torch.no_grad():
        out = port.model.unet(*map(torch.from_numpy, inputs)).numpy()
    # the file holds bf16 adapters (output_dtype); the port's UNet runs its
    # fp32 ones: compare against the port's adapters rounded the same way
    assert _rel_l2(out, ref) <= 5e-3
    saved = {k: v for k, v in port.setup.state.params["unet_lora"].items()}
    rounded = {k: {n: t.detach().clone() for n, t in e.items()} for k, e in saved.items()}
    with torch.no_grad():
        for key, entry in saved.items():
            for name, t in entry.items():
                t.copy_(t.to(torch.bfloat16).float())
        out_rounded = port.model.unet(*map(torch.from_numpy, inputs)).numpy()
        for key, entry in saved.items():
            for name, t in entry.items():
                t.copy_(rounded[key][name])
    assert _rel_l2(out_rounded, ref) <= 1e-5


def _run(config):
    trainer = GenericTrainer(config, device="cpu")
    trainer.start()
    trainer.train()
    trainer.end()
    return trainer


def _state_arrays(trainer) -> dict:
    state = trainer.setup.state
    out = {f"params/{g}/{k}/{n}": t.detach().numpy()
           for g, tree in state.params.items() for k, e in tree.items() for n, t in e.items()}
    for g, opt in state.opt_state.items():
        out.update({f"{g}/mu/{i}": t.numpy() for i, t in enumerate(opt.mu)})
        out.update({f"{g}/nu/{i}": t.numpy() for i, t in enumerate(opt.nu)})
        out[f"{g}/count"] = np.asarray(opt.count, np.float64)
    return out


def test_resume_equals_uninterrupted_training(runs):
    root, base, ds = runs["root"], runs["base"], runs["ds"]
    whole = _run(_port(_config(root, "whole", base, ds)))

    first = _port(_config(root, "split", base, ds))
    first.epochs = 1
    first = _run(first)
    backup = first.config.get_last_backup_path()
    assert sorted(os.listdir(backup)) == ["meta.json", "onetrainer_config",
                                          "optimizer.safetensors"]
    assert os.listdir(os.path.join(backup, "onetrainer_config")) == ["args.json"]
    with open(os.path.join(backup, "meta.json")) as f:
        assert json.load(f)["train_progress"] == {
            "epoch": 1, "epoch_step": 0, "epoch_sample": 0, "global_step": 2}

    config = _port(_config(root, "split", base, ds))
    config.continue_last_backup = True
    resumed = GenericTrainer(config, device="cpu")
    resumed.start()
    assert resumed.train_progress.global_step == 2 and resumed.setup.state.step == 2
    resumed.train()
    assert resumed.train_progress.to_dict() == whole.train_progress.to_dict()
    want, got = _state_arrays(whole), _state_arrays(resumed)
    assert set(got) == set(want)
    for key, value in want.items():
        if np.any(value):
            assert _rel_l2(got[key], value) <= 1e-6, key
        else:
            assert not np.any(got[key]), key


def _refuses(config):
    with pytest.raises(NotImplementedError):
        create_trainer(config, device="cpu").start()


@pytest.mark.parametrize("case", [
    "validation", "samples", "ema", "debug", "fine_tune", "embedding", "mesh",
    "circular", "offload", "cloud", "optimizer", "lora_file", "masks"])
def test_unported_configs_refuse(runs, monkeypatch, case):
    """Each feature the port's trainer does not run refuses at start():
    "ema" is the EMA held on the CPU, "masks" masked prior preservation (the EMA
    on the device, FINE_TUNE, masked training and gradient accumulation run:
    tests/test_torch_port_trainer_finetune.py). "optimizer", one other than
    AdamW and Adafactor, refused until the optimizer slice, now starts
    (tests/test_torch_port_optimizers.py holds them to the reference).
    "lora_file", continuing
    from a LoRA file, refused until the PEFT slice, now starts: the setup's
    adapters are the file's tensors (bf16 there, fp32 here: exact), at the
    file's rank and alpha. "fine_tune" (additional embeddings beside a
    fine-tune) and "embedding" (EMBEDDING training), refused until the
    embedding slice, now start: their setups train the vectors
    (tests/test_torch_port_embedding.py holds them to the reference)."""
    config = _port(_config(runs["root"], f"refuse_{case}", runs["base"], runs["ds"]))
    if case == "validation":
        config.validation = True
    elif case == "samples":
        from onetrainer_tpu_torch.config.sample_config import SampleConfig
        config.samples = [SampleConfig.default_values()]
    elif case == "ema":
        config.ema = pt_enums.EMAMode.CPU
    elif case == "debug":
        config.debug_mode = True
    elif case == "fine_tune":
        from onetrainer_tpu_torch.config.train_config import TrainEmbeddingConfig
        config.training_method = pt_enums.TrainingMethod.FINE_TUNE
        config.additional_embeddings = [TrainEmbeddingConfig.default_values()]
    elif case == "embedding":
        config.training_method = pt_enums.TrainingMethod.EMBEDDING
    elif case == "mesh":
        monkeypatch.setenv("OT_MESH_FSDP", "2")
    elif case == "circular":
        config.force_circular_padding = True
    elif case == "offload":
        config.gradient_checkpointing = pt_enums.GradientCheckpointingMethod.CPU_OFFLOADED
    elif case == "cloud":
        config.cloud.enabled = True
    elif case == "optimizer":
        config.optimizer.optimizer = pt_enums.Optimizer.LION
    elif case == "lora_file":
        config.lora_model_name = runs["port"].config.output_model_destination
    elif case == "masks":
        config.masked_training = True
        config.masked_prior_preservation_weight = 0.5
    if case in ("fine_tune", "embedding"):
        trainer = create_trainer(config, device="cpu")
        trainer.start()
        assert "embeddings" in trainer.setup.state.params
        assert trainer.setup.step_cfg.train_text_encoder
        return
    if case == "optimizer":
        from onetrainer_tpu_torch.train.optimizers import Lion
        trainer = create_trainer(config, device="cpu")
        trainer.start()
        assert all(isinstance(opt, Lion) for opt in trainer.setup.tx.groups.values())
        return
    if case != "lora_file":
        _refuses(config)
        return
    from onetrainer_tpu_torch.peft.lora import peft_to_kohya_state_dict
    config.lora_rank, config.lora_alpha = 2, 1.0   # the file's (r4, a8) win
    trainer = create_trainer(config, device="cpu")
    trainer.start()
    setup = trainer.setup
    assert (setup.peft_cfg.rank, setup.peft_cfg.alpha) == (4, 8.0)
    lora = load_safetensors(config.lora_model_name)
    got = peft_to_kohya_state_dict(setup.state.params["unet_lora"], setup.peft_cfg,
                                   "lora_unet")
    assert set(got) == {k for k in lora if k.startswith("lora_unet_")}
    for key, value in got.items():
        assert value.dtype == torch.float32, key
        assert torch.equal(value, lora[key].float().reshape(value.shape)), key


def test_entry_points_default_to_the_card():
    import inspect
    for fn in (create_trainer, GenericTrainer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert pt_train.parse_args(["--config-path", "x"]).device == "cuda"
    assert pt_sample.parse_args(["--model-type", "STABLE_DIFFUSION_15", "--base-model-name",
                                 "x", "--prompt", "p", "--destination", "d"]).device == "cuda"


def test_sample_script_writes_a_non_constant_image(runs, tmp_path):
    from PIL import Image
    dest = str(tmp_path / "out" / "cat.png")
    out = pt_sample.main(["--model-type", "STABLE_DIFFUSION_15", "--base-model-name",
                          runs["base"], "--prompt", "a cat", "--destination", dest,
                          "--steps", "2", "--width", "32", "--height", "32",
                          "--device", "cpu"])
    image = np.asarray(Image.open(dest))
    assert image.shape == (32, 32, 3) and image.dtype == np.uint8
    assert np.array_equal(image, out.image) and image.std() > 0
    with pytest.raises(NotImplementedError):   # a family the port has not ported
        pt_sample.main(["--model-type", "HI_DREAM_FULL", "--base-model-name", runs["base"],
                        "--prompt", "a", "--destination", dest, "--device", "cpu"])


def test_f7_reference_lora_resume_applies_the_adapters_twice(runs):
    """The reference's backup saves the merged model (base + dW) as
    <backup>/model, and its resume loads that as the base and restores the
    trained adapters on top of it: its UNet then carries base + 2 dW, one
    more dW than at backup time. The port's resume carries base + dW."""
    ref = runs["ref"]
    backup = ref.config.get_last_backup_path()
    assert os.path.isdir(os.path.join(backup, "model", "unet"))
    from onetrainer_tpu.config.train_config import TrainConfig
    config = TrainConfig.default_values().from_dict(ref.config.to_dict())
    config.continue_last_backup = True
    resumed = JaxTrainer(config)
    resumed.start()    # no step is left to train: only the load and restore

    base = unet_flax_to_state_dict(jax.device_get(
        jax_get_family(config.model_type).load(config.base_model_name, config).unet_params))
    at_backup = unet_flax_to_state_dict(jax.device_get(ref.setup.merged_inference_params()[0]))
    after = unet_flax_to_state_dict(jax.device_get(resumed.setup.merged_inference_params()[0]))
    delta = {k: at_backup[k] - base[k] for k in base}
    changed = [k for k in base if np.any(delta[k])]
    assert changed
    for key in changed:
        # after resume: base + 2 dW, where base + dW was trained
        np.testing.assert_allclose(after[key] - at_backup[key], delta[key],
                                   rtol=1e-3, atol=1e-6, err_msg=key)
    inputs = _unet_inputs()
    out_base = _jax_unet_out(resumed.model, jax.device_get(
        jax_get_family(config.model_type).load(config.base_model_name, config).unet_params),
        inputs)
    out_backup = _jax_unet_out(resumed.model, ref.setup.merged_inference_params()[0], inputs)
    out_after = _jax_unet_out(resumed.model, resumed.setup.merged_inference_params()[0],
                              inputs)
    moved, trained = _rel_l2(out_after, out_backup), _rel_l2(out_backup, out_base)
    worst = max(np.linalg.norm(after[k] - at_backup[k] - delta[k]) / np.linalg.norm(delta[k])
                for k in changed)
    print(f"F7: {len(changed)} of {len(base)} UNet tensors adapted; after the resume each "
          f"moved by dW again (worst rel L2 {worst:.3e}); UNet output rel L2 from the base "
          f"{trained:.4f} at backup, {_rel_l2(out_after, out_base):.4f} after the resume")
    assert moved > 0.5 * trained

    # the port's resume: base from base_model_name, adapters from the backup
    port = runs["port"]
    port_config = _port(ref.config)
    port_config.workspace_dir = port.config.workspace_dir
    port_config.cache_dir = port.config.cache_dir
    port_config.continue_last_backup = True
    port_resumed = GenericTrainer(port_config, device="cpu")
    port_resumed.start()
    for name, sd in merged_state_dicts(port.setup).items():
        for key, value in merged_state_dicts(port_resumed.setup)[name].items():
            assert torch.equal(value, sd[key]), (name, key)
