"""FINE_TUNE through the torch port's train command against the reference
trainer (onetrainer_tpu/trainer/generic_trainer.py), on the tiny SD 1.5
checkpoint and dataset of tests/test_torch_port_trainer.py (one image
carries a `-masklabel.png` mask), in the style of tests/test_trainer.py's
fine-tune runs: the UNet trained in fp32 with AdamW, masked training
(unmasked weight 0.1, area-normalized), zero-terminal-SNR rescaling
(which forces v-prediction), an EMA (decay 0.999, every update) and
gradient accumulation 2, two epochs of two micro-steps, the output a
single safetensors file.

1. `python -m onetrainer_tpu_torch.scripts.train` (its `main`, `--device
   cpu`) beside the reference's GenericTrainer on the same files and
   config: the same status sequence and progress, the same output keys,
   shapes and dtype. The port's step takes the reference trainer's draws
   (timesteps, noise and latent noise from its own key splits, as
   tests/test_torch_port_train_finetune.py replays them), and each
   micro-step's batch from the port's loader holds the reference loader's
   latents (within LATENT_TOL: each side encodes with its own VAE) and
   its latent masks bit for bit. So the two outputs hold the same
   training: the frozen VAE and text encoder bit for bit, and the UNet's
   change from the base (the EMA after two updates on the reference's
   accumulation cadence, schedule and masks) within FT_REL relative L2 of
   the reference's, the bound of the step parity, over every tensor but
   the ZERO_GRADIENT ones and every element but the OUTLIERS furthest
   apart; those, and every element, within 2 lr.

   AdamW moves an element by about lr in each update whatever the size of
   its gradient, until that gradient nears AdamW's eps (1e-8): there each
   side's rounding noise decides the share of lr it moves by. That holds
   for two kinds of element. The ZERO_GRADIENT tensors' exact gradient is
   zero: the tiny UNet's 32-channel blocks normalize with one channel per
   group, so a per-channel constant added ahead of such a GroupNorm (a
   resnet's conv1 bias and time embedding; the biases that up_blocks.1's
   last resnet and attention add to the stream before the output norm)
   leaves the loss unchanged. Their gradients are rounding noise (at most 1.5e-8
   here, against 7e-4 for the next tensor and 0.29 for the largest); the
   test finds them from the port's gradient of the first micro-step, as
   the tensors below ZERO_GRAD_REL of the largest gradient, and checks
   that they are exactly those (0.59 lr apart at most here). And a few
   elements of the other tensors have two micro-batch gradients that
   cancel in the accumulated mean down to eps; which elements, depends on
   the data, whose crops and flips the loader seeds from each image's
   path. Over six runs the rest was 0.9-2.0e-5 apart, and 0.7-1.4e-4
   with the OUTLIERS (up to 3.9e-4 in eight more runs); no element of
   these tensors was more than 0.13 lr apart. Dropping
   the mask put the whole at 0.72, an LR warm-up of two steps at 0.71,
   and the EMA's warm-up one update ahead at 0.049.
2. One epoch, a backup, and a resume for the second epoch equal two
   uninterrupted epochs bit for bit: the UNet, the EMA, the AdamW moments,
   the accumulated gradients and the counts; the backup holds the trained
   model (`model/`, fp32), the optimizer state and `ema.safetensors`, and
   the resume loads the model from it. The fp16 output read back is the
   EMA cast to fp16, bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from onetrainer_tpu.trainer.generic_trainer import GenericTrainer as JaxTrainer
from onetrainer_tpu.util.callbacks import TrainCallbacks as JaxCallbacks
from onetrainer_tpu.util.enums import (
    DataType, EMAMode, GradientCheckpointingMethod, ModelFormat, TrainingMethod,
)
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io import ldm
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
from onetrainer_tpu_torch.scripts import train as pt_train
from onetrainer_tpu_torch.train.optimizers import opt_state_tensors
from onetrainer_tpu_torch.trainer.generic_trainer import GenericTrainer
from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
from tests.test_data import make_dataset
from tests.test_torch_port_train_finetune import FT_REL
from tests.test_torch_port_train_sdxl import _jax_draws
from tests.test_train_step import tiny_sd_model
from tests.test_trainer import tiny_train_config, write_tiny_checkpoint

LR = 1e-3
LATENT_TOL = 1e-4
ZERO_GRAD_REL = 1e-5
OUTLIERS = 100
ZERO_GRADIENT = {
    f"{block}.resnets.{i}.{name}"
    for block, resnets in (("down_blocks.0", (0,)), ("up_blocks.1", (0, 1)))
    for i in resnets for name in ("conv1.bias", "time_emb_proj.weight", "time_emb_proj.bias")
} | {f"up_blocks.1.{name}" for name in (
    "resnets.1.conv2.bias", "resnets.1.conv_shortcut.bias", "attentions.1.proj_out.bias",
    "attentions.1.transformer_blocks.0.ff.net.2.bias")}


def _config(root, name, base, ds, output_dtype=DataType.FLOAT_32):
    config = tiny_train_config(base, ds, os.path.join(root, name, "ws"),
                               os.path.join(root, name, "cache"))
    config.training_method = TrainingMethod.FINE_TUNE
    config.learning_rate = LR
    config.train_dtype = DataType.FLOAT_32
    config.gradient_checkpointing = GradientCheckpointingMethod.OFF
    config.masked_training = True
    config.unmasked_weight = 0.1
    config.normalize_masked_area_loss = True
    config.rescale_noise_scheduler_to_zero_terminal_snr = True
    config.ema = EMAMode.GPU
    config.ema_decay = 0.999
    config.ema_update_step_interval = 1
    config.gradient_accumulation_steps = 2
    config.output_dtype = output_dtype
    config.output_model_format = ModelFormat.SAFETENSORS
    config.output_model_destination = os.path.join(root, name, "out.safetensors")
    return config


def _port(config) -> PortTrainConfig:
    return PortTrainConfig.default_values().from_dict(config.to_dict())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("trainer_ft"))
    base, ds = os.path.join(root, "ckpt"), make_dataset(os.path.join(root, "ds"), n=4)
    write_tiny_checkpoint(base, tiny_sd_model())

    ref_config = _config(root, "ref", base, ds)
    ref_statuses = []
    ref = JaxTrainer(ref_config, JaxCallbacks(on_update_status=ref_statuses.append))
    ref.start()
    ref_steps = {}
    ref_step = ref.setup.train_step

    def recording_step(state, frozen, batch, rng):
        step = int(state.step)
        ref_steps[step] = dict(draws=_jax_draws(ref.setup.step_cfg, batch, rng, step),
                               batch={k: np.asarray(v) for k, v in batch.items()})
        return ref_step(state, frozen, batch, rng)

    ref.setup.train_step = recording_step
    ref.train()
    ref.end()

    config_path = os.path.join(root, "port.json")
    with open(config_path, "w") as f:
        json.dump(_config(root, "port", base, ds).to_dict(), f)
    port_statuses, port_batches, grad_max = [], {}, {}
    start = GenericTrainer.start

    def start_on_reference_draws(trainer):
        start(trainer)
        port_step = trainer.setup.train_step

        def replaying_step(state, batch, generator):
            port_batches[state.step] = {k: np.asarray(v) for k, v in batch.items()}
            draws = {k: torch.from_numpy(v.copy())
                     for k, v in ref_steps[state.step]["draws"].items()}
            if state.step == 0:
                unet = state.params["unet"]
                with torch.enable_grad():
                    grads = torch.autograd.grad(
                        port_step.loss(batch, generator, **draws), list(unet.values()),
                        allow_unused=True)
                grad_max.update({name: 0.0 if g is None else float(g.abs().max())
                                 for name, g in zip(unet, grads)})
            return port_step(state, batch, generator, **draws)

        trainer.setup.train_step = replaying_step

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(GenericTrainer, "start", start_on_reference_draws)
        port = pt_train.main(["--config-path", config_path, "--device", "cpu"],
                             TrainCallbacks(on_update_status=port_statuses.append))
    return dict(root=root, base=base, ds=ds, ref=ref, ref_statuses=ref_statuses,
                ref_steps=ref_steps, port=port, port_statuses=port_statuses,
                port_batches=port_batches, grad_max=grad_max)


def _unet_change(out: dict, base: dict, names) -> np.ndarray:
    trained = ldm.split_sd15_single_file(out)["unet"]
    assert set(trained) == set(base)
    return np.concatenate([(trained[k].double() - base[k].double()).ravel().numpy()
                           for k in names])


def test_fine_tune_cli_matches_the_reference_trainer(runs):
    ref, port = runs["ref"], runs["port"]
    assert runs["port_statuses"] == runs["ref_statuses"]
    assert port.train_progress.to_dict() == ref.train_progress.to_dict()
    assert port.train_progress.global_step == 4 and port.setup.state.step == 4
    assert port.setup.state.ema.step == int(ref.setup.state.ema.step) == 2
    assert port.model.prediction_type == ref.model.prediction_type == "v_prediction"
    assert port.setup.step_cfg.loss.masked_training
    # the same batches, micro-step by micro-step
    ref_steps, port_batches = runs["ref_steps"], runs["port_batches"]
    assert sorted(port_batches) == sorted(ref_steps) == [0, 1, 2, 3]
    assert any(float(r["batch"]["latent_mask"].min()) < 1.0 for r in ref_steps.values())
    for step, recorded in ref_steps.items():
        want_batch, got_batch = recorded["batch"], port_batches[step]
        np.testing.assert_array_equal(got_batch["latent_mask"], want_batch["latent_mask"])
        np.testing.assert_allclose(got_batch["latent_image"], want_batch["latent_image"],
                                   rtol=0, atol=LATENT_TOL)
    want = load_safetensors(ref.config.output_model_destination)
    got = load_safetensors(port.config.output_model_destination)
    assert sorted(got) == sorted(want)
    unet = [k for k in want if k.startswith("model.diffusion_model.")]
    assert unet and len(unet) < len(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == value.dtype, key
        if key not in unet:
            assert torch.equal(got[key], value), key
    base = load_safetensors(os.path.join(runs["base"], "unet",
                                         "diffusion_pytorch_model.safetensors"))
    grad_max = runs["grad_max"]
    assert set(grad_max) == set(base)
    largest = max(grad_max.values())
    assert {k for k, m in grad_max.items() if m <= ZERO_GRAD_REL * largest} == ZERO_GRADIENT
    zero = sorted(ZERO_GRADIENT)
    assert np.abs(_unet_change(got, base, zero) - _unet_change(want, base, zero)).max() \
        <= 2 * LR
    trained = sorted(set(base) - ZERO_GRADIENT)
    got_change, want_change = _unet_change(got, base, trained), _unet_change(want, base, trained)
    diff = got_change - want_change
    assert np.abs(diff).max() <= 2 * LR
    rest = np.argsort(np.abs(diff))[:-OUTLIERS]
    rel = float(np.linalg.norm(diff[rest]) / np.linalg.norm(want_change[rest]))
    print(f"UNet change from the base: {rel:.3g} relative L2 from the reference's "
          f"without the {OUTLIERS} elements furthest apart "
          f"({np.linalg.norm(diff) / np.linalg.norm(want_change):.3g} with them; "
          f"those differ by at most {np.abs(diff).max() / LR:.3g} lr)")
    assert rel <= FT_REL


def _run(config):
    trainer = GenericTrainer(config, device="cpu")
    trainer.start()
    trainer.train()
    trainer.end()
    return trainer


def _state(trainer) -> dict:
    state = trainer.setup.state
    out = {f"unet/{k}": t.detach().clone() for k, t in state.params["unet"].items()}
    out.update({f"ema/{k}": t.clone() for k, t in state.ema.params["unet"].items()})
    tensors, counts = opt_state_tensors(state.opt_state)
    out.update({f"opt/{k}": t.clone() for k, t in tensors.items()})
    out.update({f"count/{k}": torch.tensor(v) for k, v in counts.items()})
    out["ema_step"] = torch.tensor(state.ema.step)
    return out


def test_fine_tune_resume_equals_uninterrupted_training(runs):
    root, base, ds = runs["root"], runs["base"], runs["ds"]
    whole = _run(_port(_config(root, "whole", base, ds, DataType.FLOAT_16)))

    first = _port(_config(root, "split", base, ds, DataType.FLOAT_16))
    first.epochs = 1
    first = _run(first)
    backup = first.config.get_last_backup_path()
    assert sorted(os.listdir(backup)) == ["ema.safetensors", "meta.json", "model",
                                          "onetrainer_config", "optimizer.safetensors"]
    saved = load_safetensors(os.path.join(backup, "model", "unet",
                                          "diffusion_pytorch_model.safetensors"))
    assert all(saved[k].dtype == torch.float32 and torch.equal(saved[k], t.detach())
               for k, t in first.setup.state.params["unet"].items())

    config = _port(_config(root, "split", base, ds, DataType.FLOAT_16))
    config.continue_last_backup = True
    resumed = GenericTrainer(config, device="cpu")
    resumed.start()
    assert resumed._source_dir == os.path.join(backup, "model")
    assert resumed.setup.state.step == 2 and resumed.setup.state.ema.step == 1
    resumed.train()
    resumed.end()
    assert resumed.train_progress.to_dict() == whole.train_progress.to_dict()
    want, got = _state(whole), _state(resumed)
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key

    out = load_safetensors(resumed.config.output_model_destination)
    ema = resumed.setup.state.ema.params["unet"]
    unet_out = ldm.split_sd15_single_file(out)["unet"]
    assert set(unet_out) == set(ema)
    for key, value in ema.items():
        assert unet_out[key].dtype == torch.float16
        assert torch.equal(unet_out[key], value.to(torch.float16)), key
