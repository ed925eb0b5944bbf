"""F19 (ROADMAP queue 3): a FINE_TUNE run whose frozen part was quantized
(its weight dtype NFLOAT_4) writes its backup and its output, the part
dequantized as the reference's export dequantizes it
(onetrainer_tpu/io/sd_checkpoints.py:_to_numpy_tree: fp32 codes times
scales, then the save dtype).

Two runs per package, one epoch each through the trainers (the port's
`scripts/train.py`, the reference's GenericTrainer) on the same files:
the tiny SD 1.5 of tests/test_trainer.py with an NF4 text encoder and the
UNet fine-tuned, written as a single file; and tests/test_pixart.py's tiny
PixArt with an NF4 T5 and the transformer fine-tuned, written as a
diffusers directory (also PixArt's run of the train command against the
reference trainer: the same statuses and steps). Both base directories
are written from seeded numpy weights through the reference's key maps
(its writers' flax init costs more than the runs). The tiny text encoders' layers sit under the
4096-element quantization floor, so both packages' floor is lowered to 256
elements for these runs (their quantize_tree / quantize_module defaults).
The frozen encoder's exported tensors agree exactly (both sides decode the
same codes and scales in fp32, then cast to the output dtype); every other
exported tensor agrees in key, shape and dtype (the trained parts took
different random draws). The port's backup holds the model.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.ops import quant as jax_quant
from onetrainer_tpu.trainer.generic_trainer import GenericTrainer as JaxTrainer
from onetrainer_tpu.io.safetensors_io import save_safetensors as jax_save
from onetrainer_tpu.util.callbacks import TrainCallbacks as JaxCallbacks
from onetrainer_tpu.util.enums import DataType, ModelFormat, TrainingMethod
from onetrainer_tpu_torch.io.safetensors_io import SafetensorsFile, load_safetensors
from onetrainer_tpu_torch.ops import quant as pt_quant
from onetrainer_tpu_torch.scripts import train as pt_train
from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
from tests.test_data import make_dataset
from tests.test_torch_port_models import _random_like
from tests.test_torch_port_pixart import tiny_pixart_pair, trainer_config, write_pixart_dir
from tests.test_trainer import tiny_train_config

FLOOR = 256


@pytest.fixture(autouse=True)
def lowered_floor(monkeypatch):
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(jax_quant.quantize_tree, "__defaults__",
                        (jnp.float8_e4m3fn, FLOOR, jnp.bfloat16))
    # the port's function behind its no_grad wrapper
    monkeypatch.setattr(pt_quant.quantize_module.__wrapped__, "__defaults__", ("nf4", FLOOR))
    yield
    torch.set_num_threads(torch_threads)


# tests/test_trainer.py:write_tiny_checkpoint's configs
_SD_CONFIGS = {
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "layers_per_block": 1, "attention_head_dim": 4, "cross_attention_dim": 32,
             "use_linear_projection": False},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [32, 64], "layers_per_block": 1, "scaling_factor": 0.18215},
    "text_encoder": {"vocab_size": 100, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "max_position_embeddings": 16, "hidden_act": "quick_gelu",
                     "eos_token_id": 99},
}


def write_sd_dir(base: str, seed: int = 1) -> None:
    """The tiny SD 1.5 as a diffusers directory with seeded weights, its
    tensors named by the port's modules built from the configs (diffusers'
    and transformers' keys)."""
    from onetrainer_tpu_torch.io import sd_checkpoints as pt_io
    from onetrainer_tpu_torch.models.sd import StableDiffusionModel
    from onetrainer_tpu_torch.util.enums import ModelType as PortModelType
    model = StableDiffusionModel(
        model_type=PortModelType.STABLE_DIFFUSION_15,
        unet_config=pt_io.unet_config_from_diffusers(_SD_CONFIGS["unet"]),
        vae_config=pt_io.vae_config_from_diffusers(_SD_CONFIGS["vae"]),
        te_config=pt_io.clip_config_from_transformers(_SD_CONFIGS["text_encoder"]),
        device="cpu")
    rng = np.random.default_rng(seed)
    for name, module in (("unet", model.unet), ("vae", model.vae),
                         ("text_encoder", model.text_encoder)):
        sd = {k: _random_like(k, v, rng) for k, v in module.state_dict().items()
              if k != "text_model.embeddings.position_ids"}
        os.makedirs(os.path.join(base, name), exist_ok=True)
        weights = "model" if name == "text_encoder" else "diffusion_pytorch_model"
        jax_save(os.path.join(base, name, f"{weights}.safetensors"), sd)
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(_SD_CONFIGS[name], f)
    os.makedirs(os.path.join(base, "scheduler"), exist_ok=True)
    with open(os.path.join(base, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"prediction_type": "epsilon", "beta_schedule": "scaled_linear"}, f)


def _sd_config(root, name, base, ds):
    config = tiny_train_config(base, ds, os.path.join(root, name, "ws"),
                               os.path.join(root, name, "cache"))
    config.training_method = TrainingMethod.FINE_TUNE
    config.epochs = 1
    config.train_dtype = DataType.FLOAT_32
    config.output_dtype = DataType.FLOAT_32
    config.unet.train = True
    config.text_encoder.train = False
    config.text_encoder.weight_dtype = DataType.NFLOAT_4
    config.output_model_format = ModelFormat.SAFETENSORS
    config.output_model_destination = os.path.join(root, name, "out.safetensors")
    return config


def _pixart_config(root, name, base, ds):
    config = trainer_config(root, name, base, ds)
    config.training_method = TrainingMethod.FINE_TUNE
    config.output_dtype = DataType.FLOAT_32
    config.text_encoder.weight_dtype = DataType.NFLOAT_4
    config.output_model_format = ModelFormat.DIFFUSERS
    config.output_model_destination = os.path.join(root, name, "out")
    config.backup_before_save = True
    return config


def _run_both(root, make_config, base, ds):
    """The reference trainer and the port's train command on one config:
    the same statuses and steps. -> (reference config, port config, the
    port's trainer)."""
    ref_config = make_config(root, "ref", base, ds)
    ref_statuses, port_statuses = [], []
    ref = JaxTrainer(ref_config, JaxCallbacks(on_update_status=ref_statuses.append))
    ref.start()
    ref.train()
    ref.end()
    port_config = make_config(root, "port", base, ds)
    path = os.path.join(root, "port.json")
    with open(path, "w") as f:
        json.dump(port_config.to_dict(), f)
    port = pt_train.main(["--config-path", path, "--device", "cpu"],
                         TrainCallbacks(on_update_status=port_statuses.append))
    assert port_statuses == ref_statuses
    assert port.train_progress.to_dict() == ref.train_progress.to_dict()
    assert port.train_progress.global_step == 2
    return ref_config, port_config, port


def _assert_keys(ref_path, port_path):
    """The same keys, shapes and dtypes."""
    with SafetensorsFile(ref_path) as r, SafetensorsFile(port_path) as p:
        assert sorted(p.keys()) == sorted(r.keys())
        for key in r.keys():
            assert (p.shape(key), p.dtype(key)) == (r.shape(key), r.dtype(key)), key


def _assert_same_files(ref_path, port_path, frozen_prefix):
    """The same keys, shapes and dtypes; the frozen part's tensors (keys
    under `frozen_prefix`) equal."""
    _assert_keys(ref_path, port_path)
    ref, port = load_safetensors(ref_path), load_safetensors(port_path)
    frozen = [k for k in ref if k.startswith(frozen_prefix)]
    assert frozen
    for key in frozen:
        assert torch.equal(port[key], ref[key]), key
    return ref, port


def test_sd15_fine_tune_with_an_nf4_text_encoder_writes_its_output(tmp_path):
    root = str(tmp_path)
    base, ds = os.path.join(root, "ckpt"), make_dataset(os.path.join(root, "ds"), n=4)
    write_sd_dir(base)
    ref_config, port_config, port = _run_both(root, _sd_config, base, ds)
    assert pt_quant.module_is_quantized(port.setup.model.text_encoder)
    ref, out = _assert_same_files(ref_config.output_model_destination,
                                  port_config.output_model_destination, "cond_stage_model.")
    # the NF4 round trip moved the text encoder's weights off the base's
    base_te = load_safetensors(os.path.join(base, "text_encoder", "model.safetensors"))
    q = out["cond_stage_model.transformer.text_model.encoder.layers.0.self_attn.q_proj.weight"]
    want = base_te["text_model.encoder.layers.0.self_attn.q_proj.weight"]
    assert 0 < float((q - want).abs().max()) < 0.5 * float(want.abs().max())
    backups = os.listdir(os.path.join(port_config.workspace_dir, "backup"))
    assert len(backups) == 1
    backup = os.path.join(port_config.workspace_dir, "backup", backups[0], "model")
    saved = load_safetensors(os.path.join(backup, "text_encoder", "model.safetensors"))
    np.testing.assert_array_equal(
        saved["text_model.encoder.layers.0.self_attn.q_proj.weight"].numpy(), q.numpy())


def test_pixart_fine_tune_with_an_nf4_t5_writes_its_output(tmp_path):
    root = str(tmp_path)
    base, ds = os.path.join(root, "ckpt"), make_dataset(os.path.join(root, "ds"), n=4)
    write_pixart_dir(base, tiny_pixart_pair()[1])
    ref_config, port_config, port = _run_both(root, _pixart_config, base, ds)
    assert pt_quant.module_is_quantized(port.setup.model.text_encoder)
    assert not pt_quant.module_is_quantized(port.setup.model.transformer)
    for name, stem, frozen in (("text_encoder", "model", True),
                               ("vae", "diffusion_pytorch_model", True),
                               ("transformer", "diffusion_pytorch_model", False)):
        paths = [os.path.join(c.output_model_destination, name, f"{stem}.safetensors")
                 for c in (ref_config, port_config)]
        if frozen:
            _assert_same_files(*paths, frozen_prefix="")
        else:
            _assert_keys(*paths)
    backups = os.listdir(os.path.join(port_config.workspace_dir, "backup"))
    assert len(backups) == 1
    assert os.path.exists(os.path.join(port_config.workspace_dir, "backup", backups[0],
                                       "model", "text_encoder", "model.safetensors"))

