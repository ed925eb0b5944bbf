"""The port's FLUX entry points on a tiny diffusers directory:
`family.load` / `family.save_model` (onetrainer_tpu_torch/io/
flux_checkpoints.py) against the reference's `load_flux_diffusers`, the
port's train command (LoRA, backup, resume) and its sample command, and
what the port refuses.

The directory holds tests/test_flux.py's tiny FLUX with seeded weights,
laid out as FLUX.1-dev ships it: the transformer in three shards and T5
in two, each behind a `*.safetensors.index.json`. Loading is bitwise:
the port's modules hold the files' tensors, the reference's trees the
same ones. The model the port saves (a FINE_TUNE setup that trains
nothing, fp16, one file per component) loads into the reference bit for
bit as the fp16 cast of the port's weights. The train command runs two
epochs of one step each (LoRA r4 on the transformer over an INT_8 base,
as tests/test_trainer_flux.py's run; text and latents cached, fp32)
uninterrupted, and again as one epoch with a backup and a resume from it:
the resumed adapters and optimizer state equal the uninterrupted run's
within 1e-6 relative L2 (the same computation on the same draws; the
generator is re-seeded per step). Refused, each with NotImplementedError:
the BFL single file (load and save, FLUX.1-dev's and FLUX.1-fill's),
once; FINE_TUNE that trains a part and EMBEDDING training now set up and
step (tests/test_torch_port_dit_finetune.py and
tests/test_torch_port_embedding.py hold them to the reference). FLUX.1-fill itself runs
(tests/test_torch_port_flux_fill.py). Torch runs one thread.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.io.flux_checkpoints import load_flux_diffusers as jax_load
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.flux_checkpoints import save_flux_diffusers
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors, save_safetensors
from onetrainer_tpu_torch.models.flux_model import create_flux_model
from onetrainer_tpu_torch.scripts import sample as pt_sample
from onetrainer_tpu_torch.scripts import train as pt_train
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_data import make_dataset
from tests.test_torch_port_flux import tiny_flux_pair
from tests.test_trainer import tiny_train_config

_TO_STATE_DICT = {"transformer": jax_tf.unet_flax_to_state_dict,
                  "vae": jax_tf.vae_flax_to_state_dict,
                  "text_encoder": jax_tf.clip_flax_to_state_dict,
                  "text_encoder_2": jax_tf.t5_flax_to_state_dict}
_PARAMS = {"transformer": "transformer_params", "vae": "vae_params",
           "text_encoder": "te_params", "text_encoder_2": "te2_params"}
FLUX = pt_enums.ModelType.FLUX_DEV_1


def flux_config_jsons(model) -> dict:
    """Each component's config.json (diffusers' and transformers' keys) for
    a diffusers FLUX directory of the port's `model`."""
    t, v, c, t5 = model.transformer_config, model.vae_config, model.te_config, \
        model.te2_config
    return {
        "transformer": {
            "in_channels": t.in_channels, "out_channels": t.out_channels,
            "num_layers": t.num_layers, "num_single_layers": t.num_single_layers,
            "num_attention_heads": t.num_heads, "attention_head_dim": t.head_dim,
            "joint_attention_dim": t.joint_attention_dim,
            "pooled_projection_dim": t.pooled_projection_dim,
            "guidance_embeds": t.guidance_embeds, "axes_dims_rope": list(t.axes_dims_rope)},
        "vae": {"in_channels": v.in_channels, "out_channels": v.out_channels,
                "latent_channels": v.latent_channels,
                "block_out_channels": list(v.block_out_channels),
                "layers_per_block": v.layers_per_block, "scaling_factor": v.scaling_factor,
                "shift_factor": v.shift_factor},
        "text_encoder": {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                         "intermediate_size": c.intermediate_size,
                         "num_hidden_layers": c.num_layers,
                         "num_attention_heads": c.num_heads,
                         "max_position_embeddings": c.max_position_embeddings,
                         "hidden_act": c.hidden_act, "eos_token_id": c.eos_token_id,
                         "architectures": ["CLIPTextModel"]},
        "text_encoder_2": {"vocab_size": t5.vocab_size, "d_model": t5.d_model,
                           "d_kv": t5.d_kv, "d_ff": t5.d_ff, "num_layers": t5.num_layers,
                           "num_heads": t5.num_heads},
    }


def _shard(component_dir: str, stem: str, shards: int) -> None:
    """Split `<stem>.safetensors` into `shards` files behind an index."""
    path = os.path.join(component_dir, f"{stem}.safetensors")
    sd = load_safetensors(path)
    os.remove(path)
    keys = sorted(sd)
    weight_map = {}
    for i in range(shards):
        name = f"{stem}-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = keys[i::shards]
        save_safetensors(os.path.join(component_dir, name), {k: sd[k] for k in part})
        weight_map.update({k: name for k in part})
    with open(os.path.join(component_dir, f"{stem}.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


def write_flux_dir(base: str, model) -> None:
    """The port's FLUX `model` as a diffusers directory (fp32), its configs
    beside the weights, the transformer in three shards and T5 in two."""
    sds = {name: m.state_dict() for name, m in model.modules().items()}
    save_flux_diffusers(base, model, sds["transformer"], sds["vae"], sds["text_encoder"],
                        sds["text_encoder_2"])
    for name, config in flux_config_jsons(model).items():
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(config, f)
    _shard(os.path.join(base, "transformer"), "diffusion_pytorch_model", 3)
    _shard(os.path.join(base, "text_encoder_2"), "model", 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flux_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("flux")
    _, _, port = tiny_flux_pair(seed=6)
    base = str(root / "ckpt")
    write_flux_dir(base, port)
    return dict(root=str(root), base=base)


def _config(method=pt_enums.TrainingMethod.FINE_TUNE):
    config = PortTrainConfig.default_values()
    config.model_type = FLUX
    config.training_method = method
    config.prior.train = config.text_encoder.train = False
    config.train_dtype = pt_enums.DataType.FLOAT_32
    return config


def _reference_state_dicts(path: str, dtype=np.float32) -> dict:
    import jax.numpy as jnp
    loaded = jax_load(path, weight_dtype=dtype, compute_dtype=jnp.float32, device=False)
    return {name: _TO_STATE_DICT[name](jax.device_get(loaded[attr]))
            for name, attr in _PARAMS.items()}


def test_load_and_save_match_the_reference_bitwise(flux_dir, tmp_path):
    assert sorted(os.listdir(os.path.join(flux_dir["base"], "transformer"))) == [
        "config.json", "diffusion_pytorch_model-00001-of-00003.safetensors",
        "diffusion_pytorch_model-00002-of-00003.safetensors",
        "diffusion_pytorch_model-00003-of-00003.safetensors",
        "diffusion_pytorch_model.safetensors.index.json"]
    family = get_family(FLUX)
    model = family.load(flux_dir["base"], _config(), device="cpu")
    assert model.transformer_config.remat_policy == "full"
    assert model.te_config.projection_dim is None
    assert (model.vae_config.scaling_factor, model.vae_config.shift_factor) == (0.3611, 0.1159)
    ref = _reference_state_dicts(flux_dir["base"])
    for name, module in model.modules().items():
        got = module.state_dict()
        assert set(got) == set(ref[name]), name
        for key, value in ref[name].items():
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)

    setup = family.create_setup(model, _config(), 1)
    assert setup.train_step is None
    out = str(tmp_path / "saved")
    family.save_model(setup, out, flux_dir["base"], save_dtype=torch.float16)
    assert json.load(open(os.path.join(out, "transformer", "config.json"))) == json.load(
        open(os.path.join(flux_dir["base"], "transformer", "config.json")))
    saved = _reference_state_dicts(out, np.float16)
    for name, module in model.modules().items():
        for key, value in module.state_dict().items():
            np.testing.assert_array_equal(
                np.asarray(saved[name][key]), value.to(torch.float16).numpy(), err_msg=key)


def test_single_file_and_fill_are_refused(flux_dir, tmp_path):
    """The BFL single file is ported (it was refused until the DiT
    fine-tune slice): FLUX.1-dev's round-trips bit for bit, VAE and text
    encoders bundled; FLUX.1-fill's loads with its wider x_embedder read
    from the file."""
    family = get_family(FLUX)
    model = family.load(flux_dir["base"], _config(), device="cpu")
    setup = family.create_setup(model, _config(), 1)
    single = str(tmp_path / "flux.safetensors")
    family.save_single_file(setup, single)
    assert any(k.startswith("double_blocks.0.img_attn.qkv") for k in load_safetensors(single))
    again = family.load(single, _config(), device="cpu")
    for name, module in model.modules().items():
        for key, value in module.state_dict().items():
            assert torch.equal(again.modules()[name].state_dict()[key], value), key
    # FLUX.1-fill: the published model's 384 packed input channels, and a
    # single file's width from its x_embedder (a fill file of the tiny
    # model: its x_embedder widened to the fill layout's 4 + 2 inputs)
    fill = get_family(pt_enums.ModelType.FLUX_FILL_DEV_1)
    config = _config()
    config.model_type = pt_enums.ModelType.FLUX_FILL_DEV_1
    assert create_flux_model(config.model_type, device="meta").transformer_config \
        .in_channels == 384
    sd = load_safetensors(single)
    wide = torch.cat([sd["img_in.weight"]] * 6, dim=1)
    sd["img_in.weight"] = wide
    fill_file = str(tmp_path / "fill.safetensors")
    save_safetensors(fill_file, sd)
    fill_model = fill.load(fill_file, config, device="cpu")
    assert fill_model.transformer_config.in_channels == wide.shape[1]
    assert torch.equal(fill_model.transformer.x_embedder.weight, wide)


def _write_config(config, path) -> str:
    with open(path, "w") as f:
        json.dump(config.to_dict(), f)
    return path


@pytest.mark.parametrize("case", ["fine_tune_prior", "fine_tune_text_encoder", "embedding"])
def test_unported_training_is_refused(flux_dir, tmp_path, case):
    """FINE_TUNE (refused until the DiT fine-tune slice) and EMBEDDING
    (refused until the embedding slice) are ported: a config that trains
    the transformer (`prior`) or CLIP-L builds that group alone, one step
    moves it and no other part; an EMBEDDING config builds the CLIP-L and
    T5 vectors, and one step moves no part of the model; the train command
    passes its refusals and reaches the load."""
    match = None
    if case == "embedding":
        config = _config(pt_enums.TrainingMethod.EMBEDDING)
        config.learning_rate_warmup_steps = 0.0
    else:
        config = _config()
        getattr(config, case.removeprefix("fine_tune_")).train = True
        config.learning_rate_warmup_steps = 0.0
    family = get_family(FLUX)
    model = family.load(flux_dir["base"], _config(), device="cpu")
    if match:
        with pytest.raises(NotImplementedError, match=match):
            family.create_setup(model, config, 1)
    else:
        setup = family.create_setup(model, config, 1)
        group = {"fine_tune_prior": "transformer",
                 "fine_tune_text_encoder": "text_encoder"}.get(case)
        assert set(setup.state.params) == ({group} if group else {"embeddings", "embeddings_2"})
        before = {name: {k: v.clone() for k, v in m.state_dict().items()}
                  for name, m in model.modules().items()}
        encode_images, encode_text = family.make_encode_fns(setup)
        images = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        batch = {k: torch.as_tensor(v) for k, v in encode_images(images).items()}
        texts = [encode_text(p) for p in ("a <embedding> cat", "a red dog")]
        batch.update({k: torch.as_tensor(np.stack([np.asarray(t[k]) for t in texts]))
                      for k in texts[0]})
        batch["loss_weight"] = torch.ones(2)
        assert ("t5_hidden_state" in batch) is (group == "transformer")
        setup.train_step(setup.state, batch, torch.Generator().manual_seed(0))
        for name, module in model.modules().items():
            changed = any(not torch.equal(v, before[name][k])
                          for k, v in module.state_dict().items())
            assert changed is (name == group), name
    config.base_model_name = str(tmp_path / "absent")
    config.workspace_dir = str(tmp_path / "ws")
    path = _write_config(config, str(tmp_path / "config.json"))
    with pytest.raises(NotImplementedError if match else FileNotFoundError,
                       match=match):
        pt_train.main(["--config-path", path, "--device", "cpu"])


def _train_config(root, name, base, ds, epochs):
    config = tiny_train_config(base, ds, os.path.join(root, name, "ws"),
                               os.path.join(root, name, "cache"))
    config = PortTrainConfig.default_values().from_dict(config.to_dict())
    config.model_type = FLUX
    config.train_dtype = pt_enums.DataType.FLOAT_32
    config.gradient_checkpointing = pt_enums.GradientCheckpointingMethod.OFF
    config.prior.train = True
    config.prior.weight_dtype = pt_enums.DataType.INT_8
    config.text_encoder.train = config.text_encoder_2.train = False
    config.epochs = epochs
    return config


def _run(root, config, name):
    path = _write_config(config, os.path.join(root, f"{name}.json"))
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


def test_train_command_resumes_to_the_uninterrupted_run(flux_dir):
    from onetrainer_tpu_torch.ops.quant import QuantizedArray
    root, base = flux_dir["root"], flux_dir["base"]
    ds = make_dataset(os.path.join(root, "ds"), n=2)
    whole = _run(root, _train_config(root, "whole", base, ds, 2), "whole")
    assert whole.train_progress.global_step == 2
    assert isinstance(whole.model.transformer.transformer_blocks[0].norm1.linear.weight,
                      QuantizedArray)
    lora = load_safetensors(whole.config.output_model_destination)
    assert any(k.startswith("lora_transformer_transformer_blocks_0_attn_to_q")
               and k.endswith("lora_down.weight") for k in lora)
    assert any(k.startswith("lora_transformer_single_transformer_blocks_1_proj_mlp")
               for k in lora)
    cached = [load_safetensors(os.path.join(whole.config.cache_dir, f))
              for f in os.listdir(whole.config.cache_dir)]
    # T5's 77 rows (its tokenizer's default length), CLIP-L's pooled output
    assert len(cached) == 2 and all(r["t5_hidden_state"].shape == (77, 24)
                                    and r["clip_pooled_state"].shape == (20,)
                                    and r["latent_image"].shape == (16, 16, 4) for r in cached)

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


def test_sample_command_writes_a_non_constant_image(flux_dir, tmp_path):
    dest = str(tmp_path / "flux.png")
    out = pt_sample.main(["--model-type", "FLUX_DEV_1", "--base-model-name",
                          flux_dir["base"], "--prompt", "a cat", "--destination", dest,
                          "--steps", "2", "--cfg", "3.5", "--width", "32", "--height", "32",
                          "--device", "cpu"])
    assert out.image.shape == (32, 32, 3) and out.image.std() > 0
    assert os.path.getsize(dest) > 0
