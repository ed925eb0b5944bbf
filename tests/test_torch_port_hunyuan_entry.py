"""The port's HunyuanVideo entry points on a tiny diffusers directory: the
key maps (the port's copies of onetrainer_tpu/io/hunyuan_checkpoints.py's),
`family.load` / `family.save_model` (onetrainer_tpu_torch/io/
hunyuan_checkpoints.py) against the reference's `load_hunyuan_diffusers`,
the family entry, the port's train command over videos and images (LoRA,
backup, resume) and its sample command, and what the port refuses.

The directory holds tests/test_trainer_hunyuan.py's tiny HunyuanVideo with
seeded weights in the diffusers layout (the patchify kernel as a conv3d
[48, 16, 1, 2, 2], Llama in two shards behind an index). Key maps and
loading are bitwise: the port's modules hold the files' tensors, the
reference's trees the same ones. The model the port saves (a FINE_TUNE
setup that trains nothing, fp16, one file per component) loads into the
reference bit for bit as the fp16 cast of the port's weights. The train
command runs two epochs (two 9-frame videos and two images at 32x32,
batch 2: one video batch and one image batch per epoch; LoRA r4 on the
transformer, text and latents cached, fp32) uninterrupted, and again as
one epoch with a backup and a resume from it: the resumed adapters and
optimizer state equal the uninterrupted run's within 1e-6 relative L2.
EMBEDDING training (refused until the embedding slice) sets up and steps,
output embeddings patch Llama's cropped states (tests/test_torch_port_embedding.py
holds both to the reference); FINE_TUNE of the transformer sets up and steps
(tests/test_torch_port_hunyuan_ft.py holds it to the reference). The reference's saver writes no VAE or CLIP weights (ROADMAP
F12), the port's writes every component. Torch runs one thread.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from onetrainer_tpu.io import hunyuan_checkpoints as jax_io
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io import hunyuan_checkpoints as pt_io
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors, save_safetensors
from onetrainer_tpu_torch.scripts import sample as pt_sample
from onetrainer_tpu_torch.scripts import train as pt_train
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_hunyuan import tiny_hunyuan_pair
from tests.test_trainer import tiny_train_config
from tests.test_trainer_hunyuan import make_video_dataset

_TO_STATE_DICT = {"transformer": jax_io.hunyuan_flax_to_state_dict,
                  "vae": jax_io.video_vae_flax_to_state_dict,
                  "text_encoder": jax_io.llama_flax_to_state_dict,
                  "text_encoder_2": jax_tf.clip_flax_to_state_dict}
_PARAMS = {"transformer": "transformer_params", "vae": "vae_params",
           "text_encoder": "te_params", "text_encoder_2": "te2_params"}
HUNYUAN = pt_enums.ModelType.HUNYUAN_VIDEO


def hunyuan_config_jsons(model) -> dict:
    """Each component's config.json (diffusers' and transformers' keys) for
    a diffusers HunyuanVideo directory of the port's `model`."""
    t, v, ll, c = model.transformer_config, model.vae_config, model.te_config, \
        model.te2_config
    clip = {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "intermediate_size": c.intermediate_size, "num_hidden_layers": c.num_layers,
            "num_attention_heads": c.num_heads,
            "max_position_embeddings": c.max_position_embeddings,
            "hidden_act": c.hidden_act, "eos_token_id": c.eos_token_id,
            "architectures": ["CLIPTextModel"]}
    if c.projection_dim is not None:
        clip.update(projection_dim=c.projection_dim,
                    architectures=["CLIPTextModelWithProjection"])
    return {
        "transformer": {
            "in_channels": t.in_channels, "out_channels": t.out_channels,
            "num_layers": t.num_layers, "num_single_layers": t.num_single_layers,
            "num_refiner_layers": t.num_refiner_layers,
            "num_attention_heads": t.num_heads, "attention_head_dim": t.head_dim,
            "text_embed_dim": t.text_embed_dim,
            "pooled_projection_dim": t.pooled_projection_dim,
            "guidance_embeds": t.guidance_embeds, "rope_axes_dim": list(t.axes_dims_rope)},
        "vae": {"in_channels": v.in_channels, "latent_channels": v.latent_channels,
                "block_out_channels": list(v.block_out_channels),
                "layers_per_block": v.layers_per_block,
                "temporal_compression_ratio": v.temporal_compression,
                "spatial_compression_ratio": v.spatial_compression,
                "scaling_factor": v.scaling_factor},
        "text_encoder": {"vocab_size": ll.vocab_size, "hidden_size": ll.hidden_size,
                         "intermediate_size": ll.intermediate_size,
                         "num_hidden_layers": ll.num_layers,
                         "num_attention_heads": ll.num_heads,
                         "num_key_value_heads": ll.num_kv_heads, "head_dim": ll.head_dim,
                         "rope_theta": ll.rope_theta, "rms_norm_eps": ll.rms_norm_eps},
        "text_encoder_2": clip,
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


def write_hunyuan_dir(base: str, model) -> None:
    """The port's HunyuanVideo `model` as a diffusers directory (fp32) with
    the port's saver, its configs beside the weights, Llama in two shards."""
    sds = {name: m.state_dict() for name, m in model.modules().items()}
    pt_io.save_hunyuan_diffusers(base, model, sds["transformer"], sds["vae"],
                                 sds["text_encoder"], sds["text_encoder_2"])
    for name, config in hunyuan_config_jsons(model).items():
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(config, f)
    _shard(os.path.join(base, "text_encoder"), "model", 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def hunyuan_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("hunyuan")
    _, params, port = tiny_hunyuan_pair(seed=6)
    base = str(root / "ckpt")
    write_hunyuan_dir(base, port)
    return dict(root=str(root), base=base, params=params)


def _config(method=pt_enums.TrainingMethod.FINE_TUNE):
    config = PortTrainConfig.default_values()
    config.model_type = HUNYUAN
    config.training_method = method
    config.prior.train = config.text_encoder.train = False
    config.train_dtype = pt_enums.DataType.FLOAT_32
    return config


def test_key_maps_equal_the_reference_in_both_directions(hunyuan_dir):
    """The port's copies of the reference's four key-map pairs give the
    reference's state dicts and trees exactly, the patchify kernel 5-D on
    the torch side."""
    params = dict(zip(("transformer", "text_encoder", "text_encoder_2", "vae"),
                      hunyuan_dir["params"]))
    pairs = {
        "transformer": ((jax_io.hunyuan_flax_to_state_dict, pt_io.hunyuan_flax_to_state_dict),
                        (jax_io.hunyuan_state_dict_to_flax, pt_io.hunyuan_state_dict_to_flax)),
        "text_encoder": ((jax_io.llama_flax_to_state_dict, pt_io.llama_flax_to_state_dict),
                         (jax_io.llama_state_dict_to_flax, pt_io.llama_state_dict_to_flax)),
        "vae": ((jax_io.video_vae_flax_to_state_dict, pt_io.video_vae_flax_to_state_dict),
                (jax_io.video_vae_state_dict_to_flax, pt_io.video_vae_state_dict_to_flax)),
    }
    for name, ((ref_out, port_out), (ref_in, port_in)) in pairs.items():
        want, got = ref_out(params[name]), port_out(params[name])
        assert set(got) == set(want), name
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        back_want, back_got = jax_tf._flatten(ref_in(want)), jax_tf._flatten(port_in(want))
        assert set(back_got) == set(back_want) == set(jax_tf._flatten(params[name])), name
        for path, value in back_want.items():
            np.testing.assert_array_equal(back_got[path], value, err_msg=str(path))
    sd = pt_io.hunyuan_flax_to_state_dict(params["transformer"])
    assert sd["x_embedder.proj.weight"].shape == (48, 16, 1, 2, 2)
    # a LlamaForCausalLM file: the prefix goes, the head is not the encoder's
    llama = {"model." + k: v for k, v in jax_io.llama_flax_to_state_dict(
        params["text_encoder"]).items()}
    llama["lm_head.weight"] = np.zeros((130, 24), np.float32)
    assert set(pt_io.llama_state_dict(llama)) == set(
        jax_io.llama_flax_to_state_dict(params["text_encoder"]))


def _reference_state_dicts(path: str, dtype=np.float32) -> dict:
    import jax.numpy as jnp
    loaded = jax_io.load_hunyuan_diffusers(path, weight_dtype=dtype,
                                           compute_dtype=jnp.float32, device=False)
    return {name: _TO_STATE_DICT[name](jax.device_get(loaded[attr]))
            for name, attr in _PARAMS.items()}


def _port_state_dict(name: str, module) -> dict:
    sd = module.state_dict()
    return pt_io.hunyuan_diffusers_state_dict(sd) if name == "transformer" else sd


def test_load_and_save_match_the_reference_bitwise(hunyuan_dir, tmp_path):
    assert sorted(os.listdir(os.path.join(hunyuan_dir["base"], "text_encoder"))) == [
        "config.json", "model-00001-of-00002.safetensors",
        "model-00002-of-00002.safetensors", "model.safetensors.index.json"]
    family = get_family(HUNYUAN)
    model = family.load(hunyuan_dir["base"], _config(), device="cpu")
    assert model.transformer_config.remat_policy == "full"
    assert model.te2_config.projection_dim == 16
    assert model.vae_config.scaling_factor == 0.476986
    ref = _reference_state_dicts(hunyuan_dir["base"])
    for name, module in model.modules().items():
        got = _port_state_dict(name, module)
        assert set(got) == set(ref[name]), name
        for key, value in ref[name].items():
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)

    setup = family.create_setup(model, _config(), 1)
    assert setup.train_step is None
    out = str(tmp_path / "saved")
    family.save_model(setup, out, hunyuan_dir["base"], save_dtype=torch.float16)
    assert json.load(open(os.path.join(out, "transformer", "config.json"))) == json.load(
        open(os.path.join(hunyuan_dir["base"], "transformer", "config.json")))
    saved = _reference_state_dicts(out, np.float16)
    for name, module in model.modules().items():
        for key, value in _port_state_dict(name, module).items():
            np.testing.assert_array_equal(
                np.asarray(saved[name][key]), value.to(torch.float16).numpy(), err_msg=key)
    reloaded = family.load(out, _config(), device="cpu")
    for name, module in reloaded.modules().items():
        for key, value in module.state_dict().items():
            assert torch.equal(value, model.modules()[name].state_dict()[key].half().float()), key


def test_family_entry():
    family = get_family(HUNYUAN)
    assert (family.name, family.quantization, family.video) == ("hunyuan", 32, True)
    assert family.lora_prefixes == {"transformer_lora": "lora_transformer",
                                    "te_lora": "lora_te1"}
    assert not get_family(pt_enums.ModelType.FLUX_DEV_1).video


def test_single_file_and_output_embeddings_are_refused(hunyuan_dir, tmp_path):
    """The HunyuanVideo single file is ported (it was refused until the DiT
    fine-tune slice): the transformer under `model.model.` with the VAE,
    Llama and CLIP-L bundled round-trips bit for bit. Output embeddings,
    refused until the embedding slice, patch Llama's states past the
    template at the placeholder positions and leave the others as they
    are."""
    from onetrainer_tpu_torch.train.hunyuan_train_step import hunyuan_text_conditioning
    family = get_family(HUNYUAN)
    model = family.load(hunyuan_dir["base"], _config(), device="cpu")
    setup = family.create_setup(model, _config(), 1)
    single = str(tmp_path / "hv.safetensors")
    family.save_single_file(setup, single)
    assert any(k.startswith("model.model.double_blocks.0.img_attn.qkv")
               for k in load_safetensors(single))
    again = family.load(single, _config(), device="cpu")
    for name, module in model.modules().items():
        for key, value in module.state_dict().items():
            assert torch.equal(again.modules()[name].state_dict()[key], value), key
    from dataclasses import replace
    from onetrainer_tpu_torch.models.hunyuan_video import PROMPT_TEMPLATE_CROP_START
    tokens = setup.tokenizer("a cat")
    batch = {"tokens_1": torch.as_tensor(tokens[None]),
             "tokens_mask_1": torch.as_tensor(setup.tokenizer.mask(tokens)[None]),
             "tokens_2": torch.as_tensor(setup.tokenizer_2("a cat")[None])}
    base = model.te_config.vocab_size
    patched = dict(batch, tokens_1=batch["tokens_1"].clone(),
                   extra_embeddings=(torch.zeros(1, model.te_config.hidden_size),))
    patched["tokens_1"][0, PROMPT_TEMPLATE_CROP_START + 1] = base
    vector = torch.randn(1, model.te_config.hidden_size)
    cfg = replace(setup.step_cfg, train_text_encoder=True, output_embedding_base_id=base)
    with torch.no_grad():
        plain = hunyuan_text_conditioning(model, dict(patched), cfg)[0]
        states = hunyuan_text_conditioning(
            model, dict(patched, output_embeddings=vector), cfg)[0]
    assert torch.equal(states[0, 1], vector[0].to(states.dtype))
    keep = torch.ones(states.shape[1], dtype=torch.bool)
    keep[1] = False
    assert torch.equal(states[0, keep], plain[0, keep])


def _write_config(config, path) -> str:
    with open(path, "w") as f:
        json.dump(config.to_dict(), f)
    return path


@pytest.mark.parametrize("case", ["fine_tune_prior", "fine_tune_text_encoder", "embedding"])
def test_unported_training_is_refused(hunyuan_dir, tmp_path, case):
    """EMBEDDING (refused until the embedding slice) builds the Llama and
    CLIP-L vectors, and one step moves no part of the model. FINE_TUNE is
    ported (it was refused until the
    HunyuanVideo fine-tune slice): a config that trains the transformer
    (`prior`), or sets `text_encoder.train` beside it, builds the
    transformer's group alone, as the reference's (Llama and CLIP-L stay
    frozen and, with `text_encoder.train`, run in the step uncached); one
    step moves the transformer and no other part, and the train command
    passes its refusals and reaches the load."""
    match = None
    if case == "embedding":
        config = _config(pt_enums.TrainingMethod.EMBEDDING)
        config.learning_rate_warmup_steps = 0.0
    else:
        config = _config()
        config.prior.train = True
        config.text_encoder.train = case == "fine_tune_text_encoder"
        config.learning_rate_warmup_steps = 0.0
    family = get_family(HUNYUAN)
    model = family.load(hunyuan_dir["base"], _config(), device="cpu")
    if match:
        with pytest.raises(NotImplementedError, match=match):
            family.create_setup(model, config, 1)
    else:
        setup = family.create_setup(model, config, 1)
        assert set(setup.state.params) == ({"embeddings", "embeddings_2"} if case == "embedding"
                                           else {"transformer"})
        assert setup.step_cfg.train_text_encoder is (case != "fine_tune_prior")
        before = {name: {k: v.clone() for k, v in m.state_dict().items()}
                  for name, m in model.modules().items()}
        encode_images, encode_text = family.make_encode_fns(setup)
        images = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        batch = {k: torch.as_tensor(v) for k, v in encode_images(images).items()}
        texts = [encode_text(p) for p in ("a <embedding> cat", "a red dog")]
        batch.update({k: torch.as_tensor(np.stack([np.asarray(t[k]) for t in texts]))
                      for k in texts[0]})
        batch["loss_weight"] = torch.ones(2)
        assert ("text_encoder_1_hidden_state" in batch) is (case == "fine_tune_prior")
        setup.train_step(setup.state, batch, torch.Generator().manual_seed(0))
        for name, module in model.modules().items():
            changed = any(not torch.equal(v, before[name][k])
                          for k, v in module.state_dict().items())
            assert changed is (name == "transformer" and case != "embedding"), name
    config.base_model_name = str(tmp_path / "absent")
    config.workspace_dir = str(tmp_path / "ws")
    path = _write_config(config, str(tmp_path / "config.json"))
    with pytest.raises(NotImplementedError if match else FileNotFoundError, match=match):
        pt_train.main(["--config-path", path, "--device", "cpu"])


def _train_config(root, name, base, ds, epochs):
    config = tiny_train_config(base, ds, os.path.join(root, name, "ws"),
                               os.path.join(root, name, "cache"))
    config = PortTrainConfig.default_values().from_dict(config.to_dict())
    config.model_type = HUNYUAN
    config.frames = "9"
    config.train_dtype = pt_enums.DataType.FLOAT_32
    config.gradient_checkpointing = pt_enums.GradientCheckpointingMethod.OFF
    config.prior.train = True
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


def test_train_command_over_videos_and_images_resumes_to_the_uninterrupted_run(
        hunyuan_dir):
    root, base = hunyuan_dir["root"], hunyuan_dir["base"]
    ds = make_video_dataset(os.path.join(root, "ds"), n_videos=2, n_images=2, frames=9,
                            size=32)
    whole = _run(root, _train_config(root, "whole", base, ds, 2), "whole")
    assert whole.train_progress.global_step == 4
    lora = load_safetensors(whole.config.output_model_destination)
    assert any(k.startswith("lora_transformer_transformer_blocks_0_attn_to_q")
               and k.endswith("lora_down.weight") for k in lora)
    assert any(k.startswith("lora_transformer_context_embedder_token_refiner") for k in lora)
    cached = [load_safetensors(os.path.join(whole.config.cache_dir, f))
              for f in os.listdir(whole.config.cache_dir)]
    # 9 video frames -> 3 latent frames, an image -> 1; Llama's 77 text rows
    # past the template and their mask, CLIP's pooled output
    assert sorted(r["latent_image"].shape for r in cached) == \
        [(1, 4, 4, 16)] * 2 + [(3, 4, 4, 16)] * 2
    assert all(r["text_encoder_1_hidden_state"].shape == (77, 24)
               and r["tokens_mask_1"].shape == (77,)
               and r["text_encoder_2_pooled_state"].shape == (16,) for r in cached)

    first = _run(root, _train_config(root, "split", base, ds, 1), "split1")
    assert first.train_progress.global_step == 2
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


def test_sample_command_writes_a_non_constant_image(hunyuan_dir, tmp_path):
    dest = str(tmp_path / "hv.png")
    out = pt_sample.main(["--model-type", "HUNYUAN_VIDEO", "--base-model-name",
                          hunyuan_dir["base"], "--prompt", "a cat", "--destination", dest,
                          "--steps", "2", "--cfg", "6", "--width", "32", "--height", "32",
                          "--device", "cpu"])
    assert out.image.shape == (32, 32, 3) and out.image.std() > 0
    assert out.video.shape == (1, 32, 32, 3)
    assert os.path.getsize(dest) > 0


def test_f12_reference_saver_writes_no_vae_or_clip_weights(hunyuan_dir, tmp_path):
    """F12: the reference's `save_hunyuan_diffusers` writes the transformer
    and Llama and copies only the other components' non-weight files, so
    the directory it writes has no VAE or CLIP weights and loads without
    them; the port's saver writes every component."""
    params = dict(zip(("transformer", "text_encoder", "text_encoder_2", "vae"),
                      hunyuan_dir["params"]))
    ref_out = str(tmp_path / "reference")
    jax_io.save_hunyuan_diffusers(ref_out, None, params["transformer"],
                                  params["text_encoder"], source_dir=hunyuan_dir["base"])
    for name, has_weights in (("transformer", True), ("text_encoder", True),
                              ("vae", False), ("text_encoder_2", False)):
        files = os.listdir(os.path.join(ref_out, name))
        assert any(f.endswith(".safetensors") for f in files) is has_weights, name
    loaded = jax_io.load_hunyuan_diffusers(ref_out, device=False)
    assert loaded["vae_params"] is None and loaded["te2_params"] is None

    family = get_family(HUNYUAN)
    model = family.load(hunyuan_dir["base"], _config(), device="cpu")
    port_out = str(tmp_path / "port")
    family.save_model(family.create_setup(model, _config(), 1), port_out,
                      hunyuan_dir["base"])
    for name in ("transformer", "vae", "text_encoder", "text_encoder_2"):
        assert any(f.endswith(".safetensors")
                   for f in os.listdir(os.path.join(port_out, name))), name
