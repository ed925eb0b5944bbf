"""Parity of the torch port's checkpoint I/O with the reference
(onetrainer_tpu/io/{safetensors_io,sd_checkpoints}.py and the load/save
entries of setup/families.py).

- The port's safetensors reader reads files the reference's writer wrote
  (fp32, fp16, bf16, fp8, integers, bool, metadata) bit for bit, and its
  writer writes the reference's bytes for the same tensors.
- Tiny SD 1.5-shaped, SD 2.x-shaped and SDXL checkpoints, each as a
  diffusers directory (as tests/test_trainer.py:write_tiny_checkpoint
  writes one, config.json files included) and as an LDM single file from
  the reference's own `save_sd_single_file` / `save_sdxl_single_file`,
  load through both packages' `family.load`: every tensor bitwise equal,
  and the UNet, VAE encoder and text encoders give the same outputs
  within rel L2 1e-5 (fp32). A single file carries no configs: both
  loaders take the model type's published ones, which the tests swap for
  the tiny configs on both sides (monkeypatched `create_sd_model` /
  `create_sdxl_model`).
- Checkpoints the port saves (diffusers and single file, LoRA merged in)
  load into the reference bitwise equal to the port's own tensors, and
  its kohya LoRA file reads back in both packages to the port's adapters.

Torch runs one thread; the reference's jitted applies are built once per
configuration.
"""

import json
import os
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import safetensors_io as jax_st
from onetrainer_tpu.io import sd_checkpoints as jax_ckpt
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.models import sd as jax_sd
from onetrainer_tpu.models import sdxl as jax_sdxl
from onetrainer_tpu.models.clip import CLIPTextConfig
from onetrainer_tpu.models.unet import UNetConfig
from onetrainer_tpu.models.vae import VAEConfig
from onetrainer_tpu.peft.lora import kohya_state_dict_to_peft as jax_kohya_to_peft
from onetrainer_tpu.setup import families as jax_families
from onetrainer_tpu.util.enums import (
    DataType, GradientCheckpointingMethod, ModelType, TrainingMethod,
)
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io import safetensors_io as pt_st
from onetrainer_tpu_torch.models import clip as pt_clip
from onetrainer_tpu_torch.models import sd as pt_sd
from onetrainer_tpu_torch.models import sdxl as pt_sdxl
from onetrainer_tpu_torch.models import unet as pt_unet
from onetrainer_tpu_torch.models import vae as pt_vae
from onetrainer_tpu_torch.peft.lora import (
    kohya_state_dict_to_peft, peft_module_keys, peft_to_kohya_state_dict,
)
from onetrainer_tpu_torch.setup import families as pt_families
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_models import _random_like

REL_L2 = 1e-5

_TE = dict(vocab_size=100, intermediate_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=16, eos_token_id=99, dtype=jnp.float32)
_VAE = VAEConfig(block_out_channels=(32, 64), layers_per_block=1, dtype=jnp.float32)
# shape -> (model type, unet config, te configs, scheduler prediction type)
SHAPES = {
    "sd15": (ModelType.STABLE_DIFFUSION_15,
             UNetConfig(block_out_channels=(32, 64), cross_attn_blocks=(True, False),
                        layers_per_block=1, num_heads=(4, 4), cross_attention_dim=32,
                        use_linear_projection=False, dtype=jnp.float32),
             (CLIPTextConfig(hidden_size=32, hidden_act="quick_gelu", **_TE),),
             "epsilon"),
    "sd2": (ModelType.STABLE_DIFFUSION_21,
            UNetConfig(block_out_channels=(32, 64), cross_attn_blocks=(True, False),
                       layers_per_block=1, num_heads=(4, 4), cross_attention_dim=32,
                       use_linear_projection=True, dtype=jnp.float32),
            (CLIPTextConfig(hidden_size=32, hidden_act="gelu", **_TE),),
            "v_prediction"),
    "sdxl": (ModelType.STABLE_DIFFUSION_XL_10_BASE,
             UNetConfig(block_out_channels=(32, 64), cross_attn_blocks=(False, True),
                        layers_per_block=1, transformer_layers_per_block=(1, 2),
                        num_heads=(4, 4), cross_attention_dim=32 + 48,
                        use_linear_projection=True, addition_embed_dim=8,
                        addition_pooled_dim=1280, dtype=jnp.float32),
             (CLIPTextConfig(hidden_size=32, hidden_act="quick_gelu", **_TE),
              CLIPTextConfig(hidden_size=48, hidden_act="gelu", projection_dim=1280, **_TE)),
             "epsilon"),
}
CASES = [(shape, layout) for shape in SHAPES for layout in ("diffusers", "single")]
CASE_IDS = [f"{s}-{layout}" for s, layout in CASES]


def _port_cfg(cls, ref_cfg, dtype=torch.float32):
    return cls(**{f.name: getattr(ref_cfg, f.name) for f in fields(cls) if f.name != "dtype"},
               dtype=dtype)


def _te_names(shape):
    return ("text_encoder", "text_encoder_2")[:len(SHAPES[shape][2])]


def _jax_model(shape, dtype=jnp.float32, gradient_checkpointing=False, **_):
    model_type, unet, tes, _ = SHAPES[shape]
    unet = replace(unet, dtype=dtype, gradient_checkpointing=gradient_checkpointing)
    vae, tes = replace(_VAE, dtype=dtype), [replace(t, dtype=dtype) for t in tes]
    if shape == "sdxl":
        return jax_sdxl.StableDiffusionXLModel(
            model_type=model_type, unet_config=unet, vae_config=vae,
            te_config=tes[0], te2_config=tes[1])
    return jax_sd.StableDiffusionModel(model_type=model_type, unet_config=unet,
                                       vae_config=vae, te_config=tes[0])


def _port_model(shape, dtype=torch.float32, gradient_checkpointing=False, device="meta",
                **_):
    ref = _jax_model(shape)
    kw = dict(model_type=pt_enums.ModelType(ref.model_type.value),
              unet_config=replace(_port_cfg(pt_unet.UNetConfig, ref.unet_config, dtype),
                                  gradient_checkpointing=gradient_checkpointing,
                                  remat_policy="tx_only"),
              vae_config=_port_cfg(pt_vae.VAEConfig, ref.vae_config, dtype),
              te_config=_port_cfg(pt_clip.CLIPTextConfig, ref.te_config, dtype),
              device=device)
    if shape == "sdxl":
        return pt_sdxl.StableDiffusionXLModel(
            te2_config=_port_cfg(pt_clip.CLIPTextConfig, ref.te2_config, dtype), **kw)
    return pt_sd.StableDiffusionModel(**kw)


def _diffusers_configs(shape) -> dict:
    """config.json contents that the loaders read back as the tiny configs."""
    _, unet, tes, _ = SHAPES[shape]
    out = {"unet": {
        "in_channels": 4, "out_channels": 4,
        "block_out_channels": list(unet.block_out_channels),
        "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D"
                             for a in unet.cross_attn_blocks],
        "layers_per_block": unet.layers_per_block,
        "attention_head_dim": list(unet.num_heads),
        "transformer_layers_per_block": list(unet.transformer_layers_per_block),
        "cross_attention_dim": unet.cross_attention_dim,
        "use_linear_projection": unet.use_linear_projection,
        **({"addition_time_embed_dim": unet.addition_embed_dim}
           if unet.addition_embed_dim else {}),
    }, "vae": {
        "in_channels": 3, "out_channels": 3, "latent_channels": 4,
        "block_out_channels": list(_VAE.block_out_channels),
        "layers_per_block": _VAE.layers_per_block, "scaling_factor": 0.18215,
    }}
    for name, te in zip(_te_names(shape), tes):
        out[name] = {
            "vocab_size": te.vocab_size, "hidden_size": te.hidden_size,
            "intermediate_size": te.intermediate_size,
            "num_hidden_layers": te.num_layers, "num_attention_heads": te.num_heads,
            "max_position_embeddings": te.max_position_embeddings,
            "hidden_act": te.hidden_act, "eos_token_id": te.eos_token_id,
            **({"architectures": ["CLIPTextModelWithProjection"],
                "projection_dim": te.projection_dim} if te.projection_dim else {}),
        }
    return out


def _write_checkpoints(root, shape, seed):
    """(diffusers dir, single file, {module: torch-keyed numpy state dict})."""
    port = _port_model(shape, device="cpu")
    rng = np.random.default_rng(seed)
    sds = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
           for name, m in port.modules().items()}
    base = os.path.join(root, f"{shape}_diffusers")
    configs = _diffusers_configs(shape)
    for name, sd in sds.items():
        d = os.path.join(base, name)
        os.makedirs(d)
        fname = "model.safetensors" if name.startswith("text_encoder") \
            else "diffusion_pytorch_model.safetensors"
        jax_st.save_safetensors(os.path.join(d, fname), sd)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(configs[name], f)
    os.makedirs(os.path.join(base, "scheduler"))
    with open(os.path.join(base, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"prediction_type": SHAPES[shape][3]}, f)

    single = os.path.join(root, f"{shape}.safetensors")
    flax = {"unet": jax_tf.unet_state_dict_to_flax(sds["unet"]),
            "vae": jax_tf.vae_state_dict_to_flax(sds["vae"])}
    for name in _te_names(shape):
        flax[name] = jax_tf.clip_state_dict_to_flax(sds[name])
    model = _jax_model(shape)
    if shape == "sdxl":
        jax_ckpt.save_sdxl_single_file(single, model, flax["unet"], flax["vae"],
                                       flax["text_encoder"], flax["text_encoder_2"])
    else:
        jax_ckpt.save_sd_single_file(single, model, flax["unet"], flax["vae"],
                                     flax["text_encoder"])
    return base, single, sds


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("ckpts"))
    return {shape: _write_checkpoints(root, shape, seed)
            for seed, shape in enumerate(SHAPES)}


@pytest.fixture
def tiny_templates(monkeypatch):
    """The published-config templates of the single-file loaders, on both
    sides, swapped for the tiny configs."""
    shape_of = {SHAPES[s][0].value: s for s in SHAPES}
    monkeypatch.setattr(jax_sd, "create_sd_model",
                        lambda mt, **kw: _jax_model(shape_of[mt.value], **kw))
    monkeypatch.setattr(jax_sdxl, "create_sdxl_model",
                        lambda mt, **kw: _jax_model(shape_of[mt.value], **kw))
    monkeypatch.setattr(pt_sd, "create_sd_model",
                        lambda mt, **kw: _port_model(shape_of[mt.value], **kw))
    monkeypatch.setattr(pt_sdxl, "create_sdxl_model",
                        lambda mt, **kw: _port_model(shape_of[mt.value], **kw))


def _configs(shape, method=TrainingMethod.FINE_TUNE):
    config = TrainConfig.default_values()
    config.model_type = SHAPES[shape][0]
    config.training_method = method
    config.train_dtype = DataType.FLOAT_32
    config.gradient_checkpointing = GradientCheckpointingMethod.OFF
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _jax_state_dicts(model, shape) -> dict:
    out = {"unet": jax_tf.unet_flax_to_state_dict(jax.device_get(model.unet_params)),
           "vae": jax_tf.vae_flax_to_state_dict(jax.device_get(model.vae_params))}
    out["text_encoder"] = jax_tf.clip_flax_to_state_dict(jax.device_get(model.te_params))
    if shape == "sdxl":
        out["text_encoder_2"] = jax_tf.clip_flax_to_state_dict(
            jax.device_get(model.te2_params))
    return out


def _assert_bitwise(port_sd: dict, ref_sd: dict, what: str):
    """Every tensor of the port's state dict equals the reference's bit for
    bit; the reference may carry the unprojected text encoder's projection
    the port's module has no place for."""
    assert set(port_sd) <= set(ref_sd), (what, sorted(set(port_sd) - set(ref_sd))[:5])
    assert set(ref_sd) - set(port_sd) <= {"text_projection.weight"}, what
    for key, value in port_sd.items():
        ref = np.asarray(ref_sd[key])
        got = value.detach().cpu().numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, (what, key)
        assert np.array_equal(got, ref), (what, key)


def _rel_l2(port, ref) -> float:
    port, ref = port.detach().numpy(), np.asarray(ref)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


_JITTED: dict = {}


def _jitted(module, method=None):
    """One jitted apply per flax module configuration."""
    key = (module, method)
    if key not in _JITTED:
        fn = module.apply if method is None else (
            lambda p, *a: module.apply(p, *a, method=getattr(module, method)))
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


def _assert_outputs_match(jax_model, port, shape):
    rng = np.random.default_rng(11)
    _, unet, _, _ = SHAPES[shape]
    args = [rng.standard_normal((2, 16, 16, 4), dtype=np.float32),
            np.asarray([3, 700], np.int32),
            rng.standard_normal((2, 8, unet.cross_attention_dim), dtype=np.float32)]
    if shape == "sdxl":
        args += [rng.standard_normal((2, 1280), dtype=np.float32),
                 np.asarray([[32, 32, 0, 0, 32, 32]] * 2, np.float32)]
    ref = _jitted(jax_model.unet)({"params": jax_model.unet_params}, *map(jnp.asarray, args))
    pixels = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    ref_mean, ref_logvar = _jitted(jax_model.vae, "encode")(
        {"params": jax_model.vae_params}, jnp.asarray(pixels))
    tokens = np.asarray([[98, 5, 7, 11, 99] + [99] * 11, [98, 3, 99] + [99] * 13], np.int32)
    with torch.no_grad():
        out = port.unet(*map(torch.from_numpy, args))
        mean, logvar = port.vae.encode(torch.from_numpy(pixels))
        assert _rel_l2(out, ref) <= REL_L2
        assert _rel_l2(mean, ref_mean) <= REL_L2 and _rel_l2(logvar, ref_logvar) <= REL_L2
        for name, params in zip(_te_names(shape), ("te_params", "te2_params")):
            ref_te = _jitted(getattr(jax_model, name))(
                {"params": getattr(jax_model, params)}, jnp.asarray(tokens))
            got = getattr(port, name)(torch.from_numpy(tokens))
            assert _rel_l2(got["last_hidden_state"], ref_te["last_hidden_state"]) <= REL_L2
            assert _rel_l2(got["pooled_output"], ref_te["pooled_output"]) <= REL_L2


# -- safetensors ----------------------------------------------------------------

def _reference_tensors():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "f32": f32,
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "bf16": f32.astype(ml_dtypes.bfloat16),
        "f8": rng.standard_normal((2, 3)).astype(ml_dtypes.float8_e4m3fn),
        "f64": rng.standard_normal((2,)),
        "i64": np.arange(5, dtype=np.int64) - 2,
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "u8": np.arange(9, dtype=np.uint8),
        "bool": np.asarray([True, False, True]),
        "scalar": np.asarray(16.0, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


def _as_port(value: np.ndarray) -> torch.Tensor:
    """The same tensor in torch, bf16 and fp8 through their bit patterns."""
    views = {"bfloat16": (np.int16, torch.bfloat16),
             "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
    if value.dtype.name in views:
        view, dtype = views[value.dtype.name]
        return torch.from_numpy(value.view(view).copy()).view(dtype)
    return torch.from_numpy(value.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.uint8).numpy()
    return t.numpy()


def test_safetensors_reader_reads_the_reference_files(tmp_path):
    tensors = _reference_tensors()
    path = str(tmp_path / "ref.safetensors")
    jax_st.save_safetensors(path, tensors, {"modelspec.title": "t", "n": 3})
    got = pt_st.load_safetensors(path)
    assert list(got) == list(tensors)
    for key, value in tensors.items():
        want = _bits(_as_port(value))
        assert got[key].dtype == _as_port(value).dtype, key
        # the reference's writer stores a 0-dim array with shape [1]
        assert got[key].shape == (value.shape or (1,)), key
        assert np.array_equal(_bits(got[key]).reshape(value.shape), want), key
    assert pt_st.load_metadata(path) == {"modelspec.title": "t", "n": "3"}
    with pt_st.SafetensorsFile(path) as f:
        assert f.shape("i32") == (2, 3) and f.dtype("bf16") == torch.bfloat16
        half = f.tensor("f32", dtype=torch.float16)
    assert np.array_equal(half.numpy(), tensors["f32"].astype(np.float16))


def test_safetensors_writer_writes_the_reference_bytes(tmp_path):
    tensors = _reference_tensors()
    meta = {"format": "pt", "modelspec.title": "t"}
    ref_path, port_path = str(tmp_path / "ref.safetensors"), str(tmp_path / "port.safetensors")
    jax_st.save_safetensors(ref_path, tensors, meta)
    pt_st.save_safetensors(port_path, {k: _as_port(v) for k, v in tensors.items()}, meta)
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    # numpy input writes the same bytes too, and the reference reads it back
    pt_st.save_safetensors(port_path, {k: v for k, v in tensors.items()
                                       if k not in ("bf16", "f8")})
    back = jax_st.load_safetensors(port_path)
    for key, value in back.items():
        assert np.array_equal(value.reshape(tensors[key].shape), tensors[key]), key


# -- family.load --------------------------------------------------------------------

@pytest.mark.parametrize("shape,layout", CASES, ids=CASE_IDS)
def test_family_load_matches_the_reference(checkpoints, tiny_templates, shape, layout):
    base, single, sds = checkpoints[shape]
    path = base if layout == "diffusers" else single
    config, port_config = _configs(shape)
    ref = jax_families.get_family(config.model_type).load(path, config)
    port = pt_families.get_family(port_config.model_type).load(path, port_config,
                                                               device="cpu")
    assert port.prediction_type == ref.prediction_type == (
        SHAPES[shape][3] if layout == "diffusers" or shape == "sd2" else "epsilon")
    assert port.text_encoder_layer_skip == ref.text_encoder_layer_skip
    ref_sds = _jax_state_dicts(ref, shape)
    for name, module in port.modules().items():
        assert all(p.device.type == "cpu" and p.dtype == torch.float32
                   for p in module.parameters()), name
        _assert_bitwise(module.state_dict(), ref_sds[name], f"{shape}/{layout}/{name}")
        # and the file's own tensors, for the diffusers layout
        if layout == "diffusers":
            _assert_bitwise(module.state_dict(), sds[name], f"{shape}/file/{name}")
    _assert_outputs_match(ref, port, shape)


def test_family_load_defaults_to_the_card_and_casts_to_the_weight_dtype(checkpoints):
    import inspect
    for family in (pt_families.get_family(pt_enums.ModelType.STABLE_DIFFUSION_15),
                   pt_families.get_family(pt_enums.ModelType.STABLE_DIFFUSION_XL_10_BASE)):
        assert inspect.signature(family.load).parameters["device"].default == "cuda"
    base, _, _ = checkpoints["sd15"]
    _, port_config = _configs("sd15")
    port_config.weight_dtype = pt_enums.DataType.BFLOAT_16
    model = pt_families.get_family(port_config.model_type).load(base, port_config, "cpu")
    assert {p.dtype for m in model.modules().values() for p in m.parameters()} \
        == {torch.bfloat16}
    assert model.unet_config.dtype == torch.float32   # the train dtype


# -- saving -------------------------------------------------------------------------

def _lora_setup(shape, path):
    """The port's model from `path` with LoRA on the UNet and the text
    encoder(s), every adapter given random non-zero weights."""
    _, port_config = _configs(shape, TrainingMethod.LORA)
    port_config.lora_rank, port_config.lora_alpha = 4, 8.0
    family = pt_families.get_family(port_config.model_type)
    model = family.load(path, port_config, device="cpu")
    setup = family.create_setup(model, port_config, 10)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for tree in setup.state.params.values():
            for entry in tree.values():
                entry["lora_up"].normal_(0.0, 0.1, generator=gen)
    return family, setup


@pytest.mark.parametrize("shape", list(SHAPES))
def test_saved_checkpoints_load_into_the_reference_bitwise(
        checkpoints, tiny_templates, tmp_path, shape):
    base, _, _ = checkpoints[shape]
    family, setup = _lora_setup(shape, base)
    assert set(setup.state.params) == {"unet_lora", "te_lora"} | (
        {"te2_lora"} if shape == "sdxl" else set())
    merged = pt_families.merged_state_dicts(setup)
    # the merged UNet differs from the base: the adapters are in it
    base_unet = pt_st.load_safetensors(
        os.path.join(base, "unet", "diffusion_pytorch_model.safetensors"))
    assert any(not torch.equal(merged["unet"][k], base_unet[k]) for k in base_unet)

    out_dir, out_file = str(tmp_path / "saved"), str(tmp_path / "saved.safetensors")
    family.save_model(setup, out_dir, base)
    family.save_single_file(setup, out_file)
    load_dir = jax_ckpt.load_sdxl_diffusers if shape == "sdxl" else jax_ckpt.load_sd_diffusers
    load_file = jax_ckpt.load_sdxl_single_file if shape == "sdxl" \
        else jax_ckpt.load_sd_single_file
    params = ("unet_params", "vae_params", "te_params", "te2_params")
    for loaded in (load_dir(out_dir, weight_dtype=np.float32, device=False),
                   load_file(out_file, SHAPES[shape][0], weight_dtype=np.float32,
                             device=False)):
        ref_model = _jax_model(shape)
        for attr in params[:3 + (shape == "sdxl")]:
            setattr(ref_model, attr, loaded[attr])
        ref_sds = _jax_state_dicts(ref_model, shape)
        for name, sd in merged.items():
            _assert_bitwise(sd, ref_sds[name], f"{shape}/saved/{name}")
    meta = jax_st.load_metadata(out_file)
    assert meta["format"] == "pt" and "modelspec.architecture" in meta


@pytest.mark.parametrize("shape", ["sd15", "sdxl"])
def test_lora_file_reads_back_in_both_packages(checkpoints, tmp_path, shape):
    base, _, _ = checkpoints[shape]
    family, setup = _lora_setup(shape, base)
    path = pt_families.save_lora_output(setup, str(tmp_path / "lora"),
                                        family.lora_prefixes)
    assert path.endswith(".safetensors")
    ref = jax_st.load_safetensors(path)
    want = {}
    for group, prefix in family.lora_prefixes.items():
        want.update(peft_to_kohya_state_dict(setup.state.params[group], setup.peft_cfg,
                                             prefix))
    assert set(ref) == set(want)
    for key, value in want.items():   # alpha: 0-dim, stored as [1]
        assert np.array_equal(ref[key].reshape(value.shape), value.numpy()), key
    assert any(k.startswith("lora_te_text_model_encoder_layers_")
               or k.startswith("lora_te1_text_model_encoder_layers_") for k in ref)
    meta = jax_st.load_metadata(path)
    assert meta["modelspec.architecture"].endswith("/lora")
    port_file = pt_st.load_safetensors(path)
    from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map
    modules = setup.model.modules()
    for group, prefix in family.lora_prefixes.items():
        name = {"unet_lora": "unet", "te_lora": "text_encoder",
                "te2_lora": "text_encoder_2"}[group]
        keys = peft_module_keys(modules[name], setup.peft_cfg,
                                None if name == "unet" else clip_torch_key_map)
        adapters = setup.state.params[group]
        for read, alpha in (kohya_state_dict_to_peft(port_file, prefix, keys),
                            jax_kohya_to_peft(ref, prefix, keys)):
            assert alpha == setup.peft_cfg.alpha and set(read) == set(adapters)
            for key, entry in adapters.items():
                for leaf, t in entry.items():
                    assert np.array_equal(np.asarray(read[key][leaf]), t.detach().numpy())
