"""The torch port's DiT single files against the reference's
(onetrainer_tpu/io/single_file.py and the single-file savers of
onetrainer_tpu/setup/families.py): SD3's SAI layout, bundled (MMDiT, VAE,
CLIP-L, CLIP-G, T5) and bare (the MMDiT alone), FLUX.1-dev's and
FLUX.1-fill's BFL layout, and HunyuanVideo's original layout.

Both sides run the tiny models of tests/test_torch_port_{sd3,flux,
flux_fill,hunyuan}.py with the same seeded weights. A file the reference's
saver writes loads into the port bit for bit, every tensor the reference's
loader reads carried into the port's layout by the port's
io/torch_flax.py; a file the port's saver writes loads into the reference
bit for bit. The port's files carry more than the reference's (FLUX's and
HunyuanVideo's bundle the VAE and the text encoders) and the reference
reads the SAI VAE under a doubled prefix (ROADMAP F14), so the second
direction holds every part the reference reads. Then the families' load
and save round trip, a part the file lacks stays on "meta" and is left
out of the next save, and the sample command samples from a single file
of each family.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import single_file as jax_sf
from onetrainer_tpu.io.safetensors_io import save_safetensors as jax_save
from onetrainer_tpu.setup import families as jax_families
from onetrainer_tpu.util.enums import ModelType, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io import single_file as pt_sf
from onetrainer_tpu_torch.io import torch_flax as pt_tf
from onetrainer_tpu_torch.io.hunyuan_checkpoints import (
    hunyuan_flax_to_state_dict, hunyuan_transformer_state_dict,
)
from onetrainer_tpu_torch.io.hunyuan_checkpoints import llama_flax_to_state_dict
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
from onetrainer_tpu_torch.io.sd3_checkpoints import t5_state_dict
from onetrainer_tpu_torch.scripts import sample as pt_sample
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_flux import tiny_flux_pair
from tests.test_torch_port_flux_fill import tiny_fill_pair
from tests.test_torch_port_hunyuan import tiny_hunyuan_pair
from tests.test_torch_port_sd3 import tiny_sd3_pair

# the reference's loaders read tensors as flax trees in this dtype
JAX_LOAD = dict(compute_dtype=jnp.float32, device=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(model_type) -> TrainConfig:
    config = TrainConfig.default_values()
    config.model_type = model_type
    config.training_method = TrainingMethod.FINE_TUNE
    return config


def _port_config(model_type) -> PortTrainConfig:
    config = PortTrainConfig.default_values().from_dict(_config(model_type).to_dict())
    config.train_dtype = pt_enums.DataType.FLOAT_32
    config.prior.train = config.text_encoder.train = False
    config.text_encoder_2.train = config.unet.train = False
    return config


def _jax_setup(model_type, params: tuple, vae) -> SimpleNamespace:
    """What the reference's single-file savers read of a setup."""
    return SimpleNamespace(config=_config(model_type), model=SimpleNamespace(vae_params=vae),
                           merged_inference_params=lambda: (*params, None))


def _pair(case: str):
    """(the reference's model type, the port's model, {part: the reference's
    flax tree}, the reference's saver's setup)."""
    if case.startswith("sd3"):
        _, (tr, te, te2, te3, vae), port = tiny_sd3_pair()
        trees = {"transformer": tr, "text_encoder": te, "text_encoder_2": te2,
                 "text_encoder_3": te3, "vae": vae}
        return ModelType.STABLE_DIFFUSION_3, port, trees, _jax_setup(
            ModelType.STABLE_DIFFUSION_3, (tr, te, te2, te3), vae)
    if case in ("flux", "flux_fill"):
        _, (tr, te, te2, vae), port = tiny_fill_pair() if case == "flux_fill" \
            else tiny_flux_pair()
        mt = ModelType.FLUX_FILL_DEV_1 if case == "flux_fill" else ModelType.FLUX_DEV_1
        trees = {"transformer": tr, "text_encoder": te, "text_encoder_2": te2, "vae": vae}
        return mt, port, trees, _jax_setup(mt, (tr, te, te2), vae)
    _, (tr, te, te2, vae), port = tiny_hunyuan_pair()
    trees = {"transformer": tr, "text_encoder": te, "text_encoder_2": te2, "vae": vae}
    return ModelType.HUNYUAN_VIDEO, port, trees, _jax_setup(
        ModelType.HUNYUAN_VIDEO, (tr, te, te2), vae)


def _port_layout(name: str, tree: dict, family: str) -> dict:
    """A reference flax tree as the port's module names its tensors
    (io/torch_flax.py and the HunyuanVideo maps), numpy."""
    if name == "transformer":
        if family == "hunyuan":
            return hunyuan_transformer_state_dict(hunyuan_flax_to_state_dict(tree))
        return pt_tf.unet_flax_to_state_dict(tree)
    if name == "text_encoder" and family == "hunyuan":
        return llama_flax_to_state_dict(tree)
    if name == "vae":
        return pt_tf.vae_flax_to_state_dict(tree)
    if name == "text_encoder_3" or (name == "text_encoder_2" and family == "flux"):
        return pt_tf.t5_flax_to_state_dict(tree)
    return pt_tf.clip_flax_to_state_dict(tree)


def _assert_bitwise(got: dict, want: dict, what: str) -> None:
    want = {k: v for k, v in want.items() if k != "text_projection.weight"
            or k in got}
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for key, value in want.items():
        g = got[key]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(value, np.float32), err_msg=f"{what} {key}")


_FAMILY = {"sd3": "sd3", "sd3_bare": "sd3", "flux": "flux", "flux_fill": "flux",
           "hunyuan": "hunyuan"}
# the port's loader's state dict -> the reference's loader's flax tree
_JAX_PARAMS = {"transformer": "transformer_params", "vae": "vae_params",
               "text_encoder": "te_params", "text_encoder_2": "te2_params",
               "text_encoder_3": "te3_params"}
_PORT_LOAD = {"sd3": pt_sf.load_sd3_single_file, "flux": pt_sf.load_flux_single_file,
              "hunyuan": pt_sf.load_hunyuan_single_file}
_JAX_LOAD = {"sd3": jax_sf.load_sd3_single_file, "flux": jax_sf.load_flux_single_file,
             "hunyuan": jax_sf.load_hunyuan_single_file}


def _write_reference_file(case: str, path: str, setup) -> set:
    """The reference's saver's file of `case`; -> the parts it holds."""
    if case == "sd3_bare":
        sd = jax_sf.sd3_transformer_to_sai(pt_tf.unet_flax_to_state_dict(
            setup.merged_inference_params()[0]))
        jax_save(path, {f"model.diffusion_model.{k}": np.asarray(v) for k, v in sd.items()})
        return {"transformer"}
    save = {"sd3": jax_families._sd3_save_single_file,
            "flux": jax_families._flux_save_single_file,
            "hunyuan": jax_families._hunyuan_save_single_file}[_FAMILY[case]]
    save(setup, path)
    return {"transformer", "vae", "text_encoder", "text_encoder_2", "text_encoder_3"} \
        if case == "sd3" else {"transformer"}


@pytest.mark.parametrize("case", list(_FAMILY))
def test_reference_file_loads_into_the_port_bitwise(tmp_path, capsys, case):
    _, port, trees, setup = _pair(case)
    family = _FAMILY[case]
    path = str(tmp_path / "ref.safetensors")
    parts = _write_reference_file(case, path, setup)
    loaded = _PORT_LOAD[family](path, device="cpu")
    for name in trees:
        if name in parts:
            _assert_bitwise(loaded[name], _port_layout(name, trees[name], family), name)
        else:
            assert loaded[name] is None, name
    printed = capsys.readouterr().out
    assert ("not in single-file checkpoint, continuing without it" in printed) is \
        (parts != set(trees))
    # the transformer's widths and depth from its shapes (FLUX.1-fill's
    # wider x_embedder among them)
    cfg, want = loaded["transformer_config"], port.transformer_config
    fields = ("in_channels", "out_channels", "num_layers", "hidden_size",
              "joint_attention_dim" if family != "hunyuan" else "text_embed_dim",
              "pooled_projection_dim")
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert (cfg.in_channels > cfg.out_channels) is (case == "flux_fill")


@pytest.mark.parametrize("case", list(_FAMILY))
def test_port_file_loads_into_the_reference_bitwise(tmp_path, case):
    mt, port, trees, _ = _pair(case)
    family = _FAMILY[case]
    path = str(tmp_path / "port.safetensors")
    sds = {name: {k: v.detach() for k, v in m.state_dict().items()}
           for name, m in port.modules().items()}
    save = {"sd3": pt_sf.save_sd3_single_file, "flux": pt_sf.save_flux_single_file,
            "hunyuan": pt_sf.save_hunyuan_single_file}[family]
    if case == "sd3_bare":
        pt_sf.save_sd3_single_file(path, sds["transformer"], None, None, None, None)
    elif family == "sd3":
        save(path, sds["transformer"], sds["vae"], sds["text_encoder"],
             sds["text_encoder_2"], t5_state_dict(sds["text_encoder_3"]))
    else:
        save(path, sds["transformer"], sds["vae"], sds["text_encoder"],
             sds["text_encoder_2"])
    loaded = _JAX_LOAD[family](path, **JAX_LOAD)
    # the reference reads the text encoders bundled in SAI's layout (FLUX's
    # and SD3's), and no VAE (F14); HunyuanVideo's transformer alone
    reads = {"transformer"}
    if family != "hunyuan" and case != "sd3_bare":
        reads |= {"text_encoder", "text_encoder_2", "text_encoder_3"} & set(trees)
    for name in trees:
        tree = loaded[_JAX_PARAMS[name]]
        if name not in reads:
            assert not tree, name
            continue
        _assert_bitwise(_port_layout(name, tree, family),
                        {k: v.numpy() for k, v in sds[name].items()}, name)
    # and back into the port, every part
    again = _PORT_LOAD[family](path, device="cpu")
    for name, sd in sds.items():
        if case == "sd3_bare" and name != "transformer":
            assert again[name] is None
            continue
        _assert_bitwise(again[name], {k: v.numpy() for k, v in sd.items()
                                      if name != "text_encoder_3" or
                                      k != "encoder.embed_tokens.weight"}, name)


def test_f14_reference_reads_no_vae_from_an_sai_file(tmp_path):
    """F14 (open in the JAX package; the port writes SAI's layout): the
    reference's SD3 saver writes the VAE under a doubled prefix and its
    loader strips one prefix before a map that expects it, so the VAE of
    an SAI file (`first_stage_model.encoder...`) loads as no tensors."""
    _, port, _, setup = _pair("sd3")
    path = str(tmp_path / "ref.safetensors")
    jax_families._sd3_save_single_file(setup, path)
    keys = [k for k in load_safetensors(path) if "first_stage_model" in k]
    assert keys and all(k.startswith("first_stage_model.first_stage_model.") for k in keys)
    sai = str(tmp_path / "sai.safetensors")
    sds = {n: m.state_dict() for n, m in port.modules().items()}
    pt_sf.save_sd3_single_file(sai, sds["transformer"], sds["vae"], None, None, None)
    written = [k for k in load_safetensors(sai) if k.startswith("first_stage_model.")]
    assert written and not any(k.startswith("first_stage_model.first_stage_model.")
                               for k in written)
    assert jax_sf.load_sd3_single_file(sai, **JAX_LOAD)["vae_params"] == {}
    assert pt_sf.load_sd3_single_file(sai, device="cpu")["vae"] is not None


_PORT_TYPES = {"sd3": pt_enums.ModelType.STABLE_DIFFUSION_3,
               "flux": pt_enums.ModelType.FLUX_DEV_1,
               "flux_fill": pt_enums.ModelType.FLUX_FILL_DEV_1,
               "hunyuan": pt_enums.ModelType.HUNYUAN_VIDEO}


@pytest.mark.parametrize("case", list(_PORT_TYPES))
def test_family_round_trip_and_the_sample_command(tmp_path, capsys, case):
    """The family's save_single_file, its load (every part bitwise, in the
    train dtype's weights), a file without the text encoders (their parts
    stay on "meta" and the next save leaves them out), and the sample
    command on the saved file."""
    _, port, _, _ = _pair(case)
    mt = _PORT_TYPES[case]
    family = get_family(mt)
    config = _port_config(mt)
    setup = family.create_setup(port, config, 1)
    assert setup.train_step is None
    path = str(tmp_path / "model.safetensors")
    family.save_single_file(setup, path)
    model = family.load(path, config, device="cpu")
    for name, module in port.modules().items():
        got = model.modules()[name].state_dict()
        want = module.state_dict()
        assert set(want) <= set(got), name
        for key, value in want.items():
            assert torch.equal(got[key], value), f"{name} {key}"
    # a file of the transformer and the VAE alone
    bare = str(tmp_path / "bare.safetensors")
    sd = {n: m.state_dict() for n, m in port.modules().items()}
    if case == "sd3":
        pt_sf.save_sd3_single_file(bare, sd["transformer"], sd["vae"], None, None, None)
    elif case == "hunyuan":
        pt_sf.save_hunyuan_single_file(bare, sd["transformer"], sd["vae"], None, None)
    else:
        pt_sf.save_flux_single_file(bare, sd["transformer"], sd["vae"], None, None)
    capsys.readouterr()
    partial = family.load(bare, config, device="cpu")
    assert "not in single-file checkpoint, continuing without it" in capsys.readouterr().out
    assert next(partial.text_encoder.parameters()).is_meta
    assert not next(partial.transformer.parameters()).is_meta
    resaved = str(tmp_path / "resaved.safetensors")
    family.save_single_file(family.create_setup(partial, config, 1), resaved)
    assert not any(k.startswith("text_encoders.") for k in load_safetensors(resaved))
    # the sample command on the full file
    dest = str(tmp_path / "out.png")
    args = ["--model-type", mt.name, "--base-model-name", path, "--prompt", "a cat",
            "--destination", dest, "--steps", "2", "--width", "32", "--height", "32",
            "--device", "cpu"]
    if case == "flux_fill":
        return   # fill samples from a base image and mask (test_torch_port_flux_fill.py)
    out = pt_sample.main(args)
    image = out.image if out.image.ndim == 3 else out.image[0]
    assert image.dtype == np.uint8 and image.std() > 0
    assert os.path.getsize(dest) > 0
