"""Parity of the torch port's inpainting slice with the reference: the
bilinear resize that replaces Pillow's on the card (F13), the sampling
inputs (onetrainer_tpu/sampling/inpaint.py), the data loader's
conditioning images, FLUX.1-fill mask channels and mask removal
(onetrainer_tpu/data/loader.py), the 9-channel UNets of SD 1.5/2.0
inpainting and SDXL inpainting, two LoRA steps of SD 1.5 inpainting on a
batch from each side's loader, the SD and SDXL inpainting samplers, and
the port's sample command with `--sample-inpainting`.

Tolerances:
- `resize_bilinear` bitwise equal to Pillow 12's Image.resize(BILINEAR) on
  uint8 "L" and "RGB" images, up and down, odd sizes included;
  `resize_crop` the reference's bit for bit with Pillow blocked;
- `erode_mask`, `downsample_mask`, `flux_fill_mask_channels` and
  `load_inpainting_inputs` exactly;
- the loader's rows bitwise (the numpy encoders of
  tests/test_torch_port_data.py make the latents exact as well);
- UNet forwards 1e-4 absolute plus 1e-4 relative, as
  tests/test_torch_port_models.py;
- two LoRA steps: the loss and grad norm 1e-4 relative, each group's
  adapters 1e-4 relative L2, the cached latents 1e-4 absolute, as
  tests/test_torch_port_train_sd.py;
- the samplers' final latents 1e-4 absolute (as
  tests/test_torch_port_flux_sample.py), the uint8 image within 2 levels.

The tokenizers' no-file fallback hashes words with Python's salted `hash`;
here both sides take crc32 word ids instead, so every process feeds the
same ids. Torch runs one thread.
"""

import dataclasses
import json
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from onetrainer_tpu.config.concept_config import ConceptConfig
from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.data import loader as jax_loader
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.models.clip import CLIPTextConfig
from onetrainer_tpu.models.sd import StableDiffusionModel as JaxSDModel
from onetrainer_tpu.models.unet import UNet2DCondition as JaxUNet
from onetrainer_tpu.models.unet import UNetConfig
from onetrainer_tpu.models.vae import VAEConfig
from onetrainer_tpu.sampling import inpaint as jax_inpaint
from onetrainer_tpu.sampling import schedulers as jax_sched
from onetrainer_tpu.sampling.sd_sampler import sample_stable_diffusion
from onetrainer_tpu.sampling.sdxl_sampler import sample_stable_diffusion_xl
from onetrainer_tpu.setup import sd_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import SDTokenizer
from onetrainer_tpu.util.enums import ModelType, NoiseScheduler, TrainingMethod
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.data import loader as pt_loader
from onetrainer_tpu_torch.io.weights import (
    lora_params_from_jax, sd_params_from_flax, sdxl_params_from_flax,
)
from onetrainer_tpu_torch.models import clip as pt_clip
from onetrainer_tpu_torch.models import sd as pt_sd
from onetrainer_tpu_torch.models import unet as pt_unet
from onetrainer_tpu_torch.models import vae as pt_vae
from onetrainer_tpu_torch.models.sd import StableDiffusionModel
from onetrainer_tpu_torch.sampling import inpaint as pt_inpaint
from onetrainer_tpu_torch.sampling import schedulers as pt_sched
from onetrainer_tpu_torch.sampling import sd_sampler as pt_sampler
from onetrainer_tpu_torch.sampling import sdxl_sampler as pt_sdxl_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_sdxl import tiny_sdxl_model
from tests.test_torch_port_data import _encoders
from tests.test_torch_port_models import _port_config, _random_like, port_model_like
from tests.test_torch_port_sdxl_sample import IMAGE_LEVELS, _record_steps
from tests.test_torch_port_train_sdxl import (
    CACHE_ATOL, PROMPTS, SEED, STEPS, _assert_matches_reference, _jax_draws,
)

ATOL = RTOL = 1e-4
LATENT_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(threads)


def crc32_words(tokenizer):
    """`tokenizer` (either side's no-file CLIP or T5 wrapper) with crc32
    word ids in place of the salted-hash fallback: the same ids in every
    process."""
    n = tokenizer.vocab_size - 2
    tokenizer._tokenizer = lambda text, add_special_tokens=False: {
        "input_ids": [zlib.crc32(w.encode()) % n + 1 for w in text.lower().split()]}
    return tokenizer


def _tok(cls):
    return crc32_words(cls(None, max_length=16, vocab_size=100, bos=98, eos=99))


# -- F13: the bilinear resize -------------------------------------------------------

def _pillow_bilinear(pixels: np.ndarray, width: int, height: int) -> np.ndarray:
    return np.asarray(Image.fromarray(pixels).resize((width, height), Image.BILINEAR))


@settings(max_examples=120, deadline=None, derandomize=True)
@given(h=st.integers(1, 97), w=st.integers(1, 97), out_h=st.integers(1, 131),
       out_w=st.integers(1, 131), channels=st.sampled_from([None, 3]),
       seed=st.integers(0, 2 ** 32 - 1))
def test_resize_bilinear_is_pillows_bit_for_bit(h, w, out_h, out_w, channels, seed):
    """Every size drawn, up and down on each axis, "L" ([H, W]) and "RGB"
    ([H, W, 3]) uint8 images: no pixel differs from Pillow's."""
    shape = (h, w) if channels is None else (h, w, channels)
    pixels = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    got = pt_loader.resize_bilinear(pixels, out_w, out_h)
    want = _pillow_bilinear(pixels, out_w, out_h)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("size,out", [
    ((1365, 1024), (1024, 768)),   # a photo to a 1024 bucket's scale
    ((600, 800), (1024, 1365)),    # up to it
    ((3000, 4000), (384, 512)),    # an eightfold reduction
    ((512, 512), (512, 512)),      # its own size: a copy
])
def test_resize_bilinear_at_photo_sizes(size, out):
    rng = np.random.default_rng(sum(size))
    pixels = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    got = pt_loader.resize_bilinear(pixels, out[1], out[0])
    assert np.array_equal(got, _pillow_bilinear(pixels, out[1], out[0]))
    assert got is not pixels


def test_resize_crop_imports_no_pillow(monkeypatch):
    """The loader's scale-and-crop gives the reference's (Pillow's) pixels
    with Pillow blocked, for an image and a gray mask."""
    from onetrainer_tpu.data.bucketing import scale_crop
    rng = np.random.default_rng(3)
    image = rng.random((301, 437, 3)).astype(np.float32)
    mask = rng.random((301, 437, 1)).astype(np.float32)
    info = scale_crop(301, 437, (256, 320), True, np.random.default_rng(4))
    assert info.scale != (301, 437)
    want = [jax_loader.resize_crop(x, info) for x in (image, mask)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        from PIL import Image as _  # noqa: F401
    got = [pt_loader.resize_crop(x, info) for x in (image, mask)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# -- sampling inputs ------------------------------------------------------------------

def _masks():
    rng = np.random.default_rng(5)
    binary = np.zeros((48, 40, 1), np.float32)
    binary[9:30, 5:27] = 1.0
    soft = (rng.integers(0, 256, (48, 40, 1)) / 255.0).astype(np.float32)
    return {"binary": binary, "soft": soft, "blocky": np.kron(
        rng.integers(0, 2, (6, 5, 1)), np.ones((8, 8, 1))).astype(np.float32)}


@pytest.mark.parametrize("kind", ["binary", "soft", "blocky"])
def test_mask_functions_match_jax_exactly(kind):
    mask = _masks()[kind]
    got, want = pt_inpaint.erode_mask(mask), jax_inpaint.erode_mask(mask)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    for scale in (2, 8):
        assert np.array_equal(pt_inpaint.downsample_mask(mask, scale),
                              jax_inpaint.downsample_mask(mask, scale))
    fill = pt_inpaint.flux_fill_mask_channels(mask)
    assert fill.shape == (6, 5, 64)
    assert np.array_equal(fill, jax_inpaint.flux_fill_mask_channels(mask))


def _write_inputs(root, size=(37, 50)) -> tuple[str, str]:
    """A seeded RGB base image and a gray mask (a white block over noise)
    as PNGs at `size` (h, w)."""
    rng = np.random.default_rng(7)
    h, w = size
    base = os.path.join(root, "base.png")
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(base)
    mask = (rng.random((h, w)) * 40).astype(np.uint8)
    mask[h // 4:3 * h // 4, w // 3:] = 255
    mask_path = os.path.join(root, "mask.png")
    Image.fromarray(mask).save(mask_path)
    return base, mask_path


@pytest.mark.parametrize("inpainting", [True, False], ids=["inputs", "none"])
def test_load_inpainting_inputs_match_jax(tmp_path, inpainting):
    base, mask = _write_inputs(str(tmp_path))
    sc = SampleConfig.default_values()
    sc.sample_inpainting = inpainting
    sc.base_image_path, sc.mask_image_path = base, mask
    port_sc = PortSampleConfig.default_values().from_dict(sc.to_dict())
    want = jax_inpaint.load_inpainting_inputs(sc, 32, 48)
    got = pt_inpaint.load_inpainting_inputs(port_sc, 32, 48)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
    if inpainting:
        assert 0 < got[1].mean() < 1


# -- the data loader ------------------------------------------------------------------

def _inpaint_dataset(root: str, sizes=((200, 300), (320, 256), (256, 256), (180, 240)),
                     cond: int = 1, unmasked: int | None = -1) -> str:
    """Images at sizes none of whose buckets they fit, captions, a gray
    `-masklabel.png` for each but image `unmasked` (the last by default;
    None: every image masked), and a `-condlabel.png` for image `cond`."""
    unmasked = None if unmasked is None else range(len(sizes))[unmasked]
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(11)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, f"img{i}.png"))
        with open(os.path.join(root, f"img{i}.txt"), "w") as f:
            f.write(PROMPTS[i % 2])
        if i != unmasked:
            mask = (rng.random((h, w)) * 60).astype(np.uint8)
            mask[h // 5:h // 2 + i * 7, w // 4:] = 255
            Image.fromarray(mask).save(os.path.join(root, f"img{i}-masklabel.png"))
        if i == cond:
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(root, f"img{i}-condlabel.png"))
    return root


def _loader_configs(root, cache_dir, model_type, caching, resolution="256"):
    config = TrainConfig.default_values()
    config.model_type = model_type
    concept = ConceptConfig.default_values()
    concept.path = root
    concept.seed = 42
    concept.image.enable_crop_jitter = True
    concept.image.enable_random_flip = True
    config.concepts = [concept]
    config.batch_size = 2
    config.resolution = resolution
    config.aspect_ratio_bucketing = True
    config.latent_caching = caching
    config.cache_dir = cache_dir
    config.custom_conditioning_image = True
    config.unmasked_probability = 0.5
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _inpaint_loaders(root, tmp, model_type, caching):
    fill = model_type == ModelType.FLUX_FILL_DEV_1
    ref_cfg, port_cfg = _loader_configs(root, os.path.join(tmp, "ref"), model_type, caching)
    port_cfg.cache_dir = os.path.join(tmp, "port")
    enc_i, enc_t = _encoders()
    kw = dict(quantization=64, conditioning_image=True, fill_mask_channels=fill)
    return (jax_loader.Text2ImageDataLoader(ref_cfg, enc_i, enc_t, **kw),
            pt_loader.Text2ImageDataLoader(port_cfg, enc_i, enc_t, **kw))


@pytest.fixture(scope="module")
def inpaint_dataset(tmp_path_factory):
    return _inpaint_dataset(str(tmp_path_factory.mktemp("inpaint")))


@pytest.mark.parametrize("caching", [True, False], ids=["cached", "uncached"])
@pytest.mark.parametrize("model_type", [ModelType.STABLE_DIFFUSION_15_INPAINTING,
                                        ModelType.FLUX_FILL_DEV_1], ids=lambda t: t.value)
def test_inpainting_rows_match_the_reference_loader(inpaint_dataset, tmp_path,
                                                    model_type, caching):
    """Every batch of three epochs bitwise: the conditioning latent (the
    `-condlabel` file's, else the masked image's), the latent mask (64
    channels for FLUX.1-fill) and the rows whose mask was removed."""
    ref, port = _inpaint_loaders(inpaint_dataset, str(tmp_path), model_type, caching)
    assert [(e.image_path, e.mask_path, e.cond_path) for e in port.entries] == \
        [(e.image_path, e.mask_path, e.cond_path) for e in ref.entries]
    assert len(port.entries) == 4 and sum(e.cond_path is not None for e in port.entries) == 1
    channels = 64 if model_type == ModelType.FLUX_FILL_DEV_1 else 1
    removed = masked = 0
    for epoch in range(3):
        want = list(ref.iter_epoch(epoch))
        got = list(port.iter_epoch(epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for key, value in w.items():
                assert g[key].numpy().dtype == value.dtype, key
                assert np.array_equal(g[key].numpy(), value), key
            assert g["latent_mask"].shape[-1] == channels
            assert g["latent_conditioning_image"].shape == g["latent_image"].shape
            full = g["latent_mask"].flatten(1).min(dim=1).values == 1.0
            removed += int(full.sum())
            masked += int((~full).sum())
    assert removed > 0 and masked > 0
    # the blank conditioning latent: the encode of an all-zero image
    blank = port._blank_cond_latent((256, 256))
    assert torch.equal(blank, torch.as_tensor(
        _encoders()[0](np.zeros((1, 256, 256, 3), np.float32))["latent_image"][0]))


def test_cache_key_follows_the_conditioning_files(inpaint_dataset, tmp_path):
    """An inpainting sample's cache key changes when its mask or its
    `-condlabel` file changes, and a text-to-image loader's keys are the
    reference's (no conditioning in them)."""
    _, port = _inpaint_loaders(inpaint_dataset, str(tmp_path),
                               ModelType.STABLE_DIFFUSION_15_INPAINTING, True)
    sample = next(s for s in port.plan_epoch(0)
                  if port.entries[s.entry_index].cond_path is not None)
    e = port.entries[sample.entry_index]
    keys = [port.cache.key(e.image_path, 0, port._cache_extra(sample))]
    for path in (e.cond_path, e.mask_path):
        st_ = os.stat(path)
        os.utime(path, (st_.st_atime, st_.st_mtime + 10))
        keys.append(port.cache.key(e.image_path, 0, port._cache_extra(sample)))
    assert len(set(keys)) == 3
    ref_cfg, port_cfg = _loader_configs(inpaint_dataset, str(tmp_path / "t2i"),
                                        ModelType.STABLE_DIFFUSION_15, True)
    port_cfg.custom_conditioning_image = ref_cfg.custom_conditioning_image = False
    enc_i, enc_t = _encoders()
    ref = jax_loader.Text2ImageDataLoader(ref_cfg, enc_i, enc_t, quantization=64)
    t2i = pt_loader.Text2ImageDataLoader(port_cfg, enc_i, enc_t, quantization=64)
    for r, p in zip(ref.plan_epoch(0), t2i.plan_epoch(0)):
        assert t2i._cache_extra(p) == ref._cache_extra(r)


def test_depth_maps_stay_refused(inpaint_dataset, tmp_path):
    _, port_cfg = _loader_configs(inpaint_dataset, str(tmp_path),
                                  ModelType.STABLE_DIFFUSION_20_DEPTH, True)
    with pytest.raises(NotImplementedError, match="depth"):
        pt_loader.Text2ImageDataLoader(port_cfg, None, None)


# -- the 9-channel UNets --------------------------------------------------------------

INPAINT_SHAPES = {
    "sd15_inpainting": (ModelType.STABLE_DIFFUSION_15_INPAINTING, {}, "quick_gelu", 0),
    "sd20_inpainting": (ModelType.STABLE_DIFFUSION_20_INPAINTING,
                        {"use_linear_projection": True}, "gelu", 1),
}


def tiny_inpaint_pair(shape: str, seed: int = 1):
    """(the reference's tiny 9-channel SD model of `shape`, its flax params
    (unet, te, vae) as numpy, the port's model with the same weights)."""
    model_type, unet_kw, act, layer_skip = INPAINT_SHAPES[shape]
    jax_model = JaxSDModel(
        model_type=model_type,
        unet_config=UNetConfig(
            in_channels=9, block_out_channels=(64, 64), cross_attn_blocks=(True, False),
            layers_per_block=1, transformer_layers_per_block=(1, 1), num_heads=(4, 4),
            cross_attention_dim=32, dtype=jnp.float32, **unet_kw),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                             dtype=jnp.float32),
        te_config=CLIPTextConfig(
            vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, max_position_embeddings=16, eos_token_id=99, hidden_act=act,
            dtype=jnp.float32),
        text_encoder_layer_skip=layer_skip)
    port = StableDiffusionModel(
        model_type=pt_enums.ModelType(model_type.value),
        unet_config=_port_config(pt_unet.UNetConfig, jax_model.unet_config),
        vae_config=_port_config(pt_vae.VAEConfig, jax_model.vae_config),
        te_config=_port_config(pt_clip.CLIPTextConfig, jax_model.te_config),
        text_encoder_layer_skip=layer_skip, device="cpu")
    rng = np.random.default_rng(seed)
    sd = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
          for name, m in port.modules().items()}
    params = (jax_tf.unet_state_dict_to_flax(sd["unet"]),
              jax_tf.clip_state_dict_to_flax(sd["text_encoder"]),
              jax_tf.vae_state_dict_to_flax(sd["vae"]))
    sd_params_from_flax(port, *params)
    jax_model.unet_params, jax_model.te_params, jax_model.vae_params = jax.tree.map(
        jnp.asarray, params)
    jax_model.tokenizer = _tok(SDTokenizer)
    port.tokenizer = _tok(PortSDTokenizer)
    return jax_model, params, port


def tiny_sdxl_inpaint_pair(seed: int = 2):
    """tests/test_sdxl.py's tiny SDXL with a 9-channel UNet, and the port's
    with the same weights."""
    jax_model = tiny_sdxl_model()
    jax_model.model_type = ModelType.STABLE_DIFFUSION_XL_10_BASE_INPAINTING
    jax_model.unet_config = dataclasses.replace(jax_model.unet_config, in_channels=9)
    port = port_model_like(jax_model)
    rng = np.random.default_rng(seed)
    sd = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
          for name, m in port.modules().items()}
    params = (jax_tf.unet_state_dict_to_flax(sd["unet"]),
              jax_tf.clip_state_dict_to_flax(sd["text_encoder"]),
              jax_tf.clip_state_dict_to_flax(sd["text_encoder_2"]),
              jax_tf.vae_state_dict_to_flax(sd["vae"]))
    sdxl_params_from_flax(port, *params)
    port.tokenizer = port.tokenizer_2 = _tok(PortSDTokenizer)
    return jax_model, params, port


def _unet_inputs(context_dim: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16, 9)).astype(np.float32),
            np.asarray([10, 700], np.int32),
            rng.standard_normal((2, 16, context_dim)).astype(np.float32))


@pytest.mark.parametrize("shape", list(INPAINT_SHAPES) + ["sdxl_inpainting"])
def test_nine_channel_unet_forward_matches_jax(shape):
    if shape == "sdxl_inpainting":
        jax_model, params, port = tiny_sdxl_inpaint_pair()
        x, t, ctx = _unet_inputs(32 + 48)
        pooled = np.random.default_rng(4).standard_normal((2, 48)).astype(np.float32)
        time_ids = np.asarray([[32, 32, 0, 0, 32, 32]] * 2, np.float32)
        extra = (pooled, time_ids)
    else:
        jax_model, params, port = tiny_inpaint_pair(shape)
        x, t, ctx = _unet_inputs(32)
        extra = ()
    assert port.unet.conv_in.weight.shape[1] == 9
    want = JaxUNet(jax_model.unet_config).apply(
        {"params": params[0]}, *map(jnp.asarray, (x, t, ctx) + extra))
    with torch.no_grad():
        got = port.unet(*map(torch.from_numpy, (x, t, ctx) + extra))
    assert got.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("model_type", [ModelType.STABLE_DIFFUSION_15_INPAINTING,
                                        ModelType.STABLE_DIFFUSION_20_INPAINTING],
                         ids=lambda t: t.value)
def test_inpainting_model_configs_match_jax(model_type):
    """create_sd_model builds the inpainting types at the published widths
    with the reference's configurations (9 input channels), and get_family
    takes them."""
    from onetrainer_tpu.models import sd as jax_sd
    ref = jax_sd.create_sd_model(model_type)
    port_type = pt_enums.ModelType(model_type.value)
    port = pt_sd.create_sd_model(port_type, device="meta")
    for name in ("unet_config", "vae_config", "te_config"):
        ours, theirs = getattr(port, name), getattr(ref, name)
        for field in dataclasses.fields(ours):
            if field.name != "dtype":
                assert getattr(ours, field.name) == getattr(theirs, field.name), \
                    (name, field.name)
    assert port.unet_config.in_channels == 9
    assert port.unet.conv_in.weight.shape[1] == 9
    assert port.text_encoder_layer_skip == ref.text_encoder_layer_skip
    assert get_family(port_type).name == "sd"


# -- two LoRA steps of SD 1.5 inpainting on the loaders' batches -------------------------

def _step_configs(root: str):
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_15_INPAINTING
    config.training_method = TrainingMethod.LORA
    config.batch_size = 2
    config.lora_rank = 4
    config.lora_alpha = 8.0
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.text_encoder.train = False
    config.resolution = "32"
    config.aspect_ratio_bucketing = False
    config.latent_caching = False
    config.custom_conditioning_image = True
    config.unmasked_probability = 0.0
    concept = ConceptConfig.default_values()
    concept.path = root
    concept.seed = 42
    config.concepts = [concept]
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


@pytest.fixture(scope="module")
def inpaint_reference(tmp_path_factory):
    """Two reference LoRA steps of SD 1.5 inpainting from its setup, on the
    first batch of its loader (two images of another size than the
    bucket, one with a `-condlabel` file). Every image has a mask: an
    unmasked one's conditioning image is all zeros, whose encode by this
    tiny random VAE moves by 0.3 when its input moves by 1e-6 (a
    GroupNorm over a constant field), on either side, so the two sides'
    latents of it cannot be compared."""
    root = _inpaint_dataset(str(tmp_path_factory.mktemp("steps")),
                            sizes=((40, 56), (50, 44), (37, 37)), cond=1, unmasked=None)
    jax_model, params, port = tiny_inpaint_pair("sd15_inpainting")
    config, port_config = _step_configs(root)
    setup = jax_setup.create_sd_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    encode_images, encode_text = jax_setup.make_encode_fns(setup)
    loader = jax_loader.Text2ImageDataLoader(
        config, encode_images, encode_text, quantization=8,
        latent_scale=jax_model.vae_config.spatial_scale, conditioning_image=True)
    plan = loader.batches_for_epoch(0)[0]
    batch = loader.materialize_batch(plan)
    assert batch["latent_conditioning_image"].shape == (2, 16, 16, 4)
    assert 0 < batch["latent_mask"].mean() < 1
    jbatch = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = _jax_draws(setup.step_cfg, jbatch, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, jbatch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(port=port, port_config=port_config, init=init, batch=batch,
                plan=[(s.entry_index, s.bucket) for s in plan], steps=steps,
                latent_scale=jax_model.vae_config.spatial_scale)


def test_inpainting_lora_steps_match_jax(inpaint_reference):
    """The port's loader gives the reference's batch (the conditioning
    latent within the cache bound, the mask exactly), and `unet_input`
    feeds its 9 channels to two steps that match the reference's."""
    from onetrainer_tpu_torch.train import sd_train_step
    ref = inpaint_reference
    port = ref["port"]
    family = get_family(ref["port_config"].model_type)
    setup = family.create_setup(port, ref["port_config"], 10)
    with torch.no_grad():
        for group, adapters in ref["init"].items():
            for key, entry in lora_params_from_jax(adapters, device="cpu").items():
                for name, value in entry.items():
                    setup.state.params[group][key][name].copy_(value)
    encode_images, encode_text = family.make_encode_fns(setup)
    loader = pt_loader.Text2ImageDataLoader(
        ref["port_config"], encode_images, encode_text, quantization=8,
        latent_scale=ref["latent_scale"], conditioning_image=True)
    plan = loader.batches_for_epoch(0)[0]
    assert [(s.entry_index, s.bucket) for s in plan] == ref["plan"]
    batch = loader.materialize_batch(plan)
    assert list(batch) == list(ref["batch"])
    for name, value in ref["batch"].items():
        got = batch[name].numpy()
        if name == "latent_mask" or not np.issubdtype(value.dtype, np.floating):
            np.testing.assert_array_equal(got, value, err_msg=name)
        else:
            np.testing.assert_allclose(got, value, atol=CACHE_ATOL, rtol=0, err_msg=name)
    seen = []
    unet_input = sd_train_step.unet_input

    def recorded(noisy, b, cfg):
        out = unet_input(noisy, b, cfg)
        seen.append(tuple(out.shape))
        return out
    sd_train_step.unet_input = recorded
    try:
        gen = torch.Generator().manual_seed(0)
        metrics = []
        for ref_step in ref["steps"]:
            draws = {k: torch.from_numpy(v.copy()) for k, v in ref_step["draws"].items()}
            out = setup.train_step(setup.state, batch, gen, **draws)
            metrics.append({k: float(v) for k, v in out.items()})
    finally:
        sd_train_step.unet_input = unet_input
    assert seen and all(s == (2, 16, 16, 9) for s in seen)
    _assert_matches_reference(ref, setup, metrics)


# -- the samplers -----------------------------------------------------------------------

def _inpaint_sample_config(root: str, size: int) -> SampleConfig:
    sc = SampleConfig.default_values()
    sc.prompt = PROMPTS[0]
    sc.negative_prompt = "blurry"
    sc.height = sc.width = size
    sc.diffusion_steps = 2
    sc.cfg_scale = 7.0
    sc.seed = 3
    sc.noise_scheduler = NoiseScheduler.DDIM
    sc.sample_inpainting = True
    sc.base_image_path, sc.mask_image_path = _write_inputs(root)
    return sc


def _feed_reference_noise(monkeypatch, sc, vae_config):
    """The port's one noise draw set to the reference's initial latents."""
    _, noise_rng = jax.random.split(jax.random.PRNGKey(sc.seed))
    latent = sc.height // vae_config.spatial_scale
    noise = np.array(jax.random.normal(
        noise_rng, (1, latent, latent, vae_config.latent_channels), jnp.float32))
    for module in (pt_sampler, pt_sdxl_sampler):
        monkeypatch.setattr(module, "_initial_latents",
                            lambda shape, generator, device: torch.from_numpy(noise).to(device))


@pytest.mark.parametrize("shape", ["sd15_inpainting", "sdxl_inpainting"])
def test_inpainting_sampler_matches_jax(monkeypatch, tmp_path, shape):
    sc = _inpaint_sample_config(str(tmp_path), 32)
    jax_latents = _record_steps(monkeypatch, jax_sched)
    if shape == "sdxl_inpainting":
        jax_model, (unet, te, te2, vae), port = tiny_sdxl_inpaint_pair()
        tok = _tok(SDTokenizer)
        ref = sample_stable_diffusion_xl(jax_model, unet, te, te2, vae, tok, tok, sc)
    else:
        jax_model, _, port = tiny_inpaint_pair(shape)
        m = jax_model
        ref = sample_stable_diffusion(m, m.unet_params, m.te_params, m.vae_params,
                                      m.tokenizer, sc)
    _feed_reference_noise(monkeypatch, sc, jax_model.vae_config)
    port_latents = _record_steps(monkeypatch, pt_sched)
    calls = []
    unet_forward = port.unet.forward
    port.unet.forward = lambda x, *a: calls.append(tuple(x.shape)) or unet_forward(x, *a)
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType(jax_model.model_type.value)
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    family = get_family(config.model_type)
    port_sc = PortSampleConfig.default_values().from_dict(sc.to_dict())
    out = family.sample(family.create_setup(port, config, 1), port_sc, None)
    assert calls == [(2, 16, 16, 9)] * sc.diffusion_steps
    assert len(port_latents) == len(jax_latents) == sc.diffusion_steps
    np.testing.assert_allclose(port_latents[-1].numpy(), np.asarray(jax_latents[-1]),
                               atol=LATENT_ATOL, rtol=0)
    assert out.image.shape == ref.image.shape == (32, 32, 3)
    assert np.abs(out.image.astype(int) - ref.image.astype(int)).max() <= IMAGE_LEVELS


# -- the sample command -----------------------------------------------------------------

def _write_inpaint_dir(base: str, port) -> None:
    """The port's tiny SD 1.5 inpainting model as a diffusers directory
    with its configs (9 input channels)."""
    from onetrainer_tpu_torch.io.sd_checkpoints import save_sd_diffusers, state_dict_of
    save_sd_diffusers(base, port, *(state_dict_of(m) for m in
                                    (port.unet, port.vae, port.text_encoder)))
    configs = {
        "unet": {"in_channels": 9, "block_out_channels": [64, 64], "layers_per_block": 1,
                 "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
                 "attention_head_dim": 4, "cross_attention_dim": 32},
        "vae": {"block_out_channels": [32, 64], "layers_per_block": 1},
        "text_encoder": {"vocab_size": 100, "hidden_size": 32, "intermediate_size": 64,
                         "num_hidden_layers": 2, "num_attention_heads": 4,
                         "max_position_embeddings": 16, "eos_token_id": 99,
                         "hidden_act": "quick_gelu"},
    }
    for name, cfg in configs.items():
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(cfg, f)


def test_sample_command_inpaints(tmp_path):
    """`scripts/sample.py --sample-inpainting` on a tiny SD 1.5 inpainting
    directory: a uint8 image, another one than without the inputs; SD
    2.0 depth stays refused."""
    from onetrainer_tpu_torch.io.png import read_png
    from onetrainer_tpu_torch.scripts import sample as pt_sample
    _, _, port = tiny_inpaint_pair("sd15_inpainting")
    base = str(tmp_path / "ckpt")
    _write_inpaint_dir(base, port)
    image, mask = _write_inputs(str(tmp_path))
    args = ["--model-type", "STABLE_DIFFUSION_15_INPAINTING", "--base-model-name", base,
            "--prompt", "a cat", "--steps", "2", "--width", "32", "--height", "32",
            "--device", "cpu"]
    out = pt_sample.main(args + ["--destination", str(tmp_path / "in.png"),
                                 "--sample-inpainting", "--base-image-path", image,
                                 "--mask-image-path", mask])
    plain = pt_sample.main(args + ["--destination", str(tmp_path / "plain.png")])
    written = read_png(str(tmp_path / "in.png"))
    assert written.shape == (32, 32, 3) and np.array_equal(written, out.image)
    assert out.image.std() > 0 and not np.array_equal(out.image, plain.image)
    with pytest.raises(NotImplementedError, match="depth"):
        pt_sample.main(["--model-type", "STABLE_DIFFUSION_20_DEPTH", "--base-model-name",
                        base, "--prompt", "a", "--destination", str(tmp_path / "d.png"),
                        "--device", "cpu"])


# -- the 9-channel UNet through the single file --------------------------------------

def test_nine_channel_single_file_round_trips_both_ways(monkeypatch, tmp_path):
    """An SD 1.5 inpainting single file written by the reference loads into
    the port's family with its 9-channel conv_in bit for bit, and the file
    the port's family writes loads into the reference alike; both loaders
    take the input width from the file (their templates are 4 wide)."""
    from onetrainer_tpu.io import sd_checkpoints as jax_ckpt
    from onetrainer_tpu.models import sd as jax_sd
    jax_model, params, port = tiny_inpaint_pair("sd15_inpainting", seed=4)
    narrow = dataclasses.replace(jax_model.unet_config, in_channels=4)
    monkeypatch.setattr(jax_sd, "create_sd_model", lambda mt, **kw: dataclasses.replace(
        jax_model, unet_config=narrow))
    monkeypatch.setattr(pt_sd, "create_sd_model", lambda mt, **kw: StableDiffusionModel(
        model_type=port.model_type,
        unet_config=dataclasses.replace(port.unet_config, in_channels=4),
        vae_config=port.vae_config, te_config=port.te_config, device="meta"))
    written = str(tmp_path / "reference.safetensors")
    unet, te, vae = params
    jax_ckpt.save_sd_single_file(written, jax_model, unet, vae, te)
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.STABLE_DIFFUSION_15_INPAINTING
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.train_dtype = pt_enums.DataType.FLOAT_32
    family = get_family(config.model_type)
    loaded = family.load(written, config, device="cpu")
    assert loaded.unet_config.in_channels == 9
    want = jax_tf.unet_flax_to_state_dict(params[0])
    assert want["conv_in.weight"].shape == (64, 9, 3, 3)
    for key, value in loaded.unet.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]), err_msg=key)
    setup = family.create_setup(loaded, config, 1)
    saved = str(tmp_path / "port.safetensors")
    family.save_single_file(setup, saved)
    back = jax_ckpt.load_sd_single_file(saved, ModelType.STABLE_DIFFUSION_15_INPAINTING,
                                        weight_dtype=np.float32, device=False)
    assert back["unet_config"].in_channels == 9
    got = jax_tf.unet_flax_to_state_dict(back["unet_params"])
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)
