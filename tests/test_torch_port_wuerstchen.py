"""Parity of the torch port's Würstchen v2 / Stable Cascade models, key maps,
resampler and checkpoints with the reference (onetrainer_tpu/models/
{wuerstchen,cascade,diffnext,paella_vq}.py, io/wuerstchen_checkpoints.py,
io/single_file.py's stage_c maps, jax.image.resize).

Both sides run tests/test_trainer_wuerstchen.py's tiny models in fp32: the
v2 prior (c 48, two triples of four heads, c_cond 32) with its two-layer
CLIP, the Cascade prior of its key-exactness test (c_hidden (32, 48),
blocks (2, 1)), the full-width EfficientNetV2-S encoder, and
`_tiny_decoder_configs`' DiffNeXt and Paella VQGAN. The weights are drawn
on the port's modules (numpy, seeded), carried into the reference's flax
trees by its key maps and back into the port's modules by the port's
(io/weights.py), which must give every tensor back bit for bit.

Tolerances: the forwards of both priors, the effnet, DiffNeXt and the VQ
decode at 1e-5 relative L2; the resampler at 1e-6 (absolute plus relative:
both sides contract the same fp32 weights, summed in another order); key
maps, files and the stage_c fused keys exactly.

The timestep features r x 10000 x exp(-k log(1e4) / (c_r/2 - 1)) reach
angles of 1e4 rad in fp32, where one-ulp differences of XLA's and ATen's
exp move sin and cos by ~5e-4 (ROADMAP F27, `test_f27_...`). The forward
and step tests therefore hand both sides one fp32 frequency table
(`shared_r_table`), as tests/test_torch_port_hunyuan.py does for F11;
the angles are then equal bit for bit and everything else is held at the
stated tolerances. torch runs one thread.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from onetrainer_tpu.io import single_file as jax_sf
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.io import wuerstchen_checkpoints as jax_io
from onetrainer_tpu.io.safetensors_io import save_safetensors as jax_save
from onetrainer_tpu.models import cascade as jax_cascade
from onetrainer_tpu.models import diffnext as jax_diffnext
from onetrainer_tpu.models import paella_vq as jax_vq
from onetrainer_tpu.models import wuerstchen as jax_w
from onetrainer_tpu.models.cascade import CascadePriorConfig as JaxCascadeConfig
from onetrainer_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from onetrainer_tpu.models.wuerstchen import EffnetConfig as JaxEffnetConfig
from onetrainer_tpu.models.wuerstchen_model import WuerstchenModel as JaxWuerstchenModel
from onetrainer_tpu.util.enums import ModelType
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io import single_file as pt_sf
from onetrainer_tpu_torch.io import wuerstchen_checkpoints as pt_io
from onetrainer_tpu_torch.io.weights import (
    wuerstchen_decoder_params_from_flax, wuerstchen_params_from_flax,
)
from onetrainer_tpu_torch.models import cascade as pt_cascade
from onetrainer_tpu_torch.models import clip as pt_clip
from onetrainer_tpu_torch.models import diffnext as pt_diffnext
from onetrainer_tpu_torch.models import paella_vq as pt_vq
from onetrainer_tpu_torch.models import wuerstchen as pt_w
from onetrainer_tpu_torch.models.resize import resize
from onetrainer_tpu_torch.models.wuerstchen_model import WuerstchenModel
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_models import _port_config, _random_like
from tests.test_trainer_wuerstchen import _tiny_decoder_configs, tiny_wuerstchen_model

FORWARD_REL = 1e-5
RESIZE_TOL = 1e-6

# tests/test_trainer_wuerstchen.py:185's Cascade prior and text encoder
# (CLIP with a projection, as CLIP-G)
CASCADE_PRIOR = dict(c_in=16, c_hidden=(32, 48), nhead=(4, 4), blocks=(1, 1), c_cond=32,
                     clip_text_in=24, clip_text_pooled_in=24, clip_image_in=16)
CASCADE_TE = dict(vocab_size=100, hidden_size=24, intermediate_size=48, num_layers=2,
                  num_heads=4, max_position_embeddings=16, eos_token_id=99, projection_dim=24)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _r_table(c_r: int) -> np.ndarray:
    half = c_r // 2
    emb = math.log(10000.0) / (half - 1)
    return np.exp(np.arange(half, dtype=np.float64) * -emb).astype(np.float32)


def _jax_r_embedding(r, c_r, max_positions=10000.0):
    angles = jnp.asarray(r, jnp.float32)[:, None] * max_positions \
        * jnp.asarray(_r_table(c_r))[None]
    return jnp.concatenate([jnp.sin(angles), jnp.cos(angles)], axis=1)


def _port_r_embedding(r, c_r, max_positions=10000.0):
    angles = r.float()[:, None] * max_positions \
        * torch.from_numpy(_r_table(c_r)).to(r.device)[None]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=1)


@pytest.fixture(scope="module")
def shared_r_table():
    """Both sides' timestep features from one fp32 frequency table (F27)."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_w, jax_cascade, jax_diffnext):
            mp.setattr(module, "gen_r_embedding", _jax_r_embedding)
        for module in (pt_w, pt_cascade, pt_diffnext):
            mp.setattr(module, "gen_r_embedding", _port_r_embedding)
        yield


# -- tiny models with one set of weights on both sides ---------------------------------

def random_state_dict(module: torch.nn.Module, rng) -> dict:
    """Seeded numpy weights for every tensor of `module`: as
    tests/test_torch_port_models.py:_random_like draws them, BatchNorm's
    running variances near 1."""
    out = {}
    for k, v in module.state_dict().items():
        if k.endswith("running_var"):
            out[k] = (1.0 + 0.1 * np.abs(rng.standard_normal(tuple(v.shape)))).astype(np.float32)
        else:
            out[k] = _random_like(k, v, rng)
    return out


def jax_cascade_model() -> JaxWuerstchenModel:
    return JaxWuerstchenModel(
        model_type=ModelType.STABLE_CASCADE_1,
        prior_config=JaxCascadeConfig(**CASCADE_PRIOR, dtype=jnp.float32),
        effnet_config=JaxEffnetConfig(dtype=jnp.float32),
        te_config=JaxCLIPConfig(**CASCADE_TE, dtype=jnp.float32))


def port_like(jax_model, device="cpu") -> WuerstchenModel:
    """The port's model with the reference model's (tiny) configs."""
    prior_cls = pt_cascade.CascadePriorConfig \
        if isinstance(jax_model.prior_config, JaxCascadeConfig) else pt_w.WuerstchenPriorConfig
    return WuerstchenModel(
        model_type=pt_enums.ModelType(jax_model.model_type.value),
        prior_config=_port_config(prior_cls, jax_model.prior_config),
        effnet_config=_port_config(pt_w.EffnetConfig, jax_model.effnet_config),
        te_config=_port_config(pt_clip.CLIPTextConfig, jax_model.te_config),
        device=device)


def tiny_pair(cascade: bool = False, seed: int = 1, effnet: bool = True, jax_model=None):
    """(the reference's tiny model with weights, its flax params (prior,
    text encoder, effnet; numpy), the port's model with the same configs
    and weights); `jax_model` replaces the reference's tiny model. The
    weights go port -> the reference's key maps -> the port's key maps,
    which must give every tensor back bit for bit."""
    jax_model = jax_model or (jax_cascade_model() if cascade else tiny_wuerstchen_model())
    cascade = isinstance(jax_model.prior_config, JaxCascadeConfig)
    port = port_like(jax_model)
    rng = np.random.default_rng(seed)
    parts = ("prior", "text_encoder", "effnet") if effnet else ("prior", "text_encoder")
    sd = {name: random_state_dict(getattr(port, name), rng) for name in parts}
    # the eps head (x_in - a) / (|1 - b| + 1e-5) divides by ~1e-5 where a
    # random head puts b near 1; a tenth of the weights keeps b near 0, as
    # a trained prior's is
    head = "clf.1" if cascade else "out.1"
    for leaf in ("weight", "bias"):
        sd["prior"][f"{head}.{leaf}"] *= 0.1
    params = (jax_io.prior_state_dict_to_flax(sd["prior"]),
              jax_tf.clip_state_dict_to_flax(sd["text_encoder"]),
              jax_io.effnet_state_dict_to_flax(sd["effnet"]) if effnet else None)
    wuerstchen_params_from_flax(port, *params)
    for name in parts:
        got = getattr(port, name).state_dict()
        assert set(got) == set(sd[name]), name
        for k, v in sd[name].items():
            assert np.array_equal(got[k].numpy(), v), f"{name}.{k}"
    jax_model.prior_params, jax_model.te_params, jax_model.effnet_params = \
        jax.tree.map(jnp.asarray, params)
    return jax_model, params, port


def tiny_decoder_pair(seed: int = 2):
    """(DiffNeXt and VQ configs, their flax params, the port's decoder
    stage with the same weights on a tiny v2 model)."""
    dec_cfg, vq_cfg = _tiny_decoder_configs()
    port = port_like(tiny_wuerstchen_model(), device="meta")
    port.decoder = pt_diffnext.WuerstchenDiffNeXt(_port_config(pt_diffnext.DiffNeXtConfig,
                                                               dec_cfg))
    port.vqgan = pt_vq.PaellaVQDecoder(pt_vq.PaellaVQConfig(
        **{f.name: getattr(vq_cfg, f.name) for f in dataclasses.fields(pt_vq.PaellaVQConfig)
           if f.name != "dtype"}))
    port.decoder_config, port.vqgan_config = port.decoder.cfg, port.vqgan.cfg
    rng = np.random.default_rng(seed)
    dec_sd = random_state_dict(port.decoder, rng)
    vq_sd = random_state_dict(port.vqgan, rng)
    params = (jax_io.diffnext_state_dict_to_flax(dec_sd),
              jax_io.paella_vq_state_dict_to_flax(vq_sd))
    wuerstchen_decoder_params_from_flax(port, *params)
    for module, sd in ((port.decoder, dec_sd), (port.vqgan, vq_sd)):
        got = module.state_dict()
        assert set(got) == set(sd)
        assert all(np.array_equal(got[k].numpy(), v) for k, v in sd.items())
    return (dec_cfg, vq_cfg), params, port


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _apply(module):
    return jax.jit(lambda params, *args: module.apply({"params": params}, *args))


# -- the resampler -----------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
def test_resize_matches_jax_image_resize(method):
    """models/resize.py against jax.image.resize: the x0.75 image downscale
    (antialiased), the effnet latent up to DiffNeXt's grids and down
    below its own (antialiased bicubic), odd sizes both ways."""
    rng = np.random.default_rng(3)
    images = rng.uniform(0.0, 1.0, (2, 128, 96, 3)).astype(np.float32)
    latent = rng.standard_normal((1, 24, 24, 16)).astype(np.float32)
    cases = [(images, (96, 72)), (images, (77, 131)), (latent, (64, 64)),
             (latent, (16, 16)), (latent, (7, 40))]
    for x, size in cases:
        want = np.asarray(jax.image.resize(jnp.asarray(x), (x.shape[0],) + size + x.shape[3:],
                                           method))
        got = resize(torch.from_numpy(x), size, method).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=RESIZE_TOL,
                                   err_msg=f"{method} {x.shape} -> {size}")


def test_f26_diffnext_bicubic_is_not_torchs_align_corners():
    """F26 (ROADMAP queue 3): the reference resizes DiffNeXt's effnet
    conditioning with jax.image.resize's bicubic (Keys' a = -0.5, half-pixel
    centres), OneTrainer's diffusers model with torch's bicubic at
    align_corners=True (a = -0.75). The port follows the reference; the two
    differ by several percent on a 24x24 latent resized to 64x64 at 1024 px."""
    latent = np.random.default_rng(4).standard_normal((1, 24, 24, 16)).astype(np.float32)
    ours = resize(torch.from_numpy(latent), (64, 64), "bicubic")
    theirs = F.interpolate(torch.from_numpy(latent).permute(0, 3, 1, 2), size=(64, 64),
                           mode="bicubic", align_corners=True).permute(0, 2, 3, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(latent), (1, 64, 64, 16), "bicubic"))
    np.testing.assert_allclose(ours.numpy(), want, atol=RESIZE_TOL, rtol=RESIZE_TOL)
    gap = _rel(theirs.numpy(), ours.numpy())
    assert gap > 0.05, gap


def test_f27_timestep_features_are_ill_conditioned():
    """F27 (ROADMAP queue 3): gen_r_embedding's angles r x 10000 x freq reach
    1e4 rad in fp32; there one-ulp differences of XLA's and ATen's exp move
    the features by more than 1e-4, while small r agree to 1e-6 and a shared
    frequency table agrees to 1e-6 everywhere."""
    r = np.asarray([0.3, 0.8, 0.999, 0.5], np.float32)
    small = np.asarray([1e-4, 5e-5], np.float32)

    def gap(x, jax_fn, port_fn):
        want = np.asarray(jax_fn(jnp.asarray(x), 64))
        return np.abs(port_fn(torch.from_numpy(x), 64).numpy() - want).max()
    assert gap(r, jax_w.gen_r_embedding, pt_w.gen_r_embedding) > 1e-4
    assert gap(small, jax_w.gen_r_embedding, pt_w.gen_r_embedding) < 1e-6
    assert gap(r, _jax_r_embedding, _port_r_embedding) < 1e-6


# -- key maps ------------------------------------------------------------------------------

def test_effnet_key_maps_both_ways():
    """The port's encoder carries torchvision's keys, which the reference's
    maps take to its flax paths and back exactly; the port's copy of the
    flax-to-torch map gives the reference's string for every key."""
    port = port_like(tiny_wuerstchen_model(), device="meta")
    keys = list(port.effnet.state_dict())
    assert "backbone.0.0.weight" in keys and "mapper.1.running_var" in keys
    assert "backbone.4.0.block.2.fc1.weight" in keys      # SE at block.2
    assert "backbone.1.0.block.0.0.weight" in keys        # fused MBConv
    assert jax_io.effnet_torch_key_map("backbone.3.1.block.1.1.num_batches_tracked") is None
    assert set(pt_io.effnet_state_dict({"mapper.1.num_batches_tracked": 0, "mapper.0.weight": 1})) \
        == {"mapper.0.weight"}
    flax_keys = [jax_tf.split_int_tokens(jax_tf.merge_int_tokens(jax_io.effnet_torch_key_map(k)))
                 for k in keys]
    for key, flax_key in zip(keys, flax_keys):
        assert pt_io.effnet_flax_key_map(flax_key) == jax_io.effnet_flax_key_map(flax_key) \
            == key, key


@pytest.mark.parametrize("part", ["prior", "cascade", "diffnext", "paella_vq"])
def test_key_maps_match_the_reference_layout(part):
    """Each port module's state-dict keys and shapes are the torch layout
    the reference's flax tree maps to (its flax_params_to_torch), so the
    reference's files load into the port and back."""
    dec_cfg, vq_cfg = _tiny_decoder_configs()
    if part == "prior":
        ref, args = jax_w.WuerstchenPrior(tiny_wuerstchen_model().prior_config), (
            jnp.zeros((1, 4, 4, 16)), jnp.asarray([0.5]), jnp.zeros((1, 6, 32)))
        port = pt_w.WuerstchenPrior(_port_config(pt_w.WuerstchenPriorConfig, ref.cfg))
    elif part == "cascade":
        ref = jax_cascade.StableCascadePrior(JaxCascadeConfig(**dict(CASCADE_PRIOR, blocks=(2, 1)),
                                                              dtype=jnp.float32))
        args = (jnp.zeros((1, 4, 4, 16)), jnp.asarray([0.5]), jnp.zeros((1, 6, 24)),
                jnp.zeros((1, 24)), jnp.zeros((1, 1, 16)))
        port = pt_cascade.StableCascadePrior(_port_config(pt_cascade.CascadePriorConfig, ref.cfg))
    elif part == "diffnext":
        ref = jax_diffnext.WuerstchenDiffNeXt(dec_cfg)
        args = (jnp.zeros((1, 8, 8, 4)), jnp.asarray([0.5]), jnp.zeros((1, 2, 2, 16)),
                jnp.zeros((1, 5, 32)))
        port = pt_diffnext.WuerstchenDiffNeXt(_port_config(pt_diffnext.DiffNeXtConfig, dec_cfg))
    else:
        ref, args = jax_vq.PaellaVQDecoder(vq_cfg), (jnp.zeros((1, 4, 4, 4)),)
        port = pt_vq.PaellaVQDecoder(pt_vq.PaellaVQConfig(embed_dim=16, bottleneck_blocks=2))
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), *args))["params"]
    want = {k: tuple(v.shape) for k, v in jax_tf.flax_params_to_torch(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want


def test_cascade_stage_c_keys_both_ways():
    """io/single_file.py's stage_c maps (to_q/to_k/to_v fused into
    attention.attn.in_proj_*, to_out.0 as attn.out_proj) against the
    reference's, both directions, bit for bit."""
    port = pt_cascade.StableCascadePrior(pt_cascade.CascadePriorConfig(
        **dict(CASCADE_PRIOR, blocks=(2, 1)), dtype=torch.float32))
    sd = random_state_dict(port, np.random.default_rng(5))
    want = jax_sf.cascade_prior_to_ckpt(sd)
    got = pt_sf.cascade_prior_to_ckpt({k: torch.from_numpy(v) for k, v in sd.items()})
    assert set(got) == set(want)
    assert "down_blocks.0.2.attention.attn.in_proj_weight" in got
    assert "up_blocks.1.5.attention.attn.out_proj.bias" in got
    assert not any(".to_q." in k or ".to_k." in k for k in got)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    back = pt_sf.cascade_ckpt_to_prior(got)
    want_back = jax_sf.cascade_ckpt_to_prior(want)
    assert set(back) == set(want_back) == set(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k].numpy(), v) and np.array_equal(want_back[k], v), k


# -- forwards ------------------------------------------------------------------------------

def test_prior_forwards_match_jax(shared_r_table):
    """The v2 prior and the Cascade prior (pooled text, zero image
    embedding) on the same inputs."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    r = np.asarray([0.31, 0.87], np.float32)
    jax_model, _, port = tiny_pair(effnet=False)
    c = rng.standard_normal((2, 6, 32)).astype(np.float32)
    want = _apply(jax_model.prior)(jax_model.prior_params, x, r, c)
    with torch.no_grad():
        got = port.prior(*map(torch.from_numpy, (x, r, c)))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 4, 16)
    assert _rel(got, want) <= FORWARD_REL

    jax_model, _, port = tiny_pair(cascade=True, effnet=False)
    text = rng.standard_normal((2, 6, 24)).astype(np.float32)
    pooled = rng.standard_normal((2, 24)).astype(np.float32)
    want = jax.jit(lambda p, *a: jax_model.prior.apply({"params": p}, *a, None))(
        jax_model.prior_params, x, r, text, pooled)
    with torch.no_grad():
        got = port.prior(*map(torch.from_numpy, (x, r, text, pooled)))
    assert _rel(got, want) <= FORWARD_REL


def test_effnet_encode_matches_jax():
    """The latent cache's image path of both sides'
    `make_wuerstchen_encode_fns`: images in [-1, 1] resized x0.75
    (antialiased bilinear), ImageNet-normalized and encoded by the
    full-width EfficientNetV2-S, 128x128 to 3x3x16 latents."""
    from types import SimpleNamespace

    from onetrainer_tpu.setup.wuerstchen_setup import make_wuerstchen_encode_fns as jax_encode
    from onetrainer_tpu_torch.setup.wuerstchen_setup import make_wuerstchen_encode_fns
    jax_model, _, port = tiny_pair()
    images = np.random.default_rng(7).uniform(-1.0, 1.0, (2, 128, 128, 3)).astype(np.float32)
    # the image path alone: a step config that trains the text encoder caches no text
    step_cfg = SimpleNamespace(train_text_encoder=True)
    want = jax_encode(SimpleNamespace(model=jax_model, step_cfg=step_cfg, tokenizer=None))[0](
        images)["latent_image"]
    encode_images, _ = make_wuerstchen_encode_fns(
        SimpleNamespace(model=port, step_cfg=step_cfg, tokenizer=None))
    got = encode_images(torch.from_numpy(images))["latent_image"]
    assert got.dtype == torch.float32 and got.shape == (2, 3, 3, 16)
    assert _rel(got, want) <= FORWARD_REL


def test_diffnext_and_vq_decode_match_jax(shared_r_table):
    (dec_cfg, vq_cfg), (dec_params, vq_params), port = tiny_decoder_pair()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    effnet = rng.standard_normal((1, 3, 3, 16)).astype(np.float32)
    clip = rng.standard_normal((1, 5, 32)).astype(np.float32)
    r = np.asarray([0.6], np.float32)
    want = _apply(jax_diffnext.WuerstchenDiffNeXt(dec_cfg))(dec_params, x, r, effnet, clip)
    z = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    want_img = _apply(jax_vq.PaellaVQDecoder(vq_cfg))(vq_params, z)
    # the encoder's path (nothing encodes through it; held all the same)
    encoder = pt_vq.PaellaVQEncoder(port.vqgan.cfg)
    enc_sd = random_state_dict(encoder, rng)
    encoder.load_state_dict({k: torch.from_numpy(v) for k, v in enc_sd.items()})
    pixels = rng.uniform(0.0, 1.0, (1, 16, 16, 3)).astype(np.float32)
    want_z = _apply(jax_vq.PaellaVQEncoder(vq_cfg))(
        jax_io.paella_vq_state_dict_to_flax(enc_sd), pixels)
    with torch.no_grad():
        got = port.decoder(*map(torch.from_numpy, (x, r, effnet, clip)))
        img = port.vqgan(torch.from_numpy(z))
        latent = encoder(torch.from_numpy(pixels))
    assert got.shape == (1, 16, 16, 4) and img.shape == (1, 16, 16, 3)
    assert latent.shape == (1, 4, 4, 4)
    assert _rel(got, want) <= FORWARD_REL
    assert _rel(img, want_img) <= FORWARD_REL
    assert _rel(latent, want_z) <= FORWARD_REL


# -- checkpoints ---------------------------------------------------------------------------

PRIOR_CONFIG = {"c_in": 16, "c": 48, "c_cond": 32, "c_r": 64, "depth": 2, "nhead": 4}
TE_CONFIG = {"vocab_size": 100, "hidden_size": 32, "intermediate_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4, "max_position_embeddings": 16,
             "eos_token_id": 99, "hidden_act": "gelu"}


def write_wuerstchen_dir(base: str, params) -> str:
    """A tiny v2 prior directory and effnet file of the flax `params`
    (prior, text encoder, effnet) through the reference's key maps, as
    tests/test_trainer_wuerstchen.py:write_tiny_wuerstchen_checkpoint
    writes one, without its flax init -> the effnet file's path (None
    without an effnet tree)."""
    prior, te, effnet = params
    for name, sd, stem, config in (
            ("prior", jax_io.prior_flax_to_state_dict(prior), "diffusion_pytorch_model",
             PRIOR_CONFIG),
            ("text_encoder", jax_tf.clip_flax_to_state_dict(te), "model", TE_CONFIG)):
        os.makedirs(os.path.join(base, name), exist_ok=True)
        jax_save(os.path.join(base, name, f"{stem}.safetensors"),
                 {k: np.asarray(v) for k, v in sd.items()})
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(config, f)
    if effnet is None:
        return None
    path = os.path.join(base, "effnet_encoder.safetensors")
    jax_save(path, {k: np.asarray(v) for k, v in jax_tf.flax_params_to_torch(
        effnet, key_map=jax_io.effnet_flax_key_map).items()})
    return path


def _assert_module_is(module, flax_params, to_state_dict, key_map=None):
    want = to_state_dict(flax_params) if key_map is None else \
        jax_tf.flax_params_to_torch(flax_params, key_map=key_map)
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].float().numpy(), np.asarray(v, np.float32)), k


def test_diffusers_directory_both_ways(tmp_path):
    """A directory the reference's layout holds loads into the port
    (through the registry's load), and the port's saver writes what the
    reference's loader reads back bit for bit."""
    jax_model, params, _ = tiny_pair()
    base = str(tmp_path / "base")
    effnet = write_wuerstchen_dir(base, params)
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.WUERSTCHEN_2
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    config.effnet_encoder.model_name = effnet
    config.train_dtype = pt_enums.DataType.FLOAT_32
    family = get_family(config.model_type)
    model = family.load(base, config, device="cpu")
    assert model.prior_config == pt_w.WuerstchenPriorConfig(
        **PRIOR_CONFIG, dtype=torch.float32,
        gradient_checkpointing=config.gradient_checkpointing.enabled())
    _assert_module_is(model.prior, params[0], jax_io.prior_flax_to_state_dict)
    _assert_module_is(model.text_encoder, params[1], jax_tf.clip_flax_to_state_dict)
    _assert_module_is(model.effnet, params[2], None, jax_io.effnet_flax_key_map)

    setup = family.create_setup(model, config, 1)
    out = str(tmp_path / "out")
    family.save_model(setup, out, base)
    loaded = jax_io.load_wuerstchen_diffusers(out, effnet_path=effnet, device=False)
    assert loaded["prior_config"] == dataclasses.replace(
        jax_model.prior_config, dtype=jnp.bfloat16)
    for tree, ref in ((loaded["prior_params"], params[0]), (loaded["te_params"], params[1])):
        a, b = jax.tree.leaves(tree), jax.tree.leaves(ref)
        assert len(a) == len(b)
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))
    with pytest.raises(NotImplementedError, match="single-file"):
        family.save_single_file(setup, str(tmp_path / "w2.safetensors"))


def test_cascade_single_file_both_ways(tmp_path):
    """Stable Cascade's stage_c file and text encoder: the port's export
    loads in the reference's loader and in the port's, the reference's keys
    in the port's, bit for bit, with the configs read from the shapes
    (F28, F29: the port reads the latent channels and the text encoder's
    depth where the reference does not)."""
    jax_model, params, port = tiny_pair(cascade=True, effnet=False)
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.STABLE_CASCADE_1
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    setup = family.create_setup(port, config, 1)
    path = str(tmp_path / "stage_c.safetensors")
    family.save_single_file(setup, path)
    assert os.path.isfile(tmp_path / "text_encoder.safetensors")
    loaded = jax_sf.load_cascade_single_file(path, device=False)
    # the reference reads the shapes at published widths: 64-wide heads
    # (none at this width) and, F28, a quarter of the head's rows as c_in
    want = dataclasses.replace(jax_model.prior_config, dtype=jnp.bfloat16, nhead=(0, 0))
    assert loaded["prior_config"] == dataclasses.replace(want, c_in=8)
    for tree, ref in ((loaded["prior_params"], params[0]), (loaded["te_params"], params[1])):
        a, b = jax.tree.leaves(tree), jax.tree.leaves(ref)
        assert len(a) == len(b)
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))
    # F29: the reference reads the text encoder's width alone and keeps
    # CLIP-L's 12 layers and 3072-wide MLP; the port reads its shapes
    te = loaded["te_config"]
    assert (te.hidden_size, te.num_layers, te.intermediate_size) == (24, 12, 3072)
    config.train_dtype = pt_enums.DataType.FLOAT_32
    exported = family.load(path, config, device="cpu")
    te = exported.te_config
    assert (te.hidden_size, te.num_layers, te.intermediate_size, te.projection_dim) == \
        (24, 2, 48, 24)
    _assert_module_is(exported.text_encoder, params[1], jax_tf.clip_flax_to_state_dict)

    # the reference's stage_c keys into the port's loader
    ref_path = str(tmp_path / "ref" / "stage_c.safetensors")
    os.makedirs(os.path.dirname(ref_path))
    jax_save(ref_path, {k: np.asarray(v) for k, v in jax_sf.cascade_prior_to_ckpt(
        jax_io.prior_flax_to_state_dict(params[0])).items()})
    model = family.load(ref_path, config, device="cpu")
    assert model.prior_config == _port_config(pt_cascade.CascadePriorConfig, dataclasses.replace(
        want, gradient_checkpointing=config.gradient_checkpointing.enabled()))
    assert next(model.text_encoder.parameters()).is_meta   # no text encoder beside it
    _assert_module_is(model.prior, params[0], jax_io.prior_flax_to_state_dict)


def test_f28_reference_reads_half_the_cascade_latent_channels(tmp_path):
    """F28 (ROADMAP queue 3): the reference's stage_c loader takes the
    latent channels as a quarter of `clf.1`'s rows (onetrainer_tpu/io/
    single_file.py:load_cascade_single_file), but those rows are (a, b),
    twice the channels: the released stage C (clf.1 [32, 2048]) loads with
    c_in 8, and its prior then cannot apply its own weights. The port reads
    16."""
    cfg = JaxCascadeConfig(**dict(CASCADE_PRIOR, c_hidden=(64, 64), nhead=(1, 1), c_cond=64),
                           dtype=jnp.float32)
    port = pt_cascade.StableCascadePrior(_port_config(pt_cascade.CascadePriorConfig, cfg))
    sd = random_state_dict(port, np.random.default_rng(9))
    path = str(tmp_path / "stage_c.safetensors")
    jax_save(path, jax_sf.cascade_prior_to_ckpt(sd))
    ref = jax_sf.load_cascade_single_file(path, device=False)
    assert (ref["prior_config"].c_in, pt_sf.load_cascade_single_file(
        path, device="cpu")["prior_config"].c_in) == (8, 16)
    args = (jnp.zeros((1, 4, 4, 16)), jnp.asarray([0.5]), jnp.zeros((1, 6, 24)),
            jnp.zeros((1, 24)), None)
    with pytest.raises(Exception, match="clf_1"):
        jax.eval_shape(lambda: jax_cascade.StableCascadePrior(dataclasses.replace(
            ref["prior_config"], dtype=jnp.float32)).apply({"params": ref["prior_params"]}, *args))
    fixed = dataclasses.replace(ref["prior_config"], c_in=16, dtype=jnp.float32)
    assert jax.eval_shape(lambda: jax_cascade.StableCascadePrior(fixed).apply(
        {"params": ref["prior_params"]}, *args)).shape == (1, 4, 4, 16)


DECODER_CONFIGS = {
    "decoder": {"c_hidden": [16, 32], "nhead": [-1, 4], "blocks": [1, 1],
                "level_config": ["CT", "CTA"], "inject_effnet": [False, True], "c_cond": 16,
                "clip_embd": 32, "c_r": 16, "effnet_embd": 16},
    "vqgan": {"embed_dim": 16, "bottleneck_blocks": 2},
    "text_encoder": TE_CONFIG,
}


def write_decoder_dir(decoder_dir: str, port) -> None:
    """The port's decoder stage of `port` (DiffNeXt, VQGAN; the prior's CLIP
    as the decoder's) through its saver, with `DECODER_CONFIGS`."""
    pt_io.save_wuerstchen_decoder(decoder_dir, port.decoder.state_dict(),
                                  port.vqgan.state_dict(), port.text_encoder.state_dict(),
                                  DECODER_CONFIGS)


def test_decoder_directory_both_ways(tmp_path):
    """The port writes a decoder directory the reference's loader reads
    bit for bit, and loads it back through the registry
    (`decoder.model_name`)."""
    (dec_cfg, vq_cfg), (dec_params, vq_params), port = tiny_decoder_pair()
    jax_model, params, tiny = tiny_pair(effnet=False)
    port.text_encoder = tiny.text_encoder
    decoder_dir = str(tmp_path / "decoder")
    write_decoder_dir(decoder_dir, port)
    loaded = jax_io.load_wuerstchen_decoder(decoder_dir, compute_dtype=jnp.float32)
    assert loaded["decoder_config"] == dec_cfg
    assert loaded["vqgan_config"] == vq_cfg
    for tree, ref in ((loaded["decoder_params"], dec_params),
                      (loaded["vqgan_params"], vq_params),
                      (loaded["decoder_te_params"], params[1])):
        a, b = jax.tree.leaves(tree), jax.tree.leaves(ref)
        assert len(a) == len(b)
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))

    base = str(tmp_path / "base")
    write_wuerstchen_dir(base, params)
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.WUERSTCHEN_2
    config.train_dtype = pt_enums.DataType.FLOAT_32
    config.decoder.model_name = decoder_dir
    model = get_family(config.model_type).load(base, config, device="cpu")
    assert model.decoder_config == port.decoder_config
    for module, want in ((model.decoder, port.decoder), (model.vqgan, port.vqgan),
                         (model.decoder_text_encoder, port.text_encoder)):
        got, ref = module.state_dict(), want.state_dict()
        assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
