"""Parity of the torch port's HunyuanVideo slice with the reference
(onetrainer_tpu/models/llama.py, video_vae.py, hunyuan_video.py,
setup/hunyuan_setup.py `create_hunyuan_setup`, train/hunyuan_train_step.py
`make_hunyuan_train_step` and the video path of data/loader.py).

Both sides run tests/test_trainer_hunyuan.py's tiny HunyuanVideo (one
double and one single block, hidden 48, four d=12 heads, RoPE axes
(4, 4, 4), one refiner layer; a two-layer Llama 24 wide with two heads
over one kv head; CLIP 16 wide; the causal VAE with channels (8, 16, 16,
16) and one block per stage), in fp32, with the same seeded weights (the
port's state dicts through the reference's key maps, then
`io.weights.hunyuan_params_from_flax`). The Llama tokenizer's hash
fallback keeps the template's 95 positions and 12 text positions.

Tolerances: packing, unpacking, the position ids and the video loader's
frames exactly; the RoPE tables within tests/test_torch_port_flux.py's
ROPE_ATOL; every forward (Llama's hidden states, the VAE's encode and
decode, the refiner, the transformer with a padded text mask) 1e-4
absolute plus 1e-4 relative (fp32 networks summed in another order).

The reference scales the transformer's timestep and guidance by 1000
twice (ROADMAP F11), so its sinusoidal features take angles up to 6e6
rad, where one ulp of an fp32 frequency moves the angle by up to 0.4: XLA's
exp and ATen's differ in the last bit of 14 of the 128 frequencies, and the
features then differ by up to 0.1 (`test_f11_...` shows it). The tests
that run the transformer therefore give `TimeTextEmbed` on both sides one
frequency table (exp in float64, rounded to fp32; the fixture
`shared_timestep_table`): the angles are then equal bit for bit and sin
and cos agree to an ulp, so the comparison holds everything else of the
transformer at 1e-4. The refiner's features (angles up to 1000) run
unpatched.

The LoRA steps run both setups from one config (LoRA r4 a8 on the
transformer, guidance 6, Llama and CLIP dropout 0.5, two steps over two
5-frame clips at 32x32); three cases: the text cached by each side's
`make_hunyuan_encode_fns` on an fp32 base, Llama trained (text encoded in
the step, its adapters seeded 1) on an fp32 base, and the text cached on
an NF4 base. The reference's key splits are replayed for its timesteps,
noise, latent-sampling noise and keep masks, and the port's step takes
them. The loss and the grad norm agree to
tests/test_torch_port_train_sdxl.py's REL and each group's adapters to
REL relative L2 after two steps (QLORA_REL on the NF4 base).

The reference setups are built once per module; torch runs one thread.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.concept_config import ConceptConfig
from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.data.loader import Text2ImageDataLoader as JaxLoader
from onetrainer_tpu.io import hunyuan_checkpoints as jax_io
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.math.noise import create_noise as jax_noise
from onetrainer_tpu.math.timesteps import sample_timesteps_discrete as jax_timesteps
from onetrainer_tpu.models import hunyuan_video as jax_hv
from onetrainer_tpu.models import llama as jax_llama
from onetrainer_tpu.models.video_vae import AutoencoderKLVideo as JaxVideoVAE
from onetrainer_tpu.setup import hunyuan_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import LlamaTokenizerWrapper, SDTokenizer
from onetrainer_tpu.train.sd_train_step import conditioning_dropout_mask as jax_keep
from onetrainer_tpu.util.enums import DataType, ModelType, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.data.loader import Text2ImageDataLoader as PortLoader
from onetrainer_tpu_torch.io.weights import hunyuan_params_from_flax, lora_params_from_jax
from onetrainer_tpu_torch.models import clip as pt_clip
from onetrainer_tpu_torch.models import flux as pt_flux
from onetrainer_tpu_torch.models import hunyuan_video as pt_hv
from onetrainer_tpu_torch.models import llama as pt_llama
from onetrainer_tpu_torch.models import video_vae as pt_vvae
from onetrainer_tpu_torch.models.hunyuan_video_model import HunyuanVideoModel
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import LlamaTokenizerWrapper as PortLlamaTokenizer
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_flux import ROPE_ATOL
from tests.test_torch_port_models import _port_config, _random_like
from tests.test_torch_port_train_sdxl import (
    CACHE_ATOL, PROMPTS, QLORA_REL, REL, SEED, STEPS, _assert_matches_reference,
)
from tests.test_trainer_hunyuan import make_video_dataset, tiny_hunyuan_model

ATOL = RTOL = 1e-4
TEXT_TOKENS = 12
LLAMA_LENGTH = jax_hv.PROMPT_TEMPLATE_CROP_START + TEXT_TOKENS
DROPOUT = 0.5
GUIDANCE = 6.0
FRAMES = 5          # 2 latent frames through the causal VAE
SIZE = 32


def _tokenizers(llama_cls, clip_cls):
    return (llama_cls(None, max_length=LLAMA_LENGTH, vocab_size=130),
            clip_cls(None, max_length=16, vocab_size=100, bos=98, eos=99))


def port_hunyuan_like(jax_model, device="cpu", **transformer_overrides) -> HunyuanVideoModel:
    """The port's HunyuanVideo with the reference model's (tiny) configs."""
    tcfg = dataclasses.replace(
        _port_config(pt_hv.HunyuanVideoConfig, jax_model.transformer_config),
        **transformer_overrides)
    return HunyuanVideoModel(
        model_type=pt_enums.ModelType(jax_model.model_type.value),
        transformer_config=tcfg,
        vae_config=_port_config(pt_vvae.VideoVAEConfig, jax_model.vae_config),
        te_config=_port_config(pt_llama.LlamaConfig, jax_model.te_config),
        te2_config=_port_config(pt_clip.CLIPTextConfig, jax_model.te2_config),
        device=device)


def random_hunyuan_params(port, seed: int = 1) -> tuple:
    """Seeded weights for every parameter of the port's HunyuanVideo, as the
    reference's flax trees (numpy) through its key maps: (transformer,
    Llama, CLIP, VAE)."""
    rng = np.random.default_rng(seed)
    sd = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
          for name, m in port.modules().items()}
    return (jax_io.hunyuan_state_dict_to_flax(sd["transformer"]),
            jax_io.llama_state_dict_to_flax(sd["text_encoder"]),
            jax_tf.clip_state_dict_to_flax(sd["text_encoder_2"]),
            jax_io.video_vae_state_dict_to_flax(sd["vae"]))


def tiny_hunyuan_pair(seed: int = 1, **transformer_overrides):
    """(the reference's tiny HunyuanVideo with weights, its flax params as
    numpy, the port's model with the same configs and weights)."""
    jax_model = tiny_hunyuan_model()
    port = port_hunyuan_like(jax_model, **transformer_overrides)
    params = random_hunyuan_params(port, seed)
    hunyuan_params_from_flax(port, *params)
    (jax_model.transformer_params, jax_model.te_params, jax_model.te2_params,
     jax_model.vae_params) = jax.tree.map(jnp.asarray, params)
    jax_model.tokenizer, jax_model.tokenizer_2 = _tokenizers(LlamaTokenizerWrapper,
                                                             SDTokenizer)
    port.tokenizer, port.tokenizer_2 = _tokenizers(PortLlamaTokenizer, PortSDTokenizer)
    return jax_model, params, port


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    return tiny_hunyuan_pair()


def _frequencies(dim: int, max_period: float, shift: float) -> np.ndarray:
    half = dim // 2
    return np.exp(-math.log(max_period) * np.arange(half) / (half - shift)).astype(np.float32)


def _jax_table_features(timesteps, dim, max_period=10000.0, flip_sin_to_cos=True,
                        downscale_freq_shift=0.0):
    freqs = jnp.asarray(_frequencies(dim, max_period, downscale_freq_shift))
    emb = timesteps.astype(jnp.float32)[:, None] * freqs[None, :]
    parts = [jnp.cos(emb), jnp.sin(emb)] if flip_sin_to_cos else [jnp.sin(emb), jnp.cos(emb)]
    return jnp.concatenate(parts, axis=-1)


def _port_table_features(timesteps, dim, max_period=10000.0, flip_sin_to_cos=True,
                         downscale_freq_shift=0.0):
    freqs = torch.from_numpy(_frequencies(dim, max_period, downscale_freq_shift))
    emb = timesteps.float()[:, None] * freqs.to(timesteps.device)[None, :]
    parts = [torch.cos(emb), torch.sin(emb)] if flip_sin_to_cos \
        else [torch.sin(emb), torch.cos(emb)]
    return torch.cat(parts, dim=-1)


@pytest.fixture(scope="module")
def shared_timestep_table():
    """`TimeTextEmbed`'s features on both sides from one fp32 frequency
    table (see the module docstring: F11)."""
    from onetrainer_tpu.models import flux as jax_flux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_flux, "timestep_embedding", _jax_table_features)
        mp.setattr(pt_flux, "timestep_embedding", _port_table_features)
        yield


def test_f11_transformer_timestep_features_are_ill_conditioned():
    """The features of the reference's transformer timestep (t x 1000,
    t < 1000) and guidance (g x 1000 x 1000): at those angles XLA's and
    ATen's fp32 features differ by more than 1e-3, from one-ulp differences
    of their exp; the refiner's (t alone) agree to 1e-4, and so do both
    with one shared frequency table."""
    from onetrainer_tpu.models.unet import timestep_embedding as jax_features
    from onetrainer_tpu_torch.models.unet import timestep_embedding as port_features

    def gap(t, jax_fn, port_fn):
        want = np.asarray(jax_fn(jnp.asarray(t), 256, flip_sin_to_cos=True,
                                 downscale_freq_shift=0))
        got = port_fn(torch.from_numpy(t), 256, flip_sin_to_cos=True,
                      downscale_freq_shift=0).numpy()
        return np.abs(got - want).max()
    transformer = np.asarray([250.0, 900.0, 6000.0], np.float32) * 1000.0
    refiner = np.asarray([250.0, 900.0, 999.0], np.float32)
    assert gap(transformer, jax_features, port_features) > 1e-3
    assert gap(refiner, jax_features, port_features) <= 1e-4
    assert gap(transformer, _jax_table_features, _port_table_features) <= 1e-6


def _close(port: torch.Tensor, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


# -- modules ---------------------------------------------------------------------------

def test_llama_hidden_states_and_encode_match_jax(pair):
    jax_model, params, port = pair
    tokens = np.stack([jax_model.tokenizer(p) for p in PROMPTS])
    mask = np.stack([jax_model.tokenizer.mask(t) for t in tokens])
    np.testing.assert_array_equal(tokens, np.stack([port.tokenizer(p) for p in PROMPTS]))
    assert mask[:, :jax_hv.PROMPT_TEMPLATE_CROP_START].all() and not mask.all()
    want = jax_llama.LlamaEncoder(jax_model.te_config).apply(
        {"params": params[1]}, jnp.asarray(tokens), jnp.asarray(mask))
    with torch.no_grad():
        got = port.text_encoder(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == 3
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        _close(g, w)
    for skip in (0, 1):
        picked = pt_llama.encode_llama_text(got, skip, default_layer=-3, crop_start=95)
        assert tuple(picked.shape) == (2, TEXT_TOKENS, 24)
        _close(picked, jax_llama.encode_llama_text(want, skip, default_layer=-3,
                                                   crop_start=95))


def test_video_vae_encode_and_decode_match_jax(pair):
    jax_model, params, port = pair
    rng = np.random.default_rng(4)
    vae = JaxVideoVAE(jax_model.vae_config)
    for clip in (rng.uniform(-1, 1, (1, FRAMES, SIZE, SIZE, 3)),
                 rng.uniform(-1, 1, (2, 1, 16, 24, 3))):
        clip = clip.astype(np.float32)
        want = vae.apply({"params": params[3]}, jnp.asarray(clip), method=vae.encode)
        with torch.no_grad():
            got = port.vae.encode(torch.from_numpy(clip))
        t_latent = (clip.shape[1] - 1) // 4 + 1
        for g, w in zip(got, want):
            assert tuple(g.shape) == (clip.shape[0], t_latent, clip.shape[2] // 8,
                                      clip.shape[3] // 8, 16)
            _close(g, w)
    z = rng.standard_normal((1, 2, 4, 4, 16)).astype(np.float32)
    want = vae.apply({"params": params[3]}, jnp.asarray(z), method=vae.decode)
    with torch.no_grad():
        got = port.vae.decode(torch.from_numpy(z))
    assert tuple(got.shape) == (1, FRAMES, SIZE, SIZE, 3) and got.dtype == torch.float32
    _close(got, want)


def test_packing_ids_and_rope_match_jax():
    rng = np.random.default_rng(2)
    latents = rng.standard_normal((2, 3, 8, 6, 16)).astype(np.float32)
    packed = pt_hv.pack_video_latents(torch.from_numpy(latents))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax_hv.pack_video_latents(latents)))
    np.testing.assert_array_equal(pt_hv.unpack_video_latents(packed, 3, 8, 6).numpy(),
                                  latents)
    # HunyuanVideo's grid at 512x512 with 9 latent frames, and a ragged one
    for t, h, w in ((9, 64, 64), (3, 8, 6)):
        np.testing.assert_array_equal(pt_hv.prepare_video_ids(t, h, w).numpy(),
                                      np.asarray(jax_hv.prepare_video_ids(t, h, w)))
    ids = np.asarray(jax_hv.prepare_video_ids(9, 64, 64))
    want = jax_flux_rope(ids, (16, 56, 56), 256.0)
    got = pt_flux.rope_tables(torch.from_numpy(ids), (16, 56, 56), 256.0)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (9216, 128) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ROPE_ATOL, rtol=0)


def jax_flux_rope(ids, axes, theta):
    from onetrainer_tpu.models.flux import rope_tables
    return rope_tables(jnp.asarray(ids), axes, theta)


def _text_inputs(seed=3, batch=2):
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((batch, 6, 24)).astype(np.float32)
    mask = np.asarray([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]][:batch], np.int32)
    return states, mask


def test_token_refiner_matches_jax(pair):
    jax_model, params, port = pair
    states, mask = _text_inputs()
    t = np.asarray([250.0, 900.0], np.float32)
    cfg = jax_model.transformer_config
    for m in (mask, None):
        want = jax_hv.TokenRefiner(cfg).apply(
            {"params": params[0]["context_embedder"]}, jnp.asarray(states), jnp.asarray(t),
            None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = port.transformer.context_embedder(
                torch.from_numpy(states), torch.from_numpy(t),
                None if m is None else torch.from_numpy(m))
        _close(got, want)


@pytest.mark.parametrize("masked", [True, False], ids=["padded_text_mask", "no_mask"])
def test_transformer_forward_matches_jax(pair, masked, shared_timestep_table):
    jax_model, params, port = pair
    rng = np.random.default_rng(5)
    latents = rng.standard_normal((2, 2, 4, 4, 16)).astype(np.float32)
    states, mask = _text_inputs()
    mask = mask if masked else None
    t = np.asarray([250.0, 900.0], np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    guidance = np.asarray([6000.0, 1000.0], np.float32)
    sd = port.transformer.state_dict()
    assert sd["x_embedder.proj.weight"].shape == (48, 64)
    assert "context_embedder.token_refiner.refiner_blocks.0.ff.net.2.weight" in sd
    want = jax_hv.HunyuanVideoTransformer3D(jax_model.transformer_config).apply(
        {"params": params[0]}, jnp.asarray(latents), jnp.asarray(t), jnp.asarray(states),
        None if mask is None else jnp.asarray(mask), jnp.asarray(pooled),
        jnp.asarray(guidance))
    with torch.no_grad():
        got = port.transformer(torch.from_numpy(latents), torch.from_numpy(t),
                               torch.from_numpy(states),
                               None if mask is None else torch.from_numpy(mask),
                               torch.from_numpy(pooled), torch.from_numpy(guidance))
    assert got.shape == (2, 2, 4, 4, 16) and got.dtype == torch.float32
    _close(got, want)


def test_full_checkpointing_gives_the_forward_and_gradients_of_none(pair):
    """"full" recomputes each block; another policy raises."""
    _, params, port = pair
    ckpt = port_hunyuan_like(tiny_hunyuan_model(), gradient_checkpointing=True)
    hunyuan_params_from_flax(ckpt, *params)
    rng = np.random.default_rng(6)
    latents = torch.from_numpy(rng.standard_normal((2, 2, 4, 4, 16)).astype(np.float32))
    states, mask = (torch.from_numpy(a) for a in _text_inputs())
    args = (torch.tensor([250.0, 900.0]), states, mask, torch.ones((2, 16)))
    outs = []
    for model in (port, ckpt):
        x = latents.clone().requires_grad_()
        out = model.transformer(x, *args)
        outs.append((out, torch.autograd.grad(out.square().sum(), x)[0]))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="not ported"):
        port_hunyuan_like(tiny_hunyuan_model(), gradient_checkpointing=True,
                          remat_policy="dots_nb_attn")


# -- two LoRA steps through the setups ---------------------------------------------

_CASES = {"cached_text": (False, DataType.FLOAT_32), "live_text": (True, DataType.FLOAT_32),
          "cached_text_nf4": (False, DataType.NFLOAT_4)}


def _configs(train_te: bool, base_dtype=DataType.FLOAT_32):
    config = TrainConfig.default_values()
    config.model_type = ModelType.HUNYUAN_VIDEO
    config.training_method = TrainingMethod.LORA
    config.batch_size = 2
    config.lora_rank = 4
    config.lora_alpha = 8.0
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.prior.train = True
    config.prior.guidance_scale = GUIDANCE
    config.prior.weight_dtype = base_dtype
    config.text_encoder.train = train_te
    for part in (config.text_encoder, config.text_encoder_2):
        part.dropout_probability = DROPOUT
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _clips():
    rng = np.random.default_rng(SEED)
    return rng.uniform(-1.0, 1.0, (2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


def _batch(encode_images, encode_text, clips, as_array):
    batch = {name: as_array(value) for name, value in encode_images(clips).items()}
    texts = [encode_text(p) for p in PROMPTS]
    for name in texts[0]:
        batch[name] = as_array(np.stack([np.asarray(t[name]) for t in texts]))
    batch["loss_weight"] = as_array(np.ones((2,), np.float32))
    return batch


def _jax_draws(step_cfg, batch, rng, step):
    """The draws of the reference's step `step` (its own key splits):
    hunyuan_predict's timesteps, noise and latent-sampling noise, and the
    Llama and CLIP keep masks from fold_in(rng_predict, 0xd0)."""
    rng_loss, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, rng_predict = jax.random.split(rng_loss)
    rng_t, rng_noise, rng_sample = jax.random.split(rng_predict, 3)
    latent = batch["latent_image"]
    drop = jax.random.fold_in(rng_predict, 0xd0)
    return {
        "timestep": np.asarray(jax_timesteps(
            rng_t, latent.shape[0], step_cfg.timestep,
            num_train_timesteps=step_cfg.num_train_timesteps)),
        "noise": np.asarray(jax_noise(rng_noise, latent.shape, latent.dtype)),
        "latent_noise": np.asarray(jax.random.normal(rng_sample, latent.shape,
                                                     latent.dtype)),
        "dropout_keep": tuple(np.asarray(jax_keep(jax.random.fold_in(drop, i + 1),
                                                  latent.shape[0], p))
                              for i, p in enumerate((step_cfg.te_dropout,
                                                     step_cfg.te2_dropout))),
    }


def _reference(case: str) -> dict:
    train_te, base_dtype = _CASES[case]
    jax_model, params, _ = tiny_hunyuan_pair()
    config, port_config = _configs(train_te, base_dtype)
    setup = jax_setup.create_hunyuan_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    clips = _clips()
    encode_images, encode_text = jax_setup.make_hunyuan_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, encode_text, clips, jnp.asarray))
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = _jax_draws(setup.step_cfg, batch, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(case=case, train_te=train_te, params=params, init=init, clips=clips,
                batch=jax.device_get(batch), steps=steps, port_config=port_config)


@pytest.fixture(scope="module", params=list(_CASES))
def reference(request, shared_timestep_table):
    return _reference(request.param)


def _port_setup(ref):
    """The port's setup through the registry, with the reference's initial
    adapters, and its own cached batch (held to the reference's)."""
    port = port_hunyuan_like(tiny_hunyuan_model())
    hunyuan_params_from_flax(port, *ref["params"])
    port.tokenizer, port.tokenizer_2 = _tokenizers(PortLlamaTokenizer, PortSDTokenizer)
    family = get_family(ref["port_config"].model_type)
    setup = family.create_setup(port, ref["port_config"], 10)
    assert set(setup.state.params) == set(ref["init"])
    with torch.no_grad():
        for group, adapters in ref["init"].items():
            carried = lora_params_from_jax(adapters, device="cpu")
            assert set(carried) == set(setup.state.params[group])
            for key, entry in carried.items():
                for name, value in entry.items():
                    setup.state.params[group][key][name].copy_(value)
    encode_images, encode_text = family.make_encode_fns(setup)
    batch = _batch(encode_images, encode_text, torch.from_numpy(ref["clips"]),
                   torch.as_tensor)
    assert set(batch) == set(ref["batch"])
    for name, value in ref["batch"].items():
        if np.issubdtype(np.asarray(value).dtype, np.floating):
            np.testing.assert_allclose(batch[name].numpy(), value, atol=CACHE_ATOL,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(batch[name].numpy(), value, err_msg=name)
    return setup, batch


def _draws(ref_step) -> dict:
    draws = {k: torch.from_numpy(v.copy()) for k, v in ref_step["draws"].items()
             if k != "dropout_keep"}
    draws["dropout_keep"] = tuple(torch.from_numpy(m.copy())
                                  for m in ref_step["draws"]["dropout_keep"])
    return draws


def test_lora_steps_match_jax(reference):
    from onetrainer_tpu_torch.ops.quant import NF4Array
    ref = reference
    setup, batch = _port_setup(ref)
    assert set(setup.state.params) == ({"transformer_lora", "te_lora"} if ref["train_te"]
                                       else {"transformer_lora"})
    assert ("text_encoder_1_hidden_state" in batch) is not ref["train_te"]
    assert tuple(batch["latent_image"].shape) == (2, 2, SIZE // 8, SIZE // 8, 16)
    # the cached mask covers the 12 text positions, some of them padding
    mask = batch["tokens_mask_1"]
    assert mask.shape[-1] == (TEXT_TOKENS if not ref["train_te"] else LLAMA_LENGTH)
    assert not bool(mask.all())
    base = NF4Array if ref["case"] == "cached_text_nf4" else torch.Tensor
    # the quantize policy's smallest kernel is 4096 elements: norm1.linear
    # (48 x 288) is quantized here, the 48 x 48 projections are not
    assert isinstance(setup.model.transformer.transformer_blocks[0].norm1.linear.weight, base)
    masks = [m for s in ref["steps"] for m in s["draws"]["dropout_keep"]]
    assert {0.0, 1.0} == set(np.concatenate(masks).tolist())
    gen = torch.Generator().manual_seed(0)
    metrics, up_max = [], None
    for step, ref_step in enumerate(ref["steps"]):
        out = setup.train_step(setup.state, batch, gen, **_draws(ref_step))
        metrics.append({k: float(v) for k, v in out.items()})
        if step == 0:
            up_max = max(float(e["lora_up"].detach().abs().max())
                         for e in setup.state.params["transformer_lora"].values())
    assert up_max > 0.0
    rel = QLORA_REL if ref["case"] == "cached_text_nf4" else REL
    _assert_matches_reference(ref, setup, metrics, params_rel=rel, norm_rel=rel)


# -- the video loader ------------------------------------------------------------------

def test_video_loader_frames_match_jax(tmp_path):
    """The same clips, start draws, buckets and batches; every frame and
    image exactly the reference's pixels."""
    dataset = make_video_dataset(str(tmp_path / "ds"), frames=12, size=SIZE)
    config = TrainConfig.default_values()
    config.model_type = ModelType.HUNYUAN_VIDEO
    config.resolution = str(SIZE)
    config.frames = str(FRAMES)
    config.batch_size = 1
    config.aspect_ratio_bucketing = False
    config.latent_caching = False
    concept = ConceptConfig.default_values()
    concept.path = dataset
    concept.seed = 3
    config.concepts = [concept]
    port_config = PortTrainConfig.default_values().from_dict(config.to_dict())
    ref = JaxLoader(config, lambda x: {}, lambda p: {}, quantization=32, video_mode=True)
    got = PortLoader(port_config, None, None, quantization=32, video_mode=True)
    assert [e.image_path for e in got.entries] == [e.image_path for e in ref.entries]
    assert got._sizes == ref._sizes
    for epoch in (0, 1):
        want_batches = ref.batches_for_epoch(epoch)
        got_batches = got.batches_for_epoch(epoch)
        assert [[(s.entry_index, s.bucket, s.frames) for s in b] for b in got_batches] == \
            [[(s.entry_index, s.bucket, s.frames) for s in b] for b in want_batches]
        frames = set()
        for want_b, got_b in zip(want_batches, got_batches):
            for w_s, g_s in zip(want_b, got_b):
                w_px, w_mask, _ = ref._load_pixels(w_s)
                g_px, g_mask, _ = got._load_pixels(g_s)
                np.testing.assert_array_equal(g_px, w_px)
                np.testing.assert_array_equal(g_mask, w_mask)
                assert got._prompt(g_s) == ref._prompt(w_s)
                frames.add(g_px.shape[0] if g_px.ndim == 4 else 1)
        assert frames == {FRAMES, 1}


def test_causal_conv_in_frame_chunks_equals_one_call(monkeypatch):
    """A convolution over more elements than one call takes runs in chunks
    of output frames (strides 1 and 2 in time) and gives the one call's
    output exactly."""
    torch.manual_seed(0)
    x = torch.randn((1, 3, 9, 6, 5))
    for stride in ((1, 1, 1), (2, 2, 2)):
        conv = pt_vvae.CausalConv3d(3, 4, stride=stride)
        whole = conv(x)
        monkeypatch.setattr(pt_vvae, "MAX_CONV_ELEMENTS", 3 * 8 * 7 * 5)
        chunked = conv(x)
        monkeypatch.undo()
        assert torch.equal(chunked, whole), stride
