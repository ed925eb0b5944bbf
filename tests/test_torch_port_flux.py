"""Parity of the torch port's FLUX slice with the reference
(onetrainer_tpu/models/flux.py, math/timesteps.py
`sample_timesteps_continuous`, setup/flux_setup.py `create_flux_setup` and
train/flux_train_step.py `make_flux_train_step`).

Both sides run tests/test_flux.py's tiny FLUX (two double and two single
blocks, hidden 32, two d=16 heads, RoPE axes (4, 6, 6); CLIP-L 20 wide, a
two-layer T5 24 wide; a 4-channel VAE), in fp32, with the same seeded
weights (the port's state dicts through the reference's key maps, then
`io.weights.flux_params_from_flax`).

Tolerances: packing, unpacking and the image ids exactly; the RoPE tables
within 1.2e-7 absolute (one fp32 ulp below 1: XLA's and ATen's fp32 cos
and sin round a few angles to neighbouring values); `apply_rope` 1e-6
absolute; forwards 1e-4 absolute plus 1e-4 relative (fp32 networks summed
in another order); each LoRA layer preset's layer set, and the kohya
file's keys and tensors, exactly; the µ shift exactly; the continuous
timesteps in distribution (both on the 1/10000 grid in (0, 1], means
within 5 sigma of each other, the histograms over ten bins within 0.02 of
each other on 20000 draws each).

The LoRA steps run both setups from one config (the reference's
`TrainConfig` carried into the port's by `to_dict`/`from_dict`): LoRA r4
a8 on the transformer, CLIP-L and T5 dropout 0.5, guidance 3.5, dynamic
timestep shifting, two steps; three cases: the text cached by each side's
`make_flux_encode_fns` on an fp32 base, CLIP-L trained (text encoded in
the step, from token ids drawn from the test's numpy seed) on an INT_8
base, and the text cached on an NF4 base (the
port's plain dequant on the CPU; the reference's gather dequant). Torch
and JAX draw different numbers, so the reference's key splits
(`train_step` :174, `loss_fn` :165, `flux_predict` :62 and the dropout key
:95) are replayed to get its timesteps, noise, latent-sampling noise and
keep masks, and the port's step takes them. The loss and the grad norm
agree to 1e-4 relative and each group's adapters to 1e-4 relative L2 after
two steps (1e-3 on the NF4 base, as tests/test_torch_port_train_sdxl.py
states for QLoRA). The checkpoint policies: one step's LoRA gradients with
"full" and "dots_nb_attn" equal those without checkpointing to 1e-6
relative L2.

The tokenizers' no-file fallback hashes words with Python's salted `hash`,
so each process would feed other token ids, and some of them miss the
bounds (cached_text at 1.46e-4 to 2.13e-4 for 3 of 16 hash seeds, and
live_text_int8 for about 1 in 14): both sides' tokenizers here map words
by crc32 instead (`_tokenizers`), and the live case takes seeded ids.

The reference setups are built once per module; torch runs one thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.math.timesteps import TimestepConfig as JaxTimestepConfig
from onetrainer_tpu.math.timesteps import flux_mu_shift as jax_mu_shift
from onetrainer_tpu.math.timesteps import sample_timesteps_continuous as jax_continuous
from onetrainer_tpu.models import flux as jax_flux
from onetrainer_tpu.setup import flux_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import SDTokenizer, T5TokenizerWrapper
from onetrainer_tpu.train.sd_train_step import conditioning_dropout_mask as jax_keep
from onetrainer_tpu.util.enums import DataType, ModelType, TimestepDistribution, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.weights import flux_params_from_flax, lora_params_from_jax
from onetrainer_tpu_torch.math import timesteps as pt_timesteps
from onetrainer_tpu_torch.models import clip as pt_clip
from onetrainer_tpu_torch.models import flux as pt_flux
from onetrainer_tpu_torch.models import t5 as pt_t5
from onetrainer_tpu_torch.models import vae as pt_vae
from onetrainer_tpu_torch.models.flux_model import FluxModel
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.setup.tokenizer import T5TokenizerWrapper as PortT5Tokenizer
from onetrainer_tpu_torch.train.train_state import param_groups
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_flux import tiny_flux_config, tiny_flux_model
from tests.test_torch_port_inpaint import crc32_words
from tests.test_torch_port_models import _port_config, _random_like
from tests.test_torch_port_train_sdxl import (
    CACHE_ATOL, PROMPTS, QLORA_REL, REL, SEED, STEPS, _assert_matches_reference, _rel,
)

ATOL = RTOL = 1e-4
ROPE_ATOL = 1.2e-7
T5_LENGTH = 12
DROPOUT = 0.5
GUIDANCE = 3.5


def _tokenizers(clip_cls, t5_cls):
    """Both sides' no-file tokenizers with crc32 word ids in place of the
    salted-hash fallback, so the cached text is the same in every process."""
    return (crc32_words(clip_cls(None, max_length=16, vocab_size=100, bos=98, eos=99)),
            crc32_words(t5_cls(None, max_length=T5_LENGTH, vocab_size=110)))


def port_flux_like(jax_model, device="cpu", **transformer_overrides) -> FluxModel:
    """The port's FLUX with the reference model's (tiny) configs."""
    tcfg = dataclasses.replace(
        _port_config(pt_flux.FluxConfig, jax_model.transformer_config),
        **transformer_overrides)
    return FluxModel(
        model_type=pt_enums.ModelType(jax_model.model_type.value),
        transformer_config=tcfg,
        vae_config=_port_config(pt_vae.VAEConfig, jax_model.vae_config),
        te_config=_port_config(pt_clip.CLIPTextConfig, jax_model.te_config),
        te2_config=_port_config(pt_t5.T5Config, jax_model.te2_config),
        device=device)


def random_flux_params(port, seed: int = 1) -> tuple:
    """Seeded weights for every parameter of the port's FLUX, as the
    reference's flax trees (numpy): (transformer, te, te2, vae)."""
    rng = np.random.default_rng(seed)
    sd = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
          for name, m in port.modules().items()}
    return (jax_tf.unet_state_dict_to_flax(sd["transformer"]),
            jax_tf.clip_state_dict_to_flax(sd["text_encoder"]),
            jax_tf.t5_state_dict_to_flax(sd["text_encoder_2"]),
            jax_tf.vae_state_dict_to_flax(sd["vae"]))


def tiny_flux_pair(seed: int = 1, **transformer_overrides):
    """(the reference's tiny FLUX with weights, its flax params as numpy,
    the port's model with the same configs and weights)."""
    jax_model = tiny_flux_model()
    port = port_flux_like(jax_model, **transformer_overrides)
    params = random_flux_params(port, seed)
    flux_params_from_flax(port, *params)
    (jax_model.transformer_params, jax_model.te_params, jax_model.te2_params,
     jax_model.vae_params) = jax.tree.map(jnp.asarray, params)
    jax_model.tokenizer, jax_model.tokenizer_2 = _tokenizers(SDTokenizer, T5TokenizerWrapper)
    port.tokenizer, port.tokenizer_2 = _tokenizers(PortSDTokenizer, PortT5Tokenizer)
    return jax_model, params, port


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(port: torch.Tensor, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


def test_packing_ids_and_rope_match_jax():
    rng = np.random.default_rng(2)
    latents = rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
    packed = pt_flux.pack_latents(torch.from_numpy(latents))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_flux.pack_latents(latents)))
    np.testing.assert_array_equal(pt_flux.unpack_latents(packed, 8, 6).numpy(), latents)
    np.testing.assert_array_equal(
        np.asarray(jax_flux.unpack_latents(jnp.asarray(packed.numpy()), 8, 6)), latents)
    # FLUX.1-dev's grid at 1024x1024 and a ragged one
    for h, w in ((128, 128), (8, 6)):
        np.testing.assert_array_equal(pt_flux.prepare_latent_image_ids(h, w).numpy(),
                                      np.asarray(jax_flux.prepare_latent_image_ids(h, w)))
    # text rows (zero ids) first, then the 64x64 image grid, FLUX.1-dev's axes
    ids = np.concatenate([np.zeros((77, 3), np.float32),
                          np.asarray(jax_flux.prepare_latent_image_ids(128, 128))])
    for axes in ((16, 56, 56), (4, 6, 6)):
        want = jax_flux.rope_tables(jnp.asarray(ids), axes, 10000.0)
        got = pt_flux.rope_tables(torch.from_numpy(ids), axes, 10000.0)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (4173, sum(axes)) and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ROPE_ATOL, rtol=0)
    cos, sin = (np.array(t) for t in jax_flux.rope_tables(jnp.asarray(ids[:300]),
                                                           (4, 6, 6), 10000.0))
    x = rng.standard_normal((2, 300, 3, 16)).astype(np.float32)
    want = jax_flux.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = pt_flux.apply_rope(*map(torch.from_numpy, (x, cos, sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _forward_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16)).astype(np.float32),
            np.asarray([0.25, 0.9], np.float32),
            rng.standard_normal((2, 20)).astype(np.float32),
            rng.standard_normal((2, 6, 24)).astype(np.float32),
            np.asarray(jax_flux.prepare_latent_image_ids(8, 8)))


@pytest.mark.parametrize("guidance", [True, False], ids=["guidance", "no_guidance"])
def test_transformer_forward_matches_jax(guidance):
    jax_cfg = tiny_flux_config(guidance_embeds=guidance)
    jax_model = tiny_flux_model()
    jax_model.transformer_config = jax_cfg
    port = port_flux_like(jax_model)
    params = random_flux_params(port, seed=2)
    flux_params_from_flax(port, *params)
    sd = port.transformer.state_dict()
    assert ("time_text_embed.guidance_embedder.linear_1.weight" in sd) is guidance
    assert "transformer_blocks.0.attn.norm_added_k.weight" in sd
    assert "single_transformer_blocks.1.proj_out.weight" in sd
    args = [np.array(a) for a in _forward_inputs()]
    g = np.asarray([3.5, 1.0], np.float32)
    want = jax_flux.FluxTransformer2D(jax_cfg).apply(
        {"params": params[0]}, *map(jnp.asarray, args), None, jnp.asarray(g))
    with torch.no_grad():
        got = port.transformer(*map(torch.from_numpy, args), None, torch.from_numpy(g))
    assert got.shape == (2, 16, 16) and got.dtype == torch.float32
    _close(got, want)


def test_mu_shift_and_continuous_timesteps_match_jax():
    for w, h in ((128, 128), (64, 96), (4, 4)):
        assert pt_timesteps.flux_mu_shift(w, h) == jax_mu_shift(w, h)
    n = 20000
    for dist, shift in ((TimestepDistribution.UNIFORM, 1.0),
                        (TimestepDistribution.LOGIT_NORMAL, jax_mu_shift(128, 128))):
        jcfg = JaxTimestepConfig(distribution=dist, timestep_shift=shift)
        pcfg = pt_timesteps.TimestepConfig(
            distribution=pt_enums.TimestepDistribution(dist.value), timestep_shift=shift)
        want = np.asarray(jax_continuous(jax.random.PRNGKey(0), n, jcfg))
        got = pt_timesteps.sample_timesteps_continuous(
            torch.Generator().manual_seed(0), n, pcfg).numpy()
        for t in (got, want):
            assert t.dtype == np.float32 and t.min() > 0.0 and t.max() <= 1.0
            np.testing.assert_array_equal(np.round(t * 10000) / 10000, t)
        sigma = np.sqrt(want.var() / n + got.var() / n)
        assert abs(got.mean() - want.mean()) <= 5 * sigma
        hist = [np.histogram(t, bins=10, range=(0, 1))[0] / n for t in (got, want)]
        assert np.abs(hist[0] - hist[1]).max() <= 0.02
    assert pt_timesteps.sample_timesteps_continuous(
        torch.Generator(), 3, pcfg, deterministic=True).tolist() == [0.5] * 3


@pytest.mark.parametrize("preset", [None, "attn-mlp", "attn-only", "full"])
def test_lora_presets_and_kohya_keys_match_jax(preset):
    """Each `lora_layer_preset` adapts the layers the reference's does, and
    the adapters' kohya file (prefix `lora_transformer`) has the
    reference's keys and tensors exactly and reads back to them."""
    from onetrainer_tpu.peft import lora as jax_lora
    from onetrainer_tpu_torch.peft import lora as pt_lora
    from onetrainer_tpu_torch.setup.flux_setup import flux_peft_config
    config, port_config = _configs(False)
    config.lora_layer_preset = port_config.lora_layer_preset = preset
    jax_model, params, port = tiny_flux_pair()
    jax_cfg = jax_lora.PeftConfig.from_train_config(config)
    if preset in jax_setup.FLUX_LORA_PRESETS:
        jax_cfg = dataclasses.replace(jax_cfg,
                                      layer_filter=jax_setup.FLUX_LORA_PRESETS[preset])
    pt_cfg = flux_peft_config(port_config)
    assert pt_cfg.layer_filter == jax_cfg.layer_filter
    keys = pt_lora.peft_module_keys(port.transformer, pt_cfg)
    assert sorted(keys) == sorted(jax_lora.peft_module_keys(params[0], jax_cfg))
    adapters = jax.device_get(jax_lora.init_peft_params(jax.random.PRNGKey(0), params[0],
                                                        jax_cfg))
    rng = np.random.default_rng(7)
    for entry in adapters.values():   # a non-zero up, as after training
        entry["lora_up"] = rng.standard_normal(entry["lora_up"].shape).astype(np.float32)
    carried = lora_params_from_jax(adapters, device="cpu")
    want = jax_lora.peft_to_kohya_state_dict(adapters, jax_cfg, "lora_transformer")
    got = pt_lora.peft_to_kohya_state_dict(carried, pt_cfg, "lora_transformer")
    assert set(got) == set(want) and len(got) == 3 * len(keys)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    back, alpha = pt_lora.kohya_state_dict_to_peft(got, "lora_transformer", keys)
    assert alpha == 8.0 and set(back) == set(carried)
    for key, entry in carried.items():
        for name, value in entry.items():
            assert torch.equal(back[key][name], value), key


# -- two LoRA steps through the setups ---------------------------------------------

_CASES = {"cached_text": (False, DataType.FLOAT_32), "live_text_int8": (True, DataType.INT_8),
          "cached_text_nf4": (False, DataType.NFLOAT_4)}


def _configs(train_te: bool, base_dtype=DataType.FLOAT_32):
    config = TrainConfig.default_values()
    config.model_type = ModelType.FLUX_DEV_1
    config.training_method = TrainingMethod.LORA
    config.batch_size = 2
    config.lora_rank = 4
    config.lora_alpha = 8.0
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.dynamic_timestep_shifting = True
    config.prior.train = True
    config.prior.guidance_scale = GUIDANCE
    config.prior.weight_dtype = base_dtype
    config.text_encoder.train = train_te
    for part in (config.text_encoder, config.text_encoder_2):
        part.dropout_probability = DROPOUT
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _images():
    rng = np.random.default_rng(SEED)
    return rng.uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)


def _batch(encode_images, encode_text, images, as_array):
    batch = {name: as_array(value) for name, value in encode_images(images).items()}
    texts = [encode_text(p) for p in PROMPTS]
    for name in texts[0]:
        batch[name] = as_array(np.stack([np.asarray(t[name]) for t in texts]))
    batch["loss_weight"] = as_array(np.ones((2,), np.float32))
    return batch


def _seeded_tokens() -> dict:
    """The live-text case's token rows, drawn from the test's numpy seed
    in the tokenizers' layouts: CLIP (BOS, one id per prompt word, EOS
    padding) and T5 (the ids, EOS, PAD padding)."""
    rng = np.random.default_rng(SEED)
    clip = np.full((2, 16), 99, np.int32)
    clip[:, 0] = 98
    t5 = np.zeros((2, T5_LENGTH), np.int32)
    for i, prompt in enumerate(PROMPTS):
        n = len(prompt.split())
        clip[i, 1:1 + n] = rng.integers(1, 98, n)
        t5[i, :n] = rng.integers(2, 110, n)
        t5[i, n] = 1
    return {"tokens": clip, "tokens_2": t5}


def _jax_draws(step_cfg, batch, rng, step):
    """The draws of the reference's step `step` (its own key splits):
    flux_predict's t, noise and latent-sampling noise, and the CLIP and T5
    keep masks from fold_in(rng_predict, 0xd0)."""
    from onetrainer_tpu.math.noise import create_noise as jax_noise
    rng_loss, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, rng_predict = jax.random.split(rng_loss)
    rng_t, rng_noise, rng_sample = jax.random.split(rng_predict, 3)
    latent = batch["latent_image"]
    b, h, w, _ = latent.shape
    tcfg = dataclasses.replace(step_cfg.timestep, dynamic_timestep_shifting=False,
                               timestep_shift=jax_mu_shift(w, h))
    drop = jax.random.fold_in(rng_predict, 0xd0)
    return {
        "timestep": np.asarray(jax_continuous(rng_t, b, tcfg)),
        "noise": np.asarray(jax_noise(rng_noise, latent.shape, latent.dtype)),
        "latent_noise": np.asarray(jax.random.normal(rng_sample, latent.shape,
                                                     latent.dtype)),
        "dropout_keep": tuple(np.asarray(jax_keep(jax.random.fold_in(drop, i + 1), b, p))
                              for i, p in enumerate((step_cfg.te_dropout,
                                                     step_cfg.te2_dropout))),
    }


def _reference(case: str) -> dict:
    train_te, base_dtype = _CASES[case]
    jax_model, params, _ = tiny_flux_pair()
    config, port_config = _configs(train_te, base_dtype)
    setup = jax_setup.create_flux_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    images = _images()
    encode_images, encode_text = jax_setup.make_flux_encode_fns(setup)
    batch = _batch(encode_images, encode_text, images, jnp.asarray)
    if train_te:
        assert set(_seeded_tokens()) <= set(batch)
        batch.update(_seeded_tokens())
    batch = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = _jax_draws(setup.step_cfg, batch, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(case=case, train_te=train_te, params=params, init=init, images=images,
                batch=jax.device_get(batch), steps=steps, port_config=port_config)


_REFERENCES: dict = {}


def _reference_once(case: str) -> dict:
    if case not in _REFERENCES:
        _REFERENCES[case] = _reference(case)
    return _REFERENCES[case]


@pytest.fixture(scope="module", params=list(_CASES))
def reference(request):
    return _reference_once(request.param)


def _port_setup(ref, **transformer_overrides):
    """The port's setup through the registry, with the reference's initial
    adapters, and its own cached batch (held to the reference's)."""
    port = port_flux_like(tiny_flux_model(), **transformer_overrides)
    flux_params_from_flax(port, *ref["params"])
    port.tokenizer, port.tokenizer_2 = _tokenizers(PortSDTokenizer, PortT5Tokenizer)
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
    batch = _batch(encode_images, encode_text, torch.from_numpy(ref["images"]),
                   torch.as_tensor)
    if ref["train_te"]:
        batch.update({k: torch.from_numpy(v) for k, v in _seeded_tokens().items()})
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
    from onetrainer_tpu_torch.ops.quant import NF4Array, QuantizedArray
    ref = reference
    setup, batch = _port_setup(ref)
    assert setup.step_cfg.vae_shift_factor == pytest.approx(0.1159)
    assert set(setup.state.params) == ({"transformer_lora", "te_lora"} if ref["train_te"]
                                       else {"transformer_lora"})
    assert ("t5_hidden_state" in batch) is not ref["train_te"]
    base = {"cached_text": torch.Tensor, "live_text_int8": QuantizedArray,
            "cached_text_nf4": NF4Array}[ref["case"]]
    # the quantize policy's smallest kernel is 4096 elements: norm1.linear
    # (32 x 192) is quantized here, the 32 x 32 projections are not
    assert isinstance(setup.model.transformer.transformer_blocks[0].norm1.linear.weight, base)
    # the replayed masks drop some samples' text and keep others'
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


@pytest.mark.parametrize("policy", ["full", "dots_nb_attn"])
def test_checkpoint_policies_give_the_gradients_of_no_checkpointing(policy):
    """One step's LoRA gradients under each ported policy against the same
    step without checkpointing, on the reference's first draws (text
    cached, fp32 base)."""
    reference = _reference_once("cached_text")
    draws = _draws(reference["steps"][0])

    def grads(**overrides):
        setup, batch = _port_setup(reference, **overrides)
        flat = [t.requires_grad_() for g in param_groups(setup.state.params).values()
                for t in g]
        loss = setup.train_step.loss(batch, None, **draws)
        return torch.cat([g.flatten() for g in torch.autograd.grad(loss, flat)])

    plain = grads()
    ckpt = grads(gradient_checkpointing=True, remat_policy=policy)
    assert _rel(ckpt.numpy(), plain.numpy()) <= 1e-6


def test_unported_remat_policy_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        port_flux_like(tiny_flux_model(), gradient_checkpointing=True, remat_policy="dots")
