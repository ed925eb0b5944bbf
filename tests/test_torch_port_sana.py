"""Parity of the torch port's Sana slice with the reference
(onetrainer_tpu/models/gemma.py, dcae.py, sana.py, setup/sana_setup.py,
train/sana_train_step.py, sampling/sana_sampler.py,
io/sana_checkpoints.py and the trainer).

Both sides run tests/test_trainer_sana.py's tiny Sana (two blocks, hidden
32 in four linear heads of 8, two cross heads of 16, caption 24, 8 latent
channels; a two-layer Gemma-2 24 wide with two heads over one kv head; a
three-stage DC-AE whose last stage is EfficientViT) in fp32 with the same
seeded weights (the port's state dicts through the reference's key maps,
then `io.weights.sana_params_from_flax`). Word ids come from crc32
(tests/test_torch_port_inpaint.py:crc32_words); the Gemma window is 12
tokens, so prompts leave padding the keep mask drops. At hidden 32 the
time embedding's layers (256 x 32, 32 x 192) and GLUMBConv's expansion
(32 x 160) pass the 4096-element quantization floor, so the NF4 base
really quantizes.

Tolerances: Gemma's hidden states (soft-capping at the published 50 and
at 0.5, where it bites), DC-AE's encode and decode and the transformer
(with a keep mask, without one, and with a sample whose mask drops every
token) 1e-4 absolute plus 1e-4 relative (fp32 networks summed in another
order); the QLoRA steps (NF4 transformer, bf16 adapters, stochastic
rounding on the reference's bits, Gemma dropout 0.4 on the reference's
keep masks, which zero a sample's states and its mask) as
tests/test_torch_port_train_sdxl.py holds its QLoRA steps; the EMBEDDING
steps (Gemma input and output embeddings) as
tests/test_torch_port_embedding.py holds its steps; the sampler's final
latents 1e-4 absolute plus 1e-4 relative and the image within 2 levels;
the diffusers directory both ways exactly (F20, F22: ROADMAP queue 3); the
train command against the reference trainer by its statuses, steps and
output keys, shapes and dtypes.

The reference's runs are built once per module; torch runs one thread.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.concept_config import ConceptConfig
from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import sana_checkpoints as jax_io
from onetrainer_tpu.io.safetensors_io import save_safetensors as jax_save
from onetrainer_tpu.math.noise import create_noise as jax_noise
from onetrainer_tpu.math.timesteps import sample_timesteps_discrete as jax_timesteps
from onetrainer_tpu.models import gemma as jax_gemma
from onetrainer_tpu.models.dcae import AutoencoderDC as JaxDCAE
from onetrainer_tpu.ops.quant import quantize_tree
from onetrainer_tpu.sampling.sana_sampler import sample_sana as jax_sample
from onetrainer_tpu.sampling.sd_sampler import sample_rng_for
from onetrainer_tpu.setup import sana_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import GemmaTokenizerWrapper
from onetrainer_tpu.train.sd_train_step import conditioning_dropout_mask as jax_keep
from onetrainer_tpu.trainer.generic_trainer import GenericTrainer as JaxTrainer
from onetrainer_tpu.util.callbacks import TrainCallbacks as JaxCallbacks
from onetrainer_tpu.util.enums import DataType, ModelType, TimeUnit, TrainingMethod
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io import sana_checkpoints as pt_io
from onetrainer_tpu_torch.io.safetensors_io import SafetensorsFile, load_safetensors
from onetrainer_tpu_torch.io.weights import lora_params_from_jax, sana_params_from_flax
from onetrainer_tpu_torch.models import dcae as pt_dcae
from onetrainer_tpu_torch.models import gemma as pt_gemma
from onetrainer_tpu_torch.models import sana as pt_sana
from onetrainer_tpu_torch.models.sana_model import SanaModel
from onetrainer_tpu_torch.ops import quant as pt_quant
from onetrainer_tpu_torch.sampling import sana_sampler as pt_sampler
from onetrainer_tpu_torch.scripts import train as pt_train
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import GemmaTokenizerWrapper as PortGemmaTokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
from tests import test_torch_port_embedding as emb_t
from tests.test_data import make_dataset
from tests.test_torch_port_inpaint import crc32_words
from tests.test_torch_port_models import _port_config, _random_like
from tests.test_torch_port_pixart import _port_draws
from tests.test_torch_port_sd3_sample import _DecodeRecorder
from tests.test_torch_port_train_sdxl import (
    CACHE_ATOL, QLORA_NORM_REL, QLORA_REL, REL, SEED, STEPS, _assert_matches_reference,
    _jax_round_bits,
)
from tests.test_trainer_sana import tiny_sana_model

ATOL = RTOL = 1e-4
DROPOUT = 0.4   # the reference draws keep masks [0, 1] then [1, 1]
TOKENS = 12
SIZE = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokenizer(cls):
    return crc32_words(cls(None, max_length=TOKENS, vocab_size=120))


def port_sana_like(jax_model, device="cpu") -> SanaModel:
    """The port's Sana with the reference model's (tiny) configs."""
    return SanaModel(
        model_type=pt_enums.ModelType(jax_model.model_type.value),
        transformer_config=_port_config(pt_sana.SanaConfig, jax_model.transformer_config),
        vae_config=_port_config(pt_dcae.DCAEConfig, jax_model.vae_config),
        te_config=_port_config(pt_gemma.Gemma2Config, jax_model.te_config),
        device=device)


def tiny_sana_pair(seed: int = 1, te_overrides=None):
    """(the reference's tiny Sana with weights, its flax params as numpy,
    the port's model with the same configs and weights)."""
    jax_model = tiny_sana_model()
    if te_overrides:
        jax_model.te_config = dataclasses.replace(jax_model.te_config, **te_overrides)
    port = port_sana_like(jax_model)
    rng = np.random.default_rng(seed)
    sd = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
          for name, m in port.modules().items()}
    params = (jax_io.sana_state_dict_to_flax(sd["transformer"]),
              jax_io.gemma_state_dict_to_flax(sd["text_encoder"]),
              jax_io.dcae_state_dict_to_flax(sd["vae"]))
    sana_params_from_flax(port, *params)
    jax_model.transformer_params, jax_model.te_params, jax_model.vae_params = \
        jax.tree.map(jnp.asarray, params)
    jax_model.tokenizer = _tokenizer(GemmaTokenizerWrapper)
    port.tokenizer = _tokenizer(PortGemmaTokenizer)
    return jax_model, params, port


# tests/test_trainer_sana.py:write_tiny_sana_checkpoint's configs
_CONFIGS = {
    "transformer": {"in_channels": 8, "out_channels": 8, "num_layers": 2,
                    "num_attention_heads": 4, "attention_head_dim": 8,
                    "num_cross_attention_heads": 2, "cross_attention_head_dim": 16,
                    "caption_channels": 24, "patch_size": 1},
    "vae": {"in_channels": 3, "latent_channels": 8,
            "encoder_block_out_channels": [8, 16, 16],
            "decoder_block_out_channels": [8, 16, 16],
            "encoder_layers_per_block": [1, 1, 1], "decoder_layers_per_block": [1, 1, 1],
            "encoder_block_types": ["ResBlock", "ResBlock", "EfficientViTBlock"],
            "attention_head_dim": 8, "scaling_factor": 0.41407},
    "text_encoder": {"vocab_size": 120, "hidden_size": 24, "intermediate_size": 48,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "num_key_value_heads": 1, "head_dim": 12, "query_pre_attn_scalar": 12.0},
}


def write_sana_dir(base: str, params) -> None:
    """A diffusers directory of the tiny Sana's flax `params` (transformer,
    Gemma, DC-AE) through the reference's key maps, as
    tests/test_trainer_sana.py:write_tiny_sana_checkpoint writes one,
    without its flax init."""
    transformer, te, vae = params
    for name, sd, weights in (
            ("transformer", jax_io.sana_flax_to_state_dict(transformer),
             "diffusion_pytorch_model"),
            ("vae", jax_io.dcae_flax_to_state_dict(vae), "diffusion_pytorch_model"),
            ("text_encoder", jax_io.gemma_flax_to_state_dict(te), "model")):
        os.makedirs(os.path.join(base, name), exist_ok=True)
        jax_save(os.path.join(base, name, f"{weights}.safetensors"),
                 {k: np.asarray(v) for k, v in sd.items()})
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(_CONFIGS[name], f)


def _close(port: torch.Tensor, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol)


# -- Gemma-2, DC-AE and the transformer --------------------------------------------------

@pytest.mark.parametrize("softcap", [50.0, 0.5], ids=["published_cap", "biting_cap"])
def test_gemma_matches_jax(softcap):
    """Every hidden state under a padded mask, the post-norm output, and a
    layer-skipped state through the final norm."""
    jax_model, params, port = tiny_sana_pair(te_overrides={"attn_logit_softcapping": softcap})
    tokens = np.stack([jax_model.tokenizer("a red cube on a wooden table"),
                       jax_model.tokenizer("a photograph")])
    mask = jax_model.tokenizer.mask(tokens[0])[None].repeat(2, 0)
    mask[1] = jax_model.tokenizer.mask(tokens[1])
    assert mask.min() == 0
    want = jax.jit(lambda p, t, m: jax_model.text_encoder.apply({"params": p}, t, m))(
        jax_model.te_params, jnp.asarray(tokens), jnp.asarray(mask))
    with torch.no_grad():
        got = port.text_encoder(torch.from_numpy(tokens), torch.from_numpy(mask))
        assert len(got["hidden_states"]) == len(want["hidden_states"]) == 3
        for a, b in zip(got["hidden_states"], want["hidden_states"]):
            _close(a, b)
        skipped = pt_gemma.apply_gemma_final_norm(
            port.text_encoder, pt_gemma.encode_gemma_text(got, 1))
    _close(skipped, jax_gemma.apply_gemma_final_norm(
        jax_model.te_params, jax_gemma.encode_gemma_text(want, 1)))


def test_dcae_encode_and_decode_match_jax():
    jax_model, _, port = tiny_sana_pair()
    images = np.random.default_rng(2).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    vae = JaxDCAE(jax_model.vae_config)
    want_z, want_x = jax.jit(lambda p, x: (
        vae.apply({"params": p}, x, method=JaxDCAE.encode),
        vae.apply({"params": p}, vae.apply({"params": p}, x, method=JaxDCAE.encode),
                  method=JaxDCAE.decode)))(jax_model.vae_params, jnp.asarray(images))
    with torch.no_grad():
        z = port.vae.encode(torch.from_numpy(images))
        x = port.vae.decode(torch.from_numpy(np.asarray(want_z)))
    assert z.shape == (2, SIZE // 4, SIZE // 4, 8) and x.dtype == torch.float32
    _close(z, want_z)
    _close(x, want_x)


_MASKS = {"keep_mask": [[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]],
          "no_mask": None,
          "dropped_sample": [[1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0]]}


@pytest.mark.parametrize("case", list(_MASKS))
def test_transformer_forward_matches_jax(case):
    jax_model, _, port = tiny_sana_pair()
    rng = np.random.default_rng(3)
    latents = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    timestep = np.asarray([3, 700], np.int32)
    context = rng.standard_normal((2, 6, 24)).astype(np.float32)
    mask = None if _MASKS[case] is None else np.asarray(_MASKS[case], np.int32)
    args = [latents, timestep, context] + ([] if mask is None else [mask])
    want = jax.jit(lambda p, *a: jax_model.transformer.apply({"params": p}, *a))(
        jax_model.transformer_params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = port.transformer(*map(torch.from_numpy, args))
    assert got.shape == (2, 8, 8, 8) and got.dtype == torch.float32
    _close(got, want)


# -- two QLoRA steps through the setups ------------------------------------------------

def _configs():
    config = TrainConfig.default_values()
    config.model_type = ModelType.SANA
    config.training_method = TrainingMethod.LORA
    config.batch_size = 2
    config.lora_rank = 4
    config.lora_alpha = 8.0
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.prior.train = True
    config.prior.weight_dtype = DataType.NFLOAT_4
    config.lora_weight_dtype = DataType.BFLOAT_16
    config.optimizer.stochastic_rounding = True
    config.text_encoder.train = False
    config.text_encoder.dropout_probability = DROPOUT
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _images():
    return np.random.default_rng(SEED).uniform(-1.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)


def jax_sana_draws(step_cfg, batch, rng, step):
    """The draws of the reference's Sana step `step` (its own key splits):
    sana_predict's timesteps and noise, and Gemma's keep mask from
    fold_in(rng_predict, 0xd0)."""
    rng_loss, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, rng_predict = jax.random.split(rng_loss)
    rng_t, rng_noise = jax.random.split(rng_predict)
    latent = batch["latent_image"]
    b = latent.shape[0]
    keep = np.asarray(jax_keep(jax.random.fold_in(rng_predict, 0xd0), b, step_cfg.te_dropout)) \
        if step_cfg.te_dropout > 0 else None
    return {
        "timestep": np.asarray(jax_timesteps(rng_t, b, step_cfg.timestep,
                                             num_train_timesteps=step_cfg.num_train_timesteps)),
        "noise": np.asarray(jax_noise(rng_noise, latent.shape, latent.dtype)),
        "dropout_keep": (keep,),
    }


def _batch(encode_images, encode_text, images, as_array):
    return emb_t.make_batch(encode_images, encode_text, images, as_array, emb_t._no_extra)


@pytest.fixture(scope="module")
def qlora_reference():
    jax_model, params, _ = tiny_sana_pair()
    config, port_config = _configs()
    jax_model.transformer_params = jax.jit(lambda tree: quantize_tree(tree, "nf4"))(
        jax_model.transformer_params)
    setup = jax_setup.create_sana_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    images = _images()
    encode_images, encode_text = jax_setup.make_sana_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, encode_text, images, jnp.asarray))
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = jax_sana_draws(setup.step_cfg, batch, rng, step)
        draws["round_bits"] = _jax_round_bits(state.params, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(init=init, images=images, batch=jax.device_get(batch), steps=steps,
                port_config=port_config, frozen=setup.frozen)


def test_qlora_steps_match_jax(qlora_reference):
    """QLoRA through both setups: the port's transformer quantized to the
    reference's NF4 codes and scales, bf16 adapters, two flow-matching
    steps on cached Gemma states under their keep masks (the first step
    drops one sample's states and mask), stochastic rounding on the
    reference's bits."""
    from onetrainer_tpu_torch.io.torch_flax import merge_int_tokens
    ref = qlora_reference
    _, _, port = tiny_sana_pair()
    family = get_family(ref["port_config"].model_type)
    setup = family.create_setup(port, ref["port_config"], 10)
    assert set(setup.state.params) == set(ref["init"]) == {"transformer_lora"}
    with torch.no_grad():
        for group, adapters in ref["init"].items():
            for key, entry in lora_params_from_jax(adapters, device="cpu").items():
                for name, value in entry.items():
                    setup.state.params[group][key][name].copy_(value)
    frozen = ref["frozen"]["transformer"]
    quantized = []
    for name, layer in port.transformer.named_modules():
        w = getattr(layer, "weight", None)
        if pt_quant.is_quantized(w):
            quantized.append(name)
            node = frozen
            for part in merge_int_tokens(jax_io.sana_torch_key_map(name + ".") + "kernel"):
                node = node[part]
            np.testing.assert_array_equal(w.q.numpy(), np.asarray(node.q), err_msg=name)
            np.testing.assert_array_equal(w.scales.numpy(), np.asarray(node.scales))
    assert "transformer_blocks.0.ff.conv_inverted" in quantized and len(quantized) == 4

    encode_images, encode_text = family.make_encode_fns(setup)
    batch = _batch(encode_images, encode_text, torch.from_numpy(ref["images"]), torch.as_tensor)
    assert set(batch) == set(ref["batch"]) == {"latent_image", "tokens", "tokens_mask",
                                               "text_encoder_hidden_state", "loss_weight"}
    for name, value in ref["batch"].items():
        if np.issubdtype(np.asarray(value).dtype, np.floating):
            np.testing.assert_allclose(batch[name].numpy(), value, atol=CACHE_ATOL, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(batch[name].numpy(), value, err_msg=name)
    assert not bool(batch["tokens_mask"].all())
    gen = torch.Generator().manual_seed(0)
    metrics = [{k: float(v) for k, v in setup.train_step(
        setup.state, batch, gen, **_port_draws(s)).items()} for s in ref["steps"]]
    _assert_matches_reference(ref, setup, metrics, params_rel=QLORA_REL,
                              norm_rel=QLORA_NORM_REL)


# -- two EMBEDDING steps ---------------------------------------------------------------

def test_embedding_steps_match_jax():
    """EMBEDDING of Gemma: the input vectors of `<emb>` and the output
    vector of `<out>` patched into Gemma's states, two steps with norm
    preservation against the reference's; the model stays bit for bit."""
    jax_model, _, port = tiny_sana_pair()
    config = emb_t.embedding_config(ModelType.SANA)
    setup = jax_setup.create_sana_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    assert set(init) == {"embeddings", "output_embeddings"}
    images = _images()
    encode_images, encode_text = jax_setup.make_sana_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, encode_text, images, jnp.asarray))
    steps = emb_t._jax_steps(setup, batch, jax_sana_draws)

    family = get_family(pt_enums.ModelType.SANA)
    psetup = family.create_setup(port, emb_t.port_config(config), 10)
    params = psetup.state.params
    assert set(params) == set(init)
    np.testing.assert_array_equal(params["embeddings"].numpy(), init["embeddings"])
    with torch.no_grad():
        np.testing.assert_allclose(params["output_embeddings"].numpy(),
                                   init["output_embeddings"], atol=emb_t.VECTOR_ATOL, rtol=0)
        params["output_embeddings"].copy_(torch.from_numpy(np.array(init["output_embeddings"])))
    encode_images, encode_text = family.make_encode_fns(psetup)
    pbatch = _batch(encode_images, encode_text, torch.from_numpy(images), torch.as_tensor)
    for name in ("tokens", "tokens_mask"):
        np.testing.assert_array_equal(pbatch[name].numpy(), np.asarray(batch[name]))
    frozen = emb_t._frozen_snapshot(psetup.model)
    gen = torch.Generator().manual_seed(0)
    for want in steps:
        got = psetup.train_step(psetup.state, pbatch, gen, **_port_draws(want))
        assert float(got["loss"]) == pytest.approx(want["loss"], rel=REL)
        assert float(got["grad_norm"]) == pytest.approx(want["grad_norm"], rel=REL)
    for group, value in steps[-1]["params"].items():
        assert emb_t._rel(params[group].detach().numpy().ravel(),
                          np.asarray(value).ravel()) <= REL, group
    after = emb_t._frozen_snapshot(psetup.model)
    assert all(torch.equal(after[k], v) for k, v in frozen.items())


# -- the sampler -----------------------------------------------------------------------

def test_sampler_matches_jax(monkeypatch):
    """Flow Euler with CFG 4.5 over three steps through the family's sample
    entry point, the port's one noise draw fed the reference's."""
    jax_model, _, port = tiny_sana_pair(seed=3)
    sc = SampleConfig.default_values()
    sc.prompt, sc.negative_prompt = "a red cube on a table", "blurry"
    sc.height = sc.width = SIZE
    sc.diffusion_steps = 3
    sc.cfg_scale = 4.5
    sc.seed = 11
    seen = []
    monkeypatch.setattr(type(jax_model), "vae", property(
        lambda self: _DecodeRecorder(JaxDCAE(self.vae_config), seen)))
    m = jax_model
    want = jax_sample(m, m.transformer_params, m.te_params, m.vae_params, m.tokenizer, sc)
    vc = m.vae_config
    _, noise_rng = jax.random.split(sample_rng_for(sc))
    initial = np.asarray(jax.random.normal(
        noise_rng, (1, SIZE // vc.spatial_scale, SIZE // vc.spatial_scale,
                    vc.latent_channels), jnp.float32))

    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.SANA
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    setup = family.create_setup(port, config, 1)
    assert setup.train_step is None
    monkeypatch.setattr(pt_sampler, "_initial_latents",
                        lambda shape, generator, device: torch.from_numpy(initial.copy()))
    port_seen = []
    decode = port.vae.decode
    monkeypatch.setattr(port.vae, "decode",
                        lambda z: port_seen.append(z.numpy().copy()) or decode(z))
    got = family.sample(setup, PortSampleConfig.default_values().from_dict(sc.to_dict()),
                        None)
    np.testing.assert_allclose(port_seen[0], seen[-1], atol=ATOL, rtol=RTOL)
    assert got.image.shape == want.image.shape == (SIZE, SIZE, 3)
    diff = np.abs(got.image.astype(np.int32) - want.image.astype(np.int32))
    assert diff.max() <= 2 and want.image.std() > 0


# -- the checkpoints -------------------------------------------------------------------

def _flat(tree, to_state_dict) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in to_state_dict(jax.device_get(tree)).items()}


def test_diffusers_directory_both_ways(tmp_path):
    """A directory the reference wrote loads into the port exactly (F20:
    its caption projection under `caption_projection_linear.N`, renamed to
    diffusers' `caption_projection.linear_N`); the port's save, which
    writes diffusers' keys and the DC-AE (F22: the reference's writes no
    DC-AE weights), loads back into the reference exactly."""
    _, params, _ = tiny_sana_pair()
    base = str(tmp_path / "ref")
    write_sana_dir(base, params)
    with SafetensorsFile(os.path.join(base, "transformer",
                                      "diffusion_pytorch_model.safetensors")) as f:
        assert "caption_projection_linear.1.weight" in f.keys()   # F20
    ref = jax_io.load_sana_diffusers(base, device=False)
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.SANA
    config.train_dtype = pt_enums.DataType.FLOAT_32
    family = get_family(config.model_type)
    model = family.load(base, config, device="cpu")
    assert model.transformer_config == dataclasses.replace(_port_config(
        pt_sana.SanaConfig, ref["transformer_config"]), gradient_checkpointing=True)
    assert model.vae_config == _port_config(pt_dcae.DCAEConfig, ref["vae_config"])
    assert model.te_config == _port_config(pt_gemma.Gemma2Config, ref["te_config"])
    for name, tree, to_sd in (
            ("transformer", ref["transformer_params"], lambda t: pt_io.sana_transformer_state_dict(
                jax_io.sana_flax_to_state_dict(t))),
            ("text_encoder", ref["te_params"], jax_io.gemma_flax_to_state_dict),
            ("vae", ref["vae_params"], jax_io.dcae_flax_to_state_dict)):
        want = _flat(tree, to_sd)
        got = getattr(model, name).state_dict()
        assert set(got) == set(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    out = str(tmp_path / "port")
    pt_io.save_sana_diffusers(out, model, *(getattr(model, n).state_dict() for n in (
        "transformer", "vae", "text_encoder")), source_dir=base)
    with SafetensorsFile(os.path.join(out, "transformer",
                                      "diffusion_pytorch_model.safetensors")) as f:
        assert "caption_projection.linear_1.weight" in f.keys()
    back = jax_io.load_sana_diffusers(out, device=False)
    assert back["vae_params"] is not None   # F22: the reference's saver leaves it out
    for key in ("transformer_params", "te_params", "vae_params"):
        a_leaves, b_leaves = (jax.tree.leaves(x[key]) for x in (back, ref))
        assert len(a_leaves) == len(b_leaves)
        for a, b in zip(a_leaves, b_leaves):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert back["transformer_config"] == ref["transformer_config"]

    ref_out = str(tmp_path / "ref_out")
    jax_io.save_sana_diffusers(ref_out, None, ref["transformer_params"], ref["te_params"],
                               source_dir=base)
    assert not os.path.exists(os.path.join(ref_out, "vae", "diffusion_pytorch_model.safetensors"))


def test_single_file_export_raises():
    """Sana's single-file export raises, as the reference's does."""
    with pytest.raises(NotImplementedError):
        get_family(pt_enums.ModelType.SANA).save_single_file(None, "out.safetensors")


# -- the train command -----------------------------------------------------------------

def _trainer_config(root, name, base, ds) -> TrainConfig:
    config = TrainConfig.default_values()
    config.model_type = ModelType.SANA
    config.training_method = TrainingMethod.LORA
    config.base_model_name = base
    config.workspace_dir = os.path.join(root, name, "ws")
    config.cache_dir = os.path.join(root, name, "cache")
    config.epochs = 1
    config.batch_size = 2
    config.resolution = "32"
    config.aspect_ratio_bucketing = False
    config.lora_rank = 4
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.train_dtype = DataType.FLOAT_32
    config.output_dtype = DataType.BFLOAT_16
    config.tensorboard = False
    config.sample_after_unit = config.backup_after_unit = TimeUnit.NEVER
    config.save_every_unit = TimeUnit.NEVER
    config.samples = []
    config.prior.train = True
    config.text_encoder.train = False
    concept = ConceptConfig.default_values()
    concept.path = ds
    concept.seed = 3
    config.concepts = [concept]
    config.output_model_destination = os.path.join(root, name, "out.safetensors")
    config.backup_before_save = False
    return config


def test_train_command_matches_the_reference_trainer(tmp_path):
    """One LoRA epoch through `scripts/train.py` beside the reference's
    trainer on the same directory and dataset: the same statuses and
    steps, the same LoRA keys, shapes and dtypes."""
    root = str(tmp_path)
    base, ds = os.path.join(root, "ckpt"), make_dataset(os.path.join(root, "ds"), n=4)
    write_sana_dir(base, tiny_sana_pair()[1])
    ref_config = _trainer_config(root, "ref", base, ds)
    ref_statuses = []
    ref = JaxTrainer(ref_config, JaxCallbacks(on_update_status=ref_statuses.append))
    ref.start()
    ref.train()
    ref.end()
    port_config = _trainer_config(root, "port", base, ds)
    path = os.path.join(root, "port.json")
    with open(path, "w") as f:
        json.dump(port_config.to_dict(), f)
    statuses = []
    port = pt_train.main(["--config-path", path, "--device", "cpu"],
                         TrainCallbacks(on_update_status=statuses.append))
    assert statuses == ref_statuses
    assert port.train_progress.to_dict() == ref.train_progress.to_dict()
    assert port.train_progress.global_step == 2
    with SafetensorsFile(ref_config.output_model_destination) as r, \
            SafetensorsFile(port_config.output_model_destination) as p:
        assert sorted(p.keys()) == sorted(r.keys())
        assert any(k.startswith("lora_transformer_") for k in p.keys())
        for key in r.keys():
            assert (p.shape(key), p.dtype(key)) == (r.shape(key), r.dtype(key)), key
    lora = load_safetensors(port_config.output_model_destination)
    assert max(float(v.float().abs().max()) for k, v in lora.items()
               if k.endswith("lora_up.weight")) > 0
