"""Parity of the torch port's PixArt slice with the reference
(onetrainer_tpu/models/pixart.py, math/losses.py's VB term,
setup/pixart_setup.py, train/pixart_train_step.py,
sampling/pixart_sampler.py, io/pixart_checkpoints.py, io/single_file.py's
PixArt maps and the trainer).

Both sides run tests/test_pixart.py's tiny PixArt (two blocks of two d=16
heads, hidden 32, caption 24; a two-layer T5 24 wide; the two-level VAE)
in fp32 with the same seeded weights (the port's state dicts through the
reference's key maps, then `io.weights.pixart_params_from_flax`). Word ids
come from crc32 (tests/test_torch_port_inpaint.py:crc32_words). At hidden
32 the AdaLN projection (32 x 192) and the feed-forward's first layer
(32 x 128) pass the 4096-element quantization floor, so the NF4 base
really quantizes.

Tolerances: the transformer (α-1024 with its micro-conditions, and Σ)
1e-4 absolute plus 1e-4 relative (fp32 networks summed in another order);
the VB term and the whole loss stack with a mask 1e-5 relative; the QLoRA
steps (NF4 transformer, bf16 adapters, stochastic rounding on the
reference's bits, VB at strength 1, T5 dropout 0.4 on the reference's keep
masks) as tests/test_torch_port_train_sdxl.py holds its QLoRA steps (loss
REL, grad norm QLORA_NORM_REL, adapters QLORA_REL); the EMBEDDING steps
(T5 input and output embeddings) as tests/test_torch_port_embedding.py
holds its steps (REL); the sampler's final latents (up to ~100: random
weights) 1e-4 absolute plus 1e-4 relative and the image within 2 levels; the diffusers directory and the single file both
ways exactly. The train command's run against the reference trainer is
tests/test_torch_port_f19.py's PixArt case. F21 (ROADMAP queue 3):
the transformer takes no caption mask, so padding tokens move its output.

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

from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import pixart_checkpoints as jax_io
from onetrainer_tpu.io import single_file as jax_sf
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.io.safetensors_io import save_safetensors as jax_save
from onetrainer_tpu.math import losses as jax_losses
from onetrainer_tpu.math.noise import create_noise as jax_noise
from onetrainer_tpu.math.schedules import DiffusionScheduleCoefficients as JaxCoefficients
from onetrainer_tpu.math.timesteps import sample_timesteps_discrete as jax_timesteps
from onetrainer_tpu.models.vae import AutoencoderKL as JaxVAE
from onetrainer_tpu.ops.quant import quantize_tree
from onetrainer_tpu.sampling.pixart_sampler import sample_pixart as jax_sample
from onetrainer_tpu.sampling.sd_sampler import sample_rng_for
from onetrainer_tpu.setup import pixart_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import T5TokenizerWrapper
from onetrainer_tpu.train.sd_train_step import conditioning_dropout_mask as jax_keep
from onetrainer_tpu.util.enums import DataType, ModelType, TrainingMethod
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io import pixart_checkpoints as pt_io
from onetrainer_tpu_torch.io import single_file as pt_sf
from onetrainer_tpu_torch.io.weights import lora_params_from_jax, pixart_params_from_flax
from onetrainer_tpu_torch.math import losses as pt_losses
from onetrainer_tpu_torch.math.schedules import DiffusionScheduleCoefficients
from onetrainer_tpu_torch.models import pixart as pt_pixart
from onetrainer_tpu_torch.models import t5 as pt_t5
from onetrainer_tpu_torch.models import vae as pt_vae
from onetrainer_tpu_torch.models.pixart_model import PixArtAlphaModel
from onetrainer_tpu_torch.ops import quant as pt_quant
from onetrainer_tpu_torch.sampling import pixart_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import T5TokenizerWrapper as PortT5Tokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from tests import test_torch_port_embedding as emb_t
from tests.test_pixart import tiny_pixart_model
from tests.test_torch_port_inpaint import crc32_words
from tests.test_torch_port_models import _port_config, _random_like
from tests.test_torch_port_sd3_sample import _DecodeRecorder
from tests.test_torch_port_train_sdxl import (
    CACHE_ATOL, QLORA_NORM_REL, QLORA_REL, REL, SEED, STEPS,
    _assert_matches_reference, _jax_round_bits,
)

ATOL = RTOL = 1e-4
LOSS_RTOL = 1e-5
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
    return crc32_words(cls(None, max_length=TOKENS, vocab_size=110))


def port_pixart_like(jax_model, device="cpu") -> PixArtAlphaModel:
    """The port's PixArt with the reference model's (tiny) configs."""
    return PixArtAlphaModel(
        model_type=pt_enums.ModelType(jax_model.model_type.value),
        transformer_config=_port_config(pt_pixart.PixArtConfig, jax_model.transformer_config),
        vae_config=_port_config(pt_vae.VAEConfig, jax_model.vae_config),
        te_config=_port_config(pt_t5.T5Config, jax_model.te_config),
        device=device)


def tiny_pixart_pair(seed: int = 1, model_type=ModelType.PIXART_SIGMA, te_config=None,
                     **transformer_overrides):
    """(the reference's tiny PixArt with weights, its flax params as numpy,
    the port's model with the same configs and weights); `te_config`
    replaces the reference's tiny T5 config."""
    jax_model = tiny_pixart_model()
    jax_model.model_type = model_type
    jax_model.transformer_config = dataclasses.replace(jax_model.transformer_config,
                                                       **transformer_overrides)
    if te_config is not None:
        jax_model.te_config = te_config
    port = port_pixart_like(jax_model)
    rng = np.random.default_rng(seed)
    sd = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
          for name, m in port.modules().items()}
    params = (jax_tf.unet_state_dict_to_flax(sd["transformer"]),
              jax_tf.t5_state_dict_to_flax(sd["text_encoder"]),
              jax_tf.vae_state_dict_to_flax(sd["vae"]))
    pixart_params_from_flax(port, *params)
    jax_model.transformer_params, jax_model.te_params, jax_model.vae_params = \
        jax.tree.map(jnp.asarray, params)
    jax_model.tokenizer = _tokenizer(T5TokenizerWrapper)
    port.tokenizer = _tokenizer(PortT5Tokenizer)
    return jax_model, params, port


# tests/test_trainer_pixart.py:write_tiny_pixart_checkpoint's configs
_CONFIGS = {
    "transformer": {"sample_size": 8, "patch_size": 2, "in_channels": 4, "out_channels": 8,
                    "num_layers": 2, "num_attention_heads": 2, "attention_head_dim": 16,
                    "cross_attention_dim": 24, "caption_channels": 24},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [32, 64], "layers_per_block": 1, "scaling_factor": 0.18215},
    "text_encoder": {"vocab_size": 110, "d_model": 24, "d_kv": 6, "d_ff": 48,
                     "num_layers": 2, "num_heads": 4},
}


def write_pixart_dir(base: str, params) -> None:
    """A diffusers directory of the tiny PixArt's flax `params` (transformer,
    T5, VAE) through the reference's key maps, as
    tests/test_trainer_pixart.py:write_tiny_pixart_checkpoint writes one,
    without its flax init."""
    transformer, te, vae = params
    for name, sd, weights in (
            ("transformer", jax_tf.unet_flax_to_state_dict(transformer),
             "diffusion_pytorch_model"),
            ("vae", jax_tf.vae_flax_to_state_dict(vae), "diffusion_pytorch_model"),
            ("text_encoder", jax_tf.t5_flax_to_state_dict(te), "model")):
        os.makedirs(os.path.join(base, name), exist_ok=True)
        jax_save(os.path.join(base, name, f"{weights}.safetensors"),
                 {k: np.asarray(v) for k, v in sd.items()})
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(_CONFIGS[name], f)


def _apply(jax_model):
    """The reference transformer's apply, jitted (its op-by-op apply is
    slower than one compile)."""
    return jax.jit(lambda params, *args: jax_model.transformer.apply({"params": params}, *args))


def _close(port: torch.Tensor, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


# -- the transformer -------------------------------------------------------------------

_FORWARD = {"alpha_1024": dict(num_heads=3, use_additional_conditions=True),
            "sigma": {}}


@pytest.mark.parametrize("case", list(_FORWARD))
def test_transformer_forward_matches_jax(case):
    jax_model, params, port = tiny_pixart_pair(**_FORWARD[case])
    rng = np.random.default_rng(2)
    latents = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    timestep = np.asarray([3, 700], np.int32)
    context = rng.standard_normal((2, 6, 24)).astype(np.float32)
    resolution = np.asarray([[64.0, 64.0], [64.0, 96.0]], np.float32)
    aspect = np.asarray([[1.0], [1.5]], np.float32)
    want = _apply(jax_model)(jax_model.transformer_params, *map(jnp.asarray, (
        latents, timestep, context, resolution, aspect)))
    with torch.no_grad():
        got = port.transformer(*map(torch.from_numpy, (latents, timestep, context,
                                                         resolution, aspect)))
    assert got.shape == (2, 8, 8, 8) and got.dtype == torch.float32
    _close(got, want)
    if case == "alpha_1024":   # the micro-conditions reach the output
        with torch.no_grad():
            other = port.transformer(*map(torch.from_numpy, (
                latents, timestep, context, resolution * 2, aspect)))
        assert not torch.allclose(other, got)


def test_f21_transformer_takes_no_caption_mask():
    """F21 (ROADMAP queue 3): OneTrainer hands PixArt's transformer the T5
    attention mask; the reference's transformer takes none (its
    train/pixart_train_step.py:68), and neither does the port's: padding
    positions appended to the caption move the output on both sides
    alike."""
    jax_model, _, port = tiny_pixart_pair()
    rng = np.random.default_rng(4)
    latents = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    timestep = np.asarray([500], np.int32)
    context = rng.standard_normal((1, 4, 24)).astype(np.float32)
    padded = np.concatenate([context, np.zeros((1, 4, 24), np.float32)], axis=1)
    outs, apply = [], _apply(jax_model)
    for ctx in (context, padded):
        want = apply(jax_model.transformer_params, jnp.asarray(latents),
                     jnp.asarray(timestep), jnp.asarray(ctx))
        with torch.no_grad():
            got = port.transformer(torch.from_numpy(latents), torch.from_numpy(timestep),
                                   torch.from_numpy(ctx))
        _close(got, want)
        outs.append(got)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3


# -- the VB loss -----------------------------------------------------------------------

def test_vb_loss_matches_jax():
    """vb_losses elementwise (t = 0 takes the decoder NLL, the rest the KL),
    and the whole diffusion loss stack with MSE, VB at strength 0.7 and a
    latent mask, against the reference's; the VB term trains the variance
    values only (the eps prediction is detached)."""
    rng = np.random.default_rng(5)
    shape = (4, 8, 8, 4)
    betas = np.array(tiny_pixart_model().betas)
    jc = JaxCoefficients.from_betas(jnp.asarray(betas))
    pc = DiffusionScheduleCoefficients.from_betas(torch.from_numpy(betas))
    t = np.asarray([0, 1, 500, 999], np.int32)
    # x_t noised from x_0 on the schedule, the eps prediction near the true
    # noise; some x_0 past +-0.999 (the decoder NLL's edge branches)
    x0 = np.clip(0.6 * rng.standard_normal(shape), -1.2, 1.2).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    sac = np.asarray(jc.sqrt_alphas_cumprod)[t].reshape(-1, 1, 1, 1)
    xt = (sac * x0 + np.sqrt(1.0 - sac ** 2) * noise).astype(np.float32)
    eps = (noise + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    var = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    target = noise
    mask = (rng.uniform(size=(4, 8, 8, 1)) > 0.5).astype(np.float32)
    weight = np.asarray([1.0, 0.5, 2.0, 1.0], np.float32)
    want = jax_losses.vb_losses(jc, *map(jnp.asarray, (x0, xt, t, eps, var)))
    got = pt_losses.vb_losses(pc, *map(torch.from_numpy, (x0, xt, t, eps, var)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-6)

    data = {"predicted": eps, "target": target, "predicted_var_values": var,
            "scaled_latent_image": x0, "noisy_latent_image": xt, "timestep": t}
    batch = {"latent_mask": mask, "loss_weight": weight}
    jcfg = jax_losses.LossConfig(vb_loss_strength=0.7, masked_training=True,
                                 normalize_masked_area_loss=True)
    pcfg = pt_losses.LossConfig(vb_loss_strength=0.7, masked_training=True,
                                normalize_masked_area_loss=True)
    want = jax_losses.diffusion_losses(jax.tree.map(jnp.asarray, batch),
                                       jax.tree.map(jnp.asarray, data), jcfg, jc)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    tdata["predicted"].requires_grad_()
    tdata["predicted_var_values"].requires_grad_()
    got = pt_losses.diffusion_losses({k: torch.from_numpy(v) for k, v in batch.items()},
                                     tdata, pcfg, pc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=LOSS_RTOL)
    # the VB term alone: no gradient reaches the eps prediction
    vb = pt_losses.vb_losses(pc, *(tdata[k] for k in ("scaled_latent_image",
                                                       "noisy_latent_image", "timestep",
                                                       "predicted", "predicted_var_values")))
    g_eps, g_var = torch.autograd.grad(vb.sum(), [tdata["predicted"],
                                                  tdata["predicted_var_values"]],
                                       allow_unused=True)
    assert g_eps is None and float(g_var.abs().max()) > 0


# -- two QLoRA steps through the setups ------------------------------------------------

def _configs(method=TrainingMethod.LORA, base_dtype=DataType.NFLOAT_4):
    config = TrainConfig.default_values()
    config.model_type = ModelType.PIXART_SIGMA
    config.training_method = method
    config.batch_size = 2
    config.lora_rank = 4
    config.lora_alpha = 8.0
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.prior.train = True
    config.prior.weight_dtype = base_dtype
    config.lora_weight_dtype = DataType.BFLOAT_16
    config.optimizer.stochastic_rounding = True
    config.text_encoder.dropout_probability = DROPOUT
    config.vb_loss_strength = 1.0
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _images():
    return np.random.default_rng(SEED).uniform(-1.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)


def jax_pixart_draws(step_cfg, batch, rng, step):
    """The draws of the reference's PixArt step `step` (its own key
    splits): pixart_predict's timesteps, noise and latent-sampling noise,
    and T5's keep mask from fold_in(rng_predict, 0xd0)."""
    rng_loss, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, rng_predict = jax.random.split(rng_loss)
    rng_t, rng_noise, rng_sample = jax.random.split(rng_predict, 3)
    latent = batch["latent_image"]
    b = latent.shape[0]
    keep = np.asarray(jax_keep(jax.random.fold_in(rng_predict, 0xd0), b, step_cfg.te_dropout)) \
        if step_cfg.te_dropout > 0 else None
    return {
        "timestep": np.asarray(jax_timesteps(rng_t, b, step_cfg.timestep,
                                             num_train_timesteps=step_cfg.num_train_timesteps)),
        "noise": np.asarray(jax_noise(rng_noise, latent.shape, latent.dtype)),
        "latent_noise": np.asarray(jax.random.normal(rng_sample, latent.shape, latent.dtype)),
        "dropout_keep": (keep,),
    }


def _batch(encode_images, encode_text, images, as_array):
    return emb_t.make_batch(encode_images, encode_text, images, as_array, emb_t._no_extra)


@pytest.fixture(scope="module")
def qlora_reference():
    jax_model, params, _ = tiny_pixart_pair()
    config, port_config = _configs()
    jax_model.transformer_params = jax.jit(lambda tree: quantize_tree(tree, "nf4"))(
        jax_model.transformer_params)
    setup = jax_setup.create_pixart_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    images = _images()
    encode_images, encode_text = jax_setup.make_pixart_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, encode_text, images, jnp.asarray))
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = jax_pixart_draws(setup.step_cfg, batch, rng, step)
        draws["round_bits"] = _jax_round_bits(state.params, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(params=params, init=init, images=images, batch=jax.device_get(batch),
                steps=steps, port_config=port_config, frozen=setup.frozen)


def _port_draws(ref_step) -> dict:
    draws = {}
    for k, v in ref_step["draws"].items():
        if k == "round_bits":
            draws[k] = {g: {m: {n: torch.from_numpy(b) for n, b in e.items()}
                            for m, e in tree.items()} for g, tree in v.items()}
        elif k == "dropout_keep":
            draws[k] = tuple(None if m is None else torch.from_numpy(np.array(m)) for m in v)
        else:
            draws[k] = torch.from_numpy(np.array(v))
    return draws


def test_qlora_steps_match_jax(qlora_reference):
    """QLoRA through both setups: the port's transformer quantized to the
    reference's NF4 codes and scales, bf16 adapters, two steps with the VB
    term and T5 dropout, stochastic rounding on the reference's bits."""
    from onetrainer_tpu_torch.ops.nf4 import nf4_dequant_flat
    from onetrainer_tpu_torch.ops.sr_update import sr_update_leaves
    ref = qlora_reference
    _, _, port = tiny_pixart_pair()
    family = get_family(ref["port_config"].model_type)
    setup = family.create_setup(port, ref["port_config"], 10)
    assert set(setup.state.params) == set(ref["init"]) == {"transformer_lora"}
    with torch.no_grad():
        for group, adapters in ref["init"].items():
            for key, entry in lora_params_from_jax(adapters, device="cpu").items():
                for name, value in entry.items():
                    setup.state.params[group][key][name].copy_(value)
    assert all(t.dtype == torch.bfloat16 for e in setup.state.params["transformer_lora"].values()
               for t in e.values())
    frozen = ref["frozen"]["transformer"]
    quantized = 0
    for name, layer in port.transformer.named_modules():
        w = getattr(layer, "weight", None)
        if pt_quant.is_quantized(w):
            quantized += 1
            node = frozen
            for part in jax_tf.merge_int_tokens(name + ".kernel"):
                node = node[part]
            np.testing.assert_array_equal(w.q.numpy(), np.asarray(node.q), err_msg=name)
            np.testing.assert_array_equal(w.scales.numpy(), np.asarray(node.scales))
    # adaln_single.linear, the timestep embedder's linear_1 (256 x 32) and
    # each block's two feed-forward layers (32 x 128)
    assert quantized == 6

    encode_images, encode_text = family.make_encode_fns(setup)
    batch = _batch(encode_images, encode_text, torch.from_numpy(ref["images"]), torch.as_tensor)
    assert set(batch) == set(ref["batch"])
    for name, value in ref["batch"].items():
        if np.issubdtype(np.asarray(value).dtype, np.floating):
            np.testing.assert_allclose(batch[name].numpy(), value, atol=CACHE_ATOL, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(batch[name].numpy(), value, err_msg=name)
    keeps = [s["draws"]["dropout_keep"][0] for s in ref["steps"]]
    assert {0.0, 1.0} == set(np.concatenate(keeps).tolist())

    launches = (nf4_dequant_flat.launches, sr_update_leaves.launches)
    gen = torch.Generator().manual_seed(0)
    metrics = [{k: float(v) for k, v in setup.train_step(
        setup.state, batch, gen, **_port_draws(s)).items()} for s in ref["steps"]]
    assert (nf4_dequant_flat.launches, sr_update_leaves.launches) == launches
    _assert_matches_reference(ref, setup, metrics, params_rel=QLORA_REL,
                              norm_rel=QLORA_NORM_REL)


# -- two EMBEDDING steps ---------------------------------------------------------------

def test_embedding_steps_match_jax():
    """EMBEDDING of T5: the input vectors of `<emb>` and the output vector
    of `<out>` patched into T5's states, two steps with norm preservation,
    against the reference's setup and step; the model stays bit for bit."""
    jax_model, _, port = tiny_pixart_pair()
    config = emb_t.embedding_config(ModelType.PIXART_SIGMA)
    setup = jax_setup.create_pixart_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    assert set(init) == {"embeddings", "output_embeddings"}
    images = _images()
    encode_images, encode_text = jax_setup.make_pixart_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, encode_text, images, jnp.asarray))
    steps = emb_t._jax_steps(setup, batch, jax_pixart_draws)

    family = get_family(pt_enums.ModelType.PIXART_SIGMA)
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
    np.testing.assert_array_equal(pbatch["tokens_2"].numpy(), np.asarray(batch["tokens_2"]))
    assert "t5_hidden_state" not in pbatch
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
    """DDIM with CFG 4.5 over three steps through the family's sample
    entry point, the port's one noise draw fed the reference's."""
    jax_model, _, port = tiny_pixart_pair(seed=3)
    sc = SampleConfig.default_values()
    sc.prompt, sc.negative_prompt = "a red cube on a table", "blurry"
    sc.height = sc.width = SIZE
    sc.diffusion_steps = 3
    sc.cfg_scale = 4.5
    sc.seed = 11
    seen = []
    monkeypatch.setattr(type(jax_model), "vae", property(
        lambda self: _DecodeRecorder(JaxVAE(self.vae_config), seen)))
    m = jax_model
    want = jax_sample(m, m.transformer_params, m.te_params, m.vae_params, m.tokenizer, sc)
    vc = m.vae_config
    _, noise_rng = jax.random.split(sample_rng_for(sc))
    initial = np.asarray(jax.random.normal(
        noise_rng, (1, SIZE // vc.spatial_scale, SIZE // vc.spatial_scale,
                    vc.latent_channels), jnp.float32))

    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.PIXART_SIGMA
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = False
    family = get_family(config.model_type)
    setup = family.create_setup(port, config, 1)
    assert setup.train_step is None
    port.tokenizer.max_length = TOKENS
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

def _flat_state(tree, to_state_dict) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in to_state_dict(jax.device_get(tree)).items()}


def test_diffusers_directory_both_ways(tmp_path):
    """A directory the reference wrote loads into the port exactly; the
    port's save loads back into the reference exactly."""
    _, params, _ = tiny_pixart_pair()
    base = str(tmp_path / "ref")
    write_pixart_dir(base, params)
    ref = jax_io.load_pixart_diffusers(base, device=False)
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.PIXART_SIGMA
    config.train_dtype = pt_enums.DataType.FLOAT_32
    family = get_family(config.model_type)
    model = family.load(base, config, device="cpu")
    assert model.transformer_config == pt_io.pixart_config_from_diffusers(
        json.load(open(os.path.join(base, "transformer", "config.json"))), torch.float32,
        gradient_checkpointing=True)
    for name, tree, to_sd in (("transformer", ref["transformer_params"],
                               jax_tf.unet_flax_to_state_dict),
                              ("text_encoder", ref["te_params"], jax_tf.t5_flax_to_state_dict),
                              ("vae", ref["vae_params"], jax_tf.vae_flax_to_state_dict)):
        want = _flat_state(tree, to_sd)
        got = getattr(model, name).state_dict()
        assert set(got) == set(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    out = str(tmp_path / "port")
    pt_io.save_pixart_diffusers(out, model, *(getattr(model, n).state_dict() for n in (
        "transformer", "vae", "text_encoder")), source_dir=base)
    back = jax_io.load_pixart_diffusers(out, device=False)
    for key in ("transformer_params", "te_params", "vae_params"):
        for a, b in zip(jax.tree.leaves(back[key]), jax.tree.leaves(ref[key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert back["transformer_config"] == ref["transformer_config"]


@pytest.mark.parametrize("case", list(_FORWARD))
def test_single_file_both_ways(case, tmp_path):
    """The original repository's keys: the port's maps give the reference's
    both ways (α-1024's micro-condition embedders included), and the
    loaders read one file into the same config and tensors."""
    _, _, port = tiny_pixart_pair(**_FORWARD[case])
    sd = port.transformer.state_dict()
    ckpt = pt_sf.pixart_transformer_to_ckpt(sd)
    want = jax_sf.pixart_transformer_to_ckpt({k: v.numpy() for k, v in sd.items()})
    assert set(ckpt) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(ckpt[k].numpy(), v, err_msg=k)
    back = pt_sf.pixart_ckpt_to_transformer(ckpt)
    want_back = jax_sf.pixart_ckpt_to_transformer(want)
    assert set(back) == set(want_back) == set(sd)
    for k, v in want_back.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
        assert torch.equal(back[k], sd[k])

    path = str(tmp_path / "pixart.safetensors")
    pt_sf.save_pixart_single_file(path, sd)
    got = pt_sf.load_pixart_single_file(path, device="cpu", compute_dtype=torch.float32)
    ref = jax_sf.load_pixart_single_file(path, compute_dtype=jnp.float32, device=False)
    assert got["transformer_config"] == _port_config(pt_pixart.PixArtConfig,
                                                     ref["transformer_config"])
    for k, v in _flat_state(ref["transformer_params"], jax_tf.unet_flax_to_state_dict).items():
        np.testing.assert_array_equal(got["transformer"][k].numpy(), v, err_msg=k)
    assert got["vae"] is None and got["text_encoder"] is None


# -- the train command -----------------------------------------------------------------

def trainer_config(root, name, base, ds) -> TrainConfig:
    """One epoch of two batches of 2 at 32x32, fp32, nothing sampled or
    backed up mid-run (tests/test_torch_port_f19.py runs it)."""
    from onetrainer_tpu.config.concept_config import ConceptConfig
    config = TrainConfig.default_values()
    config.model_type = ModelType.PIXART_SIGMA
    config.base_model_name = base
    config.workspace_dir = os.path.join(root, name, "ws")
    config.cache_dir = os.path.join(root, name, "cache")
    config.epochs = 1
    config.batch_size = 2
    config.resolution = "32"
    config.aspect_ratio_bucketing = False
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.train_dtype = DataType.FLOAT_32
    config.tensorboard = False
    config.samples = []
    config.prior.train = True
    for unit in ("sample_after_unit", "backup_after_unit", "save_every_unit"):
        setattr(config, unit, type(config.sample_after_unit).NEVER)
    concept = ConceptConfig.default_values()
    concept.path = ds
    concept.seed = 3
    config.concepts = [concept]
    return config

