"""Parity of the torch port's Würstchen v2 / Stable Cascade training and
sampling with the reference (onetrainer_tpu/setup/wuerstchen_setup.py,
train/wuerstchen_train_step.py, sampling/wuerstchen_sampler.py), and the
train and sample commands on a tiny v2 directory.

Both sides run tests/test_torch_port_wuerstchen.py's tiny pairs (the same
seeded weights, the timestep features from one shared frequency table:
F27) through their setup entry points, with word ids from crc32
(tests/test_torch_port_inpaint.py:crc32_words). The batches hold one set
of seeded effnet latents of 128x128 images (3x3x16; the image path of
`make_wuerstchen_encode_fns`, the x0.75 resize, ImageNet normalization and
EfficientNetV2-S, is held by tests/test_torch_port_wuerstchen.py::
test_effnet_encode_matches_jax) and the text each side's
`make_wuerstchen_encode_fns` caches (v2's final-LayerNorm'd CLIP states,
Cascade's raw states and pooled projection), which agree to CACHE_ATOL.
The reference's key splits are replayed for its continuous timesteps,
noise and conditioning keep masks, and the port's step takes them.

Tolerances, as tests/test_torch_port_train_sdxl.py holds its steps: the
loss, the grad norm and each trained group (relative L2) to REL after two
v2 LoRA steps (CLIP dropout 0.5: v2 zeroes the states), one Cascade
FINE_TUNE step of the whole prior (dropout 0.5: Cascade zeroes the states
and the pooled projection) and one Cascade EMBEDDING step (CLIP in the
step with the trained rows, norm preservation); an NF4 prior's codes and
scales bit for bit; the samplers' images within IMAGE_LEVELS of 255, v2
through the prior, DiffNeXt and the Paella VQGAN, Cascade through the
linear stand-in, the port's draws fed the reference's. torch runs one
thread.
"""

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
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.math.noise import create_noise as jax_noise
from onetrainer_tpu.math.timesteps import sample_timesteps_continuous as jax_timesteps
from onetrainer_tpu.models.cascade import CascadePriorConfig as JaxCascadeConfig
from onetrainer_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from onetrainer_tpu.sampling.sd_sampler import sample_rng_for
from onetrainer_tpu.sampling.wuerstchen_sampler import sample_wuerstchen as jax_sample
from onetrainer_tpu.setup import wuerstchen_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import SDTokenizer
from onetrainer_tpu.train.sd_train_step import conditioning_dropout_mask as jax_keep
from onetrainer_tpu.util.enums import DataType, ModelType, TimeUnit, TrainingMethod
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
from onetrainer_tpu_torch.io.weights import lora_params_from_jax
from onetrainer_tpu_torch.ops import quant as pt_quant
from onetrainer_tpu_torch.sampling import wuerstchen_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from tests import test_torch_port_embedding as emb_t
from tests.test_data import make_dataset
from tests.test_torch_port_inpaint import crc32_words
from tests.test_torch_port_train_sdxl import CACHE_ATOL, REL, SEED, STEPS
from tests.test_torch_port_wuerstchen import (  # noqa: F401  (shared_r_table: a fixture)
    CASCADE_PRIOR, CASCADE_TE, jax_cascade_model, shared_r_table, tiny_decoder_pair,
    tiny_pair, write_decoder_dir, write_wuerstchen_dir,
)

DROPOUT = 0.5
IMAGE_LEVELS = 2
SIZE = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokenizer(cls):
    return crc32_words(cls(None, max_length=16, vocab_size=100, bos=98, eos=99))


def _with_tokenizers(pair):
    jax_model, params, port = pair
    jax_model.tokenizer = _tokenizer(SDTokenizer)
    port.tokenizer = _tokenizer(PortSDTokenizer)
    return jax_model, params, port


def _cached_latents(_images) -> dict:
    """The image cache's row for both sides: seeded effnet latents of two
    SIZE x SIZE images."""
    latent = np.random.default_rng(SEED).standard_normal((2, 3, 3, 16)).astype(np.float32)
    return {"latent_image": latent}


def _config(model_type, method, **fields) -> TrainConfig:
    config = TrainConfig.default_values()
    config.model_type = model_type
    config.training_method = method
    config.batch_size = 2
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.lora_rank, config.lora_alpha = 4, 8.0
    config.prior.train = True
    config.text_encoder.train = False
    config.text_encoder.dropout_probability = DROPOUT
    config.optimizer.stochastic_rounding = False
    for name, value in fields.items():
        setattr(config, name, value)
    return config


def jax_wuerstchen_draws(step_cfg, batch, rng, step):
    """The draws of the reference's step `step` (its own key splits): the
    continuous timesteps before the warp, the noise and the text encoder's
    keep mask from fold_in(rng_predict, 0xd0)."""
    rng_loss, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, rng_predict = jax.random.split(rng_loss)
    rng_t, rng_noise = jax.random.split(rng_predict)
    latent = batch["latent_image"]
    b = latent.shape[0]
    keep = np.asarray(jax_keep(jax.random.fold_in(rng_predict, 0xd0), b, step_cfg.te_dropout)) \
        if step_cfg.te_dropout > 0 else None
    return {
        "timestep": np.asarray(jax_timesteps(rng_t, b, step_cfg.timestep)),
        "noise": np.asarray(jax_noise(rng_noise, latent.shape, jnp.float32,
                                      step_cfg.offset_noise_weight,
                                      step_cfg.perturbation_noise_weight)),
        "dropout_keep": (keep,),
    }


def _reference(pair, config, steps: int) -> dict:
    """`steps` reference steps of `config` from its setup entry point on
    the batch its encode functions cache."""
    jax_model, params, port = pair
    setup = jax_setup.create_wuerstchen_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    _, encode_text = jax_setup.make_wuerstchen_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, emb_t.make_batch(_cached_latents, encode_text, None,
                                                       jnp.asarray, emb_t._no_extra))
    rng = jax.random.PRNGKey(SEED)
    state, out = setup.state, []
    for step in range(steps):
        draws = jax_wuerstchen_draws(setup.step_cfg, batch, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        out.append(dict(draws=draws, loss=float(metrics["loss"]),
                        grad_norm=float(metrics["grad_norm"]),
                        params=jax.device_get(state.params)))
    return dict(init=init, batch=jax.device_get(batch), steps=out,
                port=port, config=config, step_cfg=setup.step_cfg)


@pytest.fixture(scope="module")
def lora_reference(shared_r_table):
    return _reference(_with_tokenizers(tiny_pair(effnet=False)),
                      _config(ModelType.WUERSTCHEN_2, TrainingMethod.LORA), STEPS)


@pytest.fixture(scope="module")
def cascade_ft_reference(shared_r_table):
    return _reference(_with_tokenizers(tiny_pair(cascade=True, effnet=False)),
                      _config(ModelType.STABLE_CASCADE_1, TrainingMethod.FINE_TUNE), 1)


def _port_setup(ref):
    port = ref["port"]
    family = get_family(pt_enums.ModelType(ref["config"].model_type.value))
    setup = family.create_setup(port, emb_t.port_config(ref["config"]), 10)
    _, encode_text = family.make_encode_fns(setup)
    batch = emb_t.make_batch(_cached_latents, encode_text, None, torch.as_tensor,
                             emb_t._no_extra)
    assert set(batch) == set(ref["batch"])
    for name, value in ref["batch"].items():
        if np.issubdtype(np.asarray(value).dtype, np.floating):
            np.testing.assert_allclose(batch[name].numpy(), value, atol=CACHE_ATOL, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(batch[name].numpy(), value, err_msg=name)
    return setup, batch


def _run(setup, batch, ref) -> list:
    gen = torch.Generator().manual_seed(0)
    out = []
    for step in ref["steps"]:
        draws = emb_t.port_draws(step)
        metrics = setup.train_step(setup.state, batch, gen, **draws)
        out.append({k: float(v) for k, v in metrics.items()})
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_v2_lora_steps_match_jax(lora_reference):
    """Two LoRA steps of the v2 prior (the depthwise convs skipped on both
    sides) on cached effnet latents and final-LayerNorm'd CLIP states."""
    ref = lora_reference
    setup, batch = _port_setup(ref)
    assert set(setup.state.params) == set(ref["init"]) == {"prior_lora"}
    assert not any("depthwise" in key for key in setup.state.params["prior_lora"])
    with torch.no_grad():
        for group, adapters in ref["init"].items():
            assert set(adapters) == set(setup.state.params[group])
            for key, entry in lora_params_from_jax(adapters, device="cpu").items():
                for name, value in entry.items():
                    setup.state.params[group][key][name].copy_(value)
    keeps = [s["draws"]["dropout_keep"][0] for s in ref["steps"]]
    assert {0.0, 1.0} == set(np.concatenate(keeps).tolist())
    metrics = _run(setup, batch, ref)
    for got, want in zip(metrics, ref["steps"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=REL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=REL)
    final = ref["steps"][-1]["params"]["prior_lora"]
    got = [setup.state.params["prior_lora"][k][n].detach().numpy().ravel()
           for k, e in final.items() for n in e]
    want = [np.asarray(v).ravel() for e in final.values() for v in e.values()]
    assert _rel(np.concatenate(got), np.concatenate(want)) <= REL
    assert max(float(e["lora_up"].abs().max())
               for e in setup.state.params["prior_lora"].values()) > 0


def test_cascade_fine_tune_step_matches_jax(cascade_ft_reference):
    """One FINE_TUNE step of the whole Cascade prior on cached raw CLIP
    states and pooled projections."""
    ref = cascade_ft_reference
    setup, batch = _port_setup(ref)
    assert "pooled_text_encoder_output" in batch
    assert set(setup.state.params) == {"prior"}
    metrics = _run(setup, batch, ref)
    assert metrics[0]["loss"] == pytest.approx(ref["steps"][0]["loss"], rel=REL)
    assert metrics[0]["grad_norm"] == pytest.approx(ref["steps"][0]["grad_norm"], rel=REL)
    want = jax_tf.flax_params_to_torch(ref["steps"][0]["params"]["prior"])
    got = setup.state.params["prior"]
    assert set(got) == set(want)
    keys = sorted(want)
    assert _rel(np.concatenate([got[k].detach().numpy().ravel() for k in keys]),
                np.concatenate([np.asarray(want[k]).ravel() for k in keys])) <= REL


def test_cascade_embedding_step_matches_jax(shared_r_table):
    """One EMBEDDING step of Cascade's CLIP input vectors (`<emb>`, two
    tokens; no output embedding: Würstchen has none), CLIP in the step on
    the batch's tokens, the norms preserved; the model stays bit for bit."""
    jax_model, _, port = _with_tokenizers(tiny_pair(cascade=True, effnet=False))
    config = emb_t.embedding_config(ModelType.STABLE_CASCADE_1, output=False)
    config.text_encoder.dropout_probability = DROPOUT
    ref = _reference((jax_model, None, port), config, 1)
    assert set(ref["init"]) == {"embeddings"}
    setup, batch = _port_setup(ref)
    assert "text_encoder_hidden_state" not in batch
    np.testing.assert_array_equal(setup.state.params["embeddings"].numpy(),
                                  ref["init"]["embeddings"])
    frozen = emb_t._frozen_snapshot(port)
    metrics = _run(setup, batch, ref)
    assert metrics[0]["loss"] == pytest.approx(ref["steps"][0]["loss"], rel=REL)
    assert metrics[0]["grad_norm"] == pytest.approx(ref["steps"][0]["grad_norm"], rel=REL)
    assert _rel(setup.state.params["embeddings"].detach().numpy(),
                ref["steps"][0]["params"]["embeddings"]) <= REL
    after = emb_t._frozen_snapshot(port)
    assert all(torch.equal(after[k], v) for k, v in frozen.items())


def test_nf4_prior_codes_match_jax():
    """A LoRA setup over an NF4 prior quantizes the same layers to the
    reference's codes and scales, bit for bit (at c 48 the channelwise MLPs,
    48 x 192, and the timestep maps, 64 x 96, pass the 4096-element floor)."""
    jax_model, _, port = _with_tokenizers(tiny_pair(effnet=False))
    config = _config(ModelType.WUERSTCHEN_2, TrainingMethod.LORA)
    config.prior.weight_dtype = DataType.NFLOAT_4
    setup = jax_setup.create_wuerstchen_setup(jax_model, config, total_steps=10)
    get_family(pt_enums.ModelType.WUERSTCHEN_2).create_setup(port, emb_t.port_config(config), 10)
    quantized = 0
    for name, layer in port.prior.named_modules():
        w = getattr(layer, "weight", None)
        if pt_quant.is_quantized(w):
            quantized += 1
            node = setup.frozen["prior"]
            for part in jax_tf.merge_int_tokens(name + ".kernel"):
                node = node[part]
            np.testing.assert_array_equal(w.q.numpy(), np.asarray(node.q), err_msg=name)
            np.testing.assert_array_equal(w.scales.numpy(), np.asarray(node.scales))
    assert quantized == 6


# -- the samplers ------------------------------------------------------------------------

def _jax_draws(sc, prior_shape, steps, decoder_shape=None, decoder_steps=10) -> list:
    """The reference sampler's normal draws in order: the initial latents,
    each prior step's noise but the last's, then the decoder's."""
    rng = sample_rng_for(sc)
    draws = []

    def loop(rng, shape, n):
        rng, key = jax.random.split(rng)
        draws.append(np.asarray(jax.random.normal(key, shape, jnp.float32)))
        for i in range(n - 1):
            rng, key = jax.random.split(rng)
            draws.append(np.asarray(jax.random.normal(key, shape, jnp.float32)))
        return rng
    rng = loop(rng, prior_shape, steps)
    if decoder_shape is not None:
        loop(rng, decoder_shape, decoder_steps)
    return draws


def _sample_config() -> SampleConfig:
    sc = SampleConfig.default_values()
    sc.prompt, sc.negative_prompt = "a red cube on a table", "blurry"
    sc.height = sc.width = SIZE
    sc.diffusion_steps = 2
    sc.cfg_scale = 4.0
    sc.seed = 3
    return sc


def _port_sample(port, sc, draws, monkeypatch):
    queue = list(draws)

    def noise(shape, generator, device):
        value = queue.pop(0)
        assert tuple(shape) == value.shape
        return torch.from_numpy(value.copy())
    monkeypatch.setattr(pt_sampler, "_noise", noise)
    config = emb_t.port_config(_config(ModelType(port.model_type.value),
                                       TrainingMethod.FINE_TUNE))
    config.prior.train = False
    family = get_family(config.model_type)
    setup = family.create_setup(port, config, 1)
    assert setup.train_step is None
    out = family.sample(setup, PortSampleConfig.default_values().from_dict(sc.to_dict()), None)
    assert not queue
    return out.image


def _assert_images_close(got, want):
    assert got.shape == want.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS and want.std() > 0


def test_v2_two_stage_sampler_matches_jax(shared_r_table, monkeypatch):
    """The v2 prior with CFG over two steps, then DiffNeXt's ten steps and
    the VQGAN decode (the prior's CLIP as the decoder's, as
    tests/test_trainer_wuerstchen.py:test_wuerstchen_two_stage_sampling)."""
    jax_model, _, port = _with_tokenizers(tiny_pair(effnet=False))
    (dec_cfg, vq_cfg), (dec_params, vq_params), dport = tiny_decoder_pair()
    jax_model.decoder_config, jax_model.vqgan_config = dec_cfg, vq_cfg
    jax_model.decoder_params, jax_model.vqgan_params = dec_params, vq_params
    jax_model.decoder_te_config, jax_model.decoder_te_params = \
        jax_model.te_config, jax_model.te_params
    port.decoder, port.vqgan = dport.decoder, dport.vqgan
    port.decoder_config, port.vqgan_config = dport.decoder_config, dport.vqgan_config
    port.decoder_text_encoder = port.text_encoder
    sc = _sample_config()
    want = jax_sample(jax_model, jax_model.prior_params, jax_model.te_params,
                      jax_model.tokenizer, sc).image
    draws = _jax_draws(sc, (1, 3, 3, 16), 2, (1, SIZE // 4, SIZE // 4, 4))
    _assert_images_close(_port_sample(port, sc, draws, monkeypatch), want)


def test_cascade_standin_sampler_matches_jax(shared_r_table, monkeypatch):
    """The Cascade prior with the pooled text and CFG, decoded by the linear
    stand-in (tests/test_trainer_wuerstchen.py:test_cascade_sampling_standin's
    configs: CLIP 32 wide without a projection)."""
    jax_model = jax_cascade_model()
    jax_model.prior_config = JaxCascadeConfig(**dict(CASCADE_PRIOR, clip_text_in=32,
                                                     clip_text_pooled_in=32), dtype=jnp.float32)
    jax_model.te_config = JaxCLIPConfig(**dict(CASCADE_TE, hidden_size=32, intermediate_size=64,
                                               projection_dim=None), dtype=jnp.float32)
    jax_model, _, port = _with_tokenizers(tiny_pair(effnet=False, jax_model=jax_model))
    sc = _sample_config()
    want = jax_sample(jax_model, jax_model.prior_params, jax_model.te_params,
                      jax_model.tokenizer, sc).image
    _assert_images_close(_port_sample(port, sc, _jax_draws(sc, (1, 3, 3, 16), 2),
                                      monkeypatch), want)


# -- the commands --------------------------------------------------------------------------

def test_train_and_sample_commands_on_a_v2_directory(tmp_path):
    """The train command on a tiny v2 prior directory and effnet file
    (tests/test_trainer_wuerstchen.py:test_wuerstchen_e2e_lora's config):
    the effnet caches 3x3 latents, two LoRA steps, a backup, the kohya
    output with `lora_prior_` keys; then the sample command through a
    decoder directory the port writes (`--decoder-model-name`)."""
    from onetrainer_tpu_torch.scripts import sample as pt_sample
    from onetrainer_tpu_torch.scripts import train as pt_train
    _, params, port = tiny_pair()
    base = str(tmp_path / "ckpt")
    effnet = write_wuerstchen_dir(base, params)
    config = TrainConfig.default_values()
    config.model_type = ModelType.WUERSTCHEN_2
    config.training_method = TrainingMethod.LORA
    config.base_model_name = base
    config.effnet_encoder.model_name = effnet
    config.workspace_dir = str(tmp_path / "ws")
    config.cache_dir = str(tmp_path / "cache")
    config.epochs, config.batch_size, config.resolution = 1, 2, str(SIZE)
    config.aspect_ratio_bucketing = False
    config.lora_rank, config.lora_layers = 4, "attention"
    config.learning_rate, config.learning_rate_warmup_steps = 1e-3, 0.0
    config.tensorboard = False
    config.sample_after_unit = config.save_every_unit = TimeUnit.NEVER
    config.backup_after_unit = TimeUnit.NEVER
    config.backup_before_save = True
    config.prior.train, config.text_encoder.train = True, False
    config.train_dtype = DataType.FLOAT_32
    config.samples = []
    concept = ConceptConfig.default_values()
    concept.path = make_dataset(str(tmp_path / "ds"), n=4)
    concept.seed = 3
    config.concepts = [concept]
    config.output_model_destination = str(tmp_path / "out_w2.safetensors")
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
            json.dump(config.to_dict(), f)
    trainer = pt_train.main(["--config-path", path, "--device", "cpu"])
    assert trainer.train_progress.global_step == 2
    batch = trainer.data_loader.materialize_batch(trainer.data_loader.batches_for_epoch(0)[0])
    assert tuple(batch["latent_image"].shape[1:]) == (3, 3, 16)
    lora = load_safetensors(config.output_model_destination)
    assert lora and all(k.startswith("lora_prior_") for k in lora)
    assert os.listdir(os.path.join(config.workspace_dir, "backup"))

    _, _, dport = tiny_decoder_pair()
    dport.text_encoder = port.text_encoder
    decoder_dir = str(tmp_path / "decoder")
    write_decoder_dir(decoder_dir, dport)
    dest = str(tmp_path / "w2.png")
    out = pt_sample.main(["--model-type", "WUERSTCHEN_2", "--base-model-name", base,
                          "--prompt", "a cat", "--destination", dest, "--steps", "2",
                          "--width", str(SIZE), "--height", str(SIZE), "--device", "cpu",
                          "--decoder-model-name", decoder_dir])
    assert out.image.shape == (SIZE, SIZE, 3) and os.path.isfile(dest)
