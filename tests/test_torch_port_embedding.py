"""Parity of the torch port's textual inversion (EMBEDDING), additional
embeddings and embedding files with the reference
(onetrainer_tpu/setup/sd_setup.py `_init_embedding_vectors`,
`_init_output_embeddings`, `_load_embedding_file`; the EMBEDDING branches
of the SD, SDXL, SD3, FLUX and HunyuanVideo setups; `scatter_output_embeddings`,
`preserve_input_embedding_norms`, `normalize_output_embeddings` of
onetrainer_tpu/train/sd_train_step.py; the EMBEDDING output of
onetrainer_tpu/trainer/generic_trainer.py).

Each family runs through its setup entry point on both sides from one
config on the tiny models of its own parity tests, with the same weights:
an input embedding `<emb>` of two tokens started from "red cube" and an
output embedding `<out>` of one token started from "blue sphere"
(FLUX's patches T5's output, HunyuanVideo's Llama's), under
preserve_embedding_norm. Word ids come from crc32 on both sides
(tests/test_torch_port_inpaint.py:crc32_words; the Llama wrapper's
fallback words likewise), so no case follows Python's hash seed. The
port's step replays the reference's timestep, noise and latent-sampling
draws (each family's parity test gives the key splits).

Tolerances: the initial input vectors and an embedding file's vectors
exactly; the initial output vectors (a text encoder's output) 1e-5
absolute, after which the port takes the reference's; loss and grad_norm
1e-4 relative and every vector group 1e-4 relative L2 after two fp32
steps, as the LoRA steps are held; the frozen text encoders, denoiser and
VAE bit for bit unchanged; files bit for bit both ways. The reference's
runs are built once per family and shared by the tests; torch runs one
thread here.
"""

import dataclasses
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig, TrainEmbeddingConfig
from onetrainer_tpu.setup import flux_setup as jax_flux_setup
from onetrainer_tpu.setup import hunyuan_setup as jax_hv_setup
from onetrainer_tpu.setup import sd3_setup as jax_sd3_setup
from onetrainer_tpu.setup import sd_setup as jax_sd_setup
from onetrainer_tpu.setup import sdxl_setup as jax_sdxl_setup
from onetrainer_tpu.setup.tokenizer import SDTokenizer
from onetrainer_tpu.train import sd_train_step as jax_step
from onetrainer_tpu.util.enums import ModelType, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.safetensors_io import load_safetensors, save_safetensors
from onetrainer_tpu_torch.io.weights import lora_params_from_jax, sdxl_params_from_flax
from onetrainer_tpu_torch.setup import sd_setup as pt_setup
from onetrainer_tpu_torch.setup.families import get_family, save_embedding_output
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.train import sd_train_step as pt_step
from tests import test_torch_port_flux as flux_t
from tests import test_torch_port_hunyuan as hv_t
from tests import test_torch_port_sd3 as sd3_t
from tests import test_torch_port_train_sd as sd_t
from tests import test_torch_port_train_sdxl as sdxl_t
from tests.test_torch_port_hunyuan import shared_timestep_table  # noqa: F401 (fixture)
from tests.test_torch_port_inpaint import crc32_words
from tests.test_torch_port_models import port_model_like, random_flax_params
from tests.test_torch_port_train_sdxl import REL, SEED, STEPS, _rel

VECTOR_ATOL = 1e-5
PROMPTS = ("a <emb> on a wooden table", "a photograph of <out> here")
FAMILIES = ("sd15", "sdxl", "sd3", "flux", "hunyuan")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _crc32_llama(tokenizer):
    """A Llama wrapper's no-file word ids from crc32 (its fallback path
    splices them into the template filler)."""
    n = tokenizer.vocab_size - 4
    tokenizer._encode_words = lambda text: [zlib.crc32(w.encode()) % n + 2
                                            for w in text.lower().split()]
    return tokenizer


def _embedding(cls, placeholder, count, text, output=False):
    e = cls.default_values()
    e.placeholder, e.token_count, e.initial_embedding_text = placeholder, count, text
    e.is_output_embedding = output
    e.train = True
    return e


def embedding_config(model_type, method=TrainingMethod.EMBEDDING, output=True,
                     preserve=True) -> TrainConfig:
    """An EMBEDDING config: `<emb>` (2 tokens, "red cube") and, with
    `output`, the output embedding `<out>` (1 token, "blue sphere")."""
    config = TrainConfig.default_values()
    config.model_type = model_type
    config.training_method = method
    config.batch_size = 2
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.preserve_embedding_norm = preserve
    config.embedding = _embedding(TrainEmbeddingConfig, "<emb>", 2, "red cube")
    config.additional_embeddings = (
        [_embedding(TrainEmbeddingConfig, "<out>", 1, "blue sphere", output=True)]
        if output else [])
    return config


def port_config(config):
    return PortTrainConfig.default_values().from_dict(config.to_dict())


# -- the families ---------------------------------------------------------------------

def _sd_pair():
    jax_model, _, port = sd_t.tiny_sd_pair("sd15")
    jax_model.tokenizer, port.tokenizer = crc32_words(jax_model.tokenizer), \
        crc32_words(port.tokenizer)
    return jax_model, port


def _sdxl_pair():
    jax_model = sdxl_t._jax_model()
    port = port_model_like(jax_model)
    params = random_flax_params(port, seed=1)
    (jax_model.unet_params, jax_model.te_params, jax_model.te2_params,
     jax_model.vae_params) = jax.tree.map(jnp.asarray, params)
    sdxl_params_from_flax(port, *params)
    jax_model.tokenizer = crc32_words(sdxl_t._tok(SDTokenizer))
    jax_model.tokenizer_2 = crc32_words(sdxl_t._tok(SDTokenizer))
    port.tokenizer = crc32_words(sdxl_t._tok(PortSDTokenizer))
    port.tokenizer_2 = crc32_words(sdxl_t._tok(PortSDTokenizer))
    return jax_model, port


def _sd3_pair():
    jax_model, _, port = sd3_t.tiny_sd3_pair()
    for m in (jax_model, port):
        for name in ("tokenizer", "tokenizer_2", "tokenizer_3"):
            crc32_words(getattr(m, name))
    return jax_model, port


def _flux_pair():
    jax_model, _, port = flux_t.tiny_flux_pair()
    return jax_model, port


def _hunyuan_pair():
    jax_model, _, port = hv_t.tiny_hunyuan_pair()
    for m in (jax_model, port):
        _crc32_llama(m.tokenizer)
        crc32_words(m.tokenizer_2)
    return jax_model, port


def _images():
    return np.random.default_rng(SEED).uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)


def _clips():
    return np.random.default_rng(SEED).uniform(
        -1.0, 1.0, (2, hv_t.FRAMES, hv_t.SIZE, hv_t.SIZE, 3)).astype(np.float32)


def _sdxl_extra(as_array) -> dict:
    return {"original_resolution": as_array(np.full((2, 2), 32, np.int32)),
            "crop_offset": as_array(np.zeros((2, 2), np.int32)),
            "crop_resolution": as_array(np.full((2, 2), 32, np.int32))}


def _no_extra(as_array) -> dict:
    return {}


@dataclasses.dataclass(frozen=True)
class Family:
    model_type: ModelType
    pair: object            # () -> (jax model, port model)
    jax_setup: object       # the reference's create_*_setup
    jax_encode: object      # the reference's make_*_encode_fns
    pixels: object          # () -> images or clips
    batch_extra: object     # as_array -> extra batch fields
    draws: object           # (step_cfg, batch, rng, step) -> the reference's draws
    suffixes: tuple         # the text encoders' group suffixes
    config_fields: dict     # extra config fields


FAMILY = {
    "sd15": Family(ModelType.STABLE_DIFFUSION_15, _sd_pair, jax_sd_setup.create_sd_setup,
                   jax_sd_setup.make_encode_fns, _images, _no_extra, sdxl_t._jax_draws,
                   ("",), {}),
    "sdxl": Family(ModelType.STABLE_DIFFUSION_XL_10_BASE, _sdxl_pair,
                   jax_sdxl_setup.create_sdxl_setup, jax_sdxl_setup.make_sdxl_encode_fns,
                   _images, _sdxl_extra, sdxl_t._jax_draws, ("", "_2"), {}),
    "sd3": Family(ModelType.STABLE_DIFFUSION_3, _sd3_pair, jax_sd3_setup.create_sd3_setup,
                  jax_sd3_setup.make_sd3_encode_fns, _images, _no_extra, sdxl_t._jax_draws,
                  ("", "_2", "_3"), {}),
    "flux": Family(ModelType.FLUX_DEV_1, _flux_pair, jax_flux_setup.create_flux_setup,
                   jax_flux_setup.make_flux_encode_fns, _images, _no_extra, flux_t._jax_draws,
                   ("", "_2"), {"dynamic_timestep_shifting": True,
                                "prior.guidance_scale": flux_t.GUIDANCE}),
    "hunyuan": Family(ModelType.HUNYUAN_VIDEO, _hunyuan_pair, jax_hv_setup.create_hunyuan_setup,
                      jax_hv_setup.make_hunyuan_encode_fns, _clips, _no_extra, hv_t._jax_draws,
                      ("", "_2"), {"prior.guidance_scale": hv_t.GUIDANCE}),
}


def family_config(name: str, **kwargs) -> TrainConfig:
    config = embedding_config(FAMILY[name].model_type, **kwargs)
    for field, value in FAMILY[name].config_fields.items():
        target = config
        *path, last = field.split(".")
        for part in path:
            target = getattr(target, part)
        setattr(target, last, value)
    return config


def make_batch(encode_images, encode_text, pixels, as_array, extra) -> dict:
    batch = {name: as_array(value) for name, value in encode_images(pixels).items()}
    texts = [encode_text(p) for p in PROMPTS]
    for name in texts[0]:
        batch[name] = as_array(np.stack([np.asarray(t[name]) for t in texts]))
    batch.update(extra(as_array))
    batch["loss_weight"] = as_array(np.ones((2,), np.float32))
    return batch


def _jax_steps(setup, batch, draws_fn) -> list:
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = draws_fn(setup.step_cfg, batch, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    setup.state = state
    return steps


_REFERENCES: dict = {}


def reference(name: str) -> dict:
    """Two reference EMBEDDING steps of family `name` from its setup entry
    point (built once)."""
    if name not in _REFERENCES:
        fam = FAMILY[name]
        jax_model, port = fam.pair()
        config = family_config(name)
        setup = fam.jax_setup(jax_model, config, total_steps=10)
        init = jax.device_get(setup.state.params)
        pixels = fam.pixels()
        encode_images, encode_text = fam.jax_encode(setup)
        batch = jax.tree.map(jnp.asarray, make_batch(encode_images, encode_text, pixels,
                                                     jnp.asarray, fam.batch_extra))
        steps = _jax_steps(setup, batch, fam.draws)
        _REFERENCES[name] = dict(name=name, jax_model=jax_model, setup=setup, config=config,
                                 init=init, pixels=pixels, batch=jax.device_get(batch),
                                 steps=steps, port=port)
    return _REFERENCES[name]


def port_draws(ref_step) -> dict:
    draws = {}
    for k, v in ref_step["draws"].items():
        draws[k] = tuple(None if m is None else torch.from_numpy(np.array(m)) for m in v) \
            if isinstance(v, tuple) else torch.from_numpy(np.array(v))
    return draws


def _frozen_snapshot(model) -> dict:
    return {f"{name}.{k}": v.detach().clone()
            for name, m in model.modules().items() for k, v in m.state_dict().items()}


def port_run(ref) -> dict:
    """The port's setup of the same family, config and weights through the
    registry, its own batch, two steps on the reference's draws."""
    fam = FAMILY[ref["name"]]
    port = ref["port"]
    family = get_family(port_config(ref["config"]).model_type)
    setup = family.create_setup(port, port_config(ref["config"]), 10)
    params = setup.state.params
    assert set(params) == set(ref["init"])
    with torch.no_grad():
        for group, value in ref["init"].items():
            if group.startswith("embeddings"):
                # the initial input vectors: table rows, exactly
                np.testing.assert_array_equal(params[group].numpy(), np.asarray(value),
                                              err_msg=group)
            else:
                np.testing.assert_allclose(params[group].numpy(), np.asarray(value),
                                           atol=VECTOR_ATOL, rtol=0, err_msg=group)
                params[group].copy_(torch.from_numpy(np.array(value)))
    encode_images, encode_text = family.make_encode_fns(setup)
    batch = make_batch(encode_images, encode_text, torch.from_numpy(ref["pixels"]),
                       torch.as_tensor, fam.batch_extra)
    for name, value in ref["batch"].items():
        if not np.issubdtype(np.asarray(value).dtype, np.floating):
            np.testing.assert_array_equal(batch[name].numpy(), value, err_msg=name)
    frozen = _frozen_snapshot(setup.model)
    gen = torch.Generator().manual_seed(0)
    metrics = [{k: float(v) for k, v in setup.train_step(
        setup.state, batch, gen, **port_draws(step)).items()} for step in ref["steps"]]
    return dict(setup=setup, metrics=metrics, frozen=frozen, batch=batch)


_PORT_RUNS: dict = {}


def port_run_once(name: str) -> dict:
    if name not in _PORT_RUNS:
        _PORT_RUNS[name] = port_run(reference(name))
    return _PORT_RUNS[name]


@pytest.mark.parametrize("name", FAMILIES)
def test_embedding_steps_match_jax(name, shared_timestep_table):
    """Two EMBEDDING steps: the initial vectors, the loss, the gradient
    norm and every vector group after the steps agree with the reference's;
    only the vectors move, the model's parts stay bit for bit."""
    ref = reference(name)
    run = port_run_once(name)
    setup = run["setup"]
    assert setup.step_cfg.train_text_encoder
    for got, want in zip(run["metrics"], ref["steps"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=REL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=REL)
    final = ref["steps"][-1]["params"]
    assert set(setup.state.params) == set(final)
    for group, value in final.items():
        got = setup.state.params[group].detach().numpy()
        assert _rel(got.ravel(), np.asarray(value).ravel()) <= REL, group
        assert not np.array_equal(got, np.asarray(ref["init"][group])), group
    after = _frozen_snapshot(setup.model)
    assert set(after) == set(run["frozen"])
    for key, value in run["frozen"].items():
        assert torch.equal(after[key], value), key
    assert not any(p.requires_grad for m in setup.model.modules().values()
                   for p in m.parameters())


# -- the step's norm preservation ----------------------------------------------------

def test_norm_preservation_matches_jax():
    """preserve_input_embedding_norms (each row to the table's median row
    norm, an even vocabulary's median the mean of the middle two) and
    normalize_output_embeddings (each span back to its initial std), on
    the same vectors, tables and spans, to 1e-6 relative."""
    rng = np.random.default_rng(SEED)
    tables = {"": rng.normal(size=(100, 8)).astype(np.float32),
              "_2": rng.normal(size=(31, 12)).astype(np.float32)}
    params = {"embeddings": rng.normal(size=(3, 8)).astype(np.float32),
              "embeddings_2": rng.normal(size=(3, 12)).astype(np.float32)}
    jax_cfg = types.SimpleNamespace(preserve_embedding_norm=True)
    frozen = {"text_encoder": {"token_embedding": {"embedding": jnp.asarray(tables[""])}},
              "text_encoder_2": {"token_embedding": {"embedding": jnp.asarray(tables["_2"])}}}
    want = jax_step.preserve_input_embedding_norms(
        {k: jnp.asarray(v) for k, v in params.items()}, frozen, jax_cfg)
    got = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pt_step.preserve_input_embedding_norms(
        got, {k: torch.from_numpy(v) for k, v in tables.items()}, jax_cfg)
    for key in params:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6)
    vectors = rng.normal(size=(5, 8)).astype(np.float32) * 3
    spans, stds = ((0, 2), (2, 3)), (0.5, 2.0)
    np.testing.assert_allclose(
        pt_step.normalize_output_embeddings(torch.from_numpy(vectors), spans, stds).numpy(),
        np.asarray(jax_step.normalize_output_embeddings(jnp.asarray(vectors), spans, stds)),
        rtol=1e-6)
    hidden = rng.normal(size=(2, 6, 8)).astype(np.float32)
    tokens = np.array([[98, 5, 110, 111, 99, 99], [98, 112, 7, 99, 99, 99]], np.int32)
    np.testing.assert_array_equal(
        pt_step.scatter_output_embeddings(torch.from_numpy(hidden), torch.from_numpy(tokens),
                                          torch.from_numpy(vectors[:3]), 110).numpy(),
        np.asarray(jax_step.scatter_output_embeddings(jnp.asarray(hidden), jnp.asarray(tokens),
                                                      jnp.asarray(vectors[:3]), 110)))


# -- starting from a file, and the files both ways -----------------------------------

def test_initial_vectors_from_an_embedding_file_match_jax(tmp_path):
    """An embedding's `model_name` file sets its vectors and its token
    count on both sides, exactly: the reference's `emp_params`, a bundle's
    lone 2-D tensor, and the width-matched tensor of a file with one per
    text encoder (SDXL's clip_l/clip_g)."""
    rng = np.random.default_rng(SEED)
    path = str(tmp_path / "emb.safetensors")
    save_safetensors(path, {"emp_params": torch.from_numpy(
        rng.normal(size=(3, 32)).astype(np.float32))})
    config = embedding_config(ModelType.STABLE_DIFFUSION_15, output=False)
    config.embedding.model_name = path
    jax_model, port = _sd_pair()
    want, want_ids = jax_sd_setup._init_embedding_vectors(
        jax_model, jax_model.te_params, jax_model.tokenizer, config)
    got, ids = pt_setup._init_embedding_vectors(port.text_encoder, port.tokenizer,
                                                port_config(config))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ids == want_ids and got.shape == (3, 32)
    assert port.tokenizer("a <emb>").tolist() == jax_model.tokenizer("a <emb>").tolist()
    both = str(tmp_path / "sdxl.safetensors")
    save_safetensors(both, {"clip_l": torch.ones(2, 32), "clip_g": torch.full((2, 64), 2.0)})
    for hidden, value in ((32, 1.0), (64, 2.0)):
        np.testing.assert_array_equal(pt_setup._load_embedding_file(both, hidden).numpy(),
                                      jax_sd_setup._load_embedding_file(both, hidden))
        assert float(pt_setup._load_embedding_file(both, hidden)[0, 0]) == value


@pytest.mark.parametrize("name", FAMILIES)
def test_embedding_files_match_jax_both_ways(name, tmp_path, shared_timestep_table):
    """After the two steps each side writes its EMBEDDING output (the
    reference's trainer `_save_output`, the port's
    `save_embedding_output`): the same keys (emp_params/output_emp_params,
    clip_l/clip_g/t5 and their _out, FLUX's clip_l/t5/t5_out,
    HunyuanVideo's llama/clip_l/llama_out), each side's file holds its own
    vectors bit for bit and reads back bit for bit by the other side's
    reader; a single-table file loads as a starting file on either side."""
    from onetrainer_tpu.io.safetensors_io import load_safetensors as jax_load
    from onetrainer_tpu.trainer.generic_trainer import GenericTrainer
    ref = reference(name)
    setup = port_run_once(name)["setup"]
    jax_path = str(tmp_path / "jax.safetensors")
    GenericTrainer._save_output(types.SimpleNamespace(config=ref["config"],
                                                      setup=ref["setup"]), jax_path)
    port_path = save_embedding_output(setup, str(tmp_path / "port"))
    keys = {"sd15": {"emp_params", "output_emp_params"},
            "sdxl": {"clip_l", "clip_g", "clip_l_out", "clip_g_out"},
            "sd3": {"clip_l", "clip_g", "t5", "clip_l_out", "clip_g_out", "t5_out"},
            "flux": {"clip_l", "t5", "t5_out"},
            "hunyuan": {"llama", "clip_l", "llama_out"}}[name]
    jax_file, port_file = jax_load(jax_path), load_safetensors(port_path)
    assert set(jax_file) == set(port_file) == keys
    for key in keys:
        np.testing.assert_array_equal(np.asarray(jax_load(port_path)[key]),
                                      port_file[key].numpy(), err_msg=key)
        np.testing.assert_array_equal(load_safetensors(jax_path)[key].numpy(),
                                      np.asarray(jax_file[key]), err_msg=key)
        assert _rel(port_file[key].numpy().ravel(),
                    np.asarray(jax_file[key]).ravel()) <= REL, key
    if name == "sd15":
        hidden = port_file["emp_params"].shape[-1]
        for path in (jax_path, port_path):
            np.testing.assert_array_equal(pt_setup._load_embedding_file(path, hidden).numpy(),
                                          jax_sd_setup._load_embedding_file(path, hidden))


def _lora_with_embedding(config):
    config.lora_rank, config.lora_alpha = 4, 8.0
    config.text_encoder.train = False
    config.additional_embeddings = [_embedding(TrainEmbeddingConfig, "<emb>", 2, "red cube")]
    return config


def test_additional_embedding_beside_lora_matches_jax():
    """SD 1.5 LoRA beside an additional embedding: the port's setup trains
    both (the reference's step takes the vectors beside the adapters,
    sd_train_step.py:335; its LoRA setup makes none, so its trainable tree
    gets them here from its own `_init_embedding_vectors`); two steps agree
    as the EMBEDDING steps do, and the LoRA file bundles the vectors as
    `bundle_emb.<placeholder>.emp_params`."""
    from onetrainer_tpu.train.optimizers import create_group_optimizer
    from onetrainer_tpu.train.train_state import create_train_state
    config = _lora_with_embedding(embedding_config(
        ModelType.STABLE_DIFFUSION_15, method=TrainingMethod.LORA, output=False,
        preserve=False))
    jax_model, port = _sd_pair()
    setup = jax_sd_setup.create_sd_setup(jax_model, config, total_steps=10)
    vectors, ids = jax_sd_setup._init_embedding_vectors(
        jax_model, jax_model.te_params, jax_model.tokenizer, config)
    trainable = dict(setup.state.params, embeddings=vectors)
    schedules = dict(setup.group_schedules, embeddings=setup.group_schedules["unet_lora"])
    labels = {"unet_lora": jax.tree.map(lambda _: "unet_lora", trainable["unet_lora"]),
              "embeddings": "embeddings"}
    tx = create_group_optimizer(schedules, config.optimizer.optimizer, config.optimizer,
                                labels)
    step = jax_step.make_sd_train_step(jax_model, setup.step_cfg, tx, setup.peft_cfg)
    setup.state = create_train_state(trainable, tx)
    setup.train_step, setup.embedding_ids = step, ids
    init = jax.device_get(setup.state.params)
    encode_images, encode_text = jax_sd_setup.make_encode_fns(setup)
    pixels = _images()
    batch = jax.tree.map(jnp.asarray, make_batch(encode_images, encode_text, pixels,
                                                 jnp.asarray, _no_extra))
    steps = _jax_steps(setup, batch, sdxl_t._jax_draws)

    family = get_family(port_config(config).model_type)
    ported = family.create_setup(port, port_config(config), 10)
    assert set(ported.state.params) == {"unet_lora", "embeddings"}
    np.testing.assert_array_equal(ported.state.params["embeddings"].numpy(),
                                  np.asarray(init["embeddings"]))
    with torch.no_grad():
        for key, entry in lora_params_from_jax(init["unet_lora"], device="cpu").items():
            for leaf, value in entry.items():
                ported.state.params["unet_lora"][key][leaf].copy_(value)
    encode_images, encode_text = family.make_encode_fns(ported)
    port_batch = make_batch(encode_images, encode_text, torch.from_numpy(pixels),
                            torch.as_tensor, _no_extra)
    np.testing.assert_array_equal(port_batch["tokens"].numpy(), np.asarray(batch["tokens"]))
    gen = torch.Generator().manual_seed(0)
    for want in steps:
        out = ported.train_step(ported.state, port_batch, gen, **port_draws(want))
        assert float(out["loss"]) == pytest.approx(want["loss"], rel=REL)
        assert float(out["grad_norm"]) == pytest.approx(want["grad_norm"], rel=REL)
    final = steps[-1]["params"]
    assert _rel(ported.state.params["embeddings"].detach().numpy().ravel(),
                np.asarray(final["embeddings"]).ravel()) <= REL
    got = [ported.state.params["unet_lora"][k][n].detach().numpy().ravel()
           for k, e in final["unet_lora"].items() for n in e]
    want = [np.asarray(v).ravel() for e in final["unet_lora"].values() for v in e.values()]
    assert _rel(np.concatenate(got), np.concatenate(want)) <= REL
    import tempfile
    from onetrainer_tpu_torch.setup.families import save_lora_output
    with tempfile.TemporaryDirectory() as d:
        path = save_lora_output(ported, f"{d}/lora", family.lora_prefixes)
        bundled = load_safetensors(path)["bundle_emb.<emb>.emp_params"]
    assert torch.equal(bundled, ported.state.params["embeddings"].detach())


# -- the sample command's --embedding-name -------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_sample_command_takes_the_embedding(name, tmp_path, monkeypatch,
                                            shared_timestep_table):
    """`scripts/sample.py --embedding-name` on a file the train command's
    EMBEDDING output could be: each text encoder's setup rows are the
    file's vectors for it, exactly, and the prompt's placeholder takes
    their ids. For SD 1.5 and SDXL the image is the reference sampler's
    with the same rows (final latents 1e-3 absolute, the image within 2
    levels, as the sample tests hold them)."""
    from onetrainer_tpu_torch.scripts import sample as sample_command
    from onetrainer_tpu_torch.setup import families
    from tests.test_torch_port_sdxl_sample import (
        IMAGE_LEVELS, LATENT_ATOL, _record_steps, _sample_config,
    )
    jax_model, port = FAMILY[name].pair()
    widths = [t.shape[-1] for t in (
        pt_setup._embedding_table(getattr(port, attr))
        for attr in ("text_encoder", "text_encoder_2", "text_encoder_3")[:len(FAMILY[name].suffixes)])]
    rng = np.random.default_rng(SEED)
    keys = {"sd15": ["emp_params"], "sdxl": ["clip_l", "clip_g"],
            "sd3": ["clip_l", "clip_g", "t5"], "flux": ["clip_l", "t5"],
            "hunyuan": ["llama", "clip_l"]}[name]
    tensors = {k: torch.from_numpy(rng.normal(size=(2, w)).astype(np.float32) * 0.02)
               for k, w in zip(keys, widths)}
    path = str(tmp_path / "emb.safetensors")
    save_safetensors(path, tensors)
    real_get_family = families.get_family
    seen = {}

    def get_family_with_model(model_type):
        family = real_get_family(model_type)
        real_create = family.create_setup

        def create_setup(*args, **kwargs):
            seen["setup"] = real_create(*args, **kwargs)
            return seen["setup"]
        return dataclasses.replace(family, load=lambda *a, **k: port,
                                   create_setup=create_setup)

    monkeypatch.setattr(families, "get_family", get_family_with_model)
    jax_latents = None
    if name in ("sd15", "sdxl"):
        from onetrainer_tpu.sampling import schedulers as jax_sched
        from onetrainer_tpu.sampling.sd_sampler import sample_stable_diffusion
        from onetrainer_tpu.sampling.sdxl_sampler import sample_stable_diffusion_xl
        from onetrainer_tpu_torch.sampling import schedulers as pt_sched
        from onetrainer_tpu_torch.sampling import sd_sampler, sdxl_sampler
        pt_sampler = sd_sampler if name == "sd15" else sdxl_sampler
        sc = _sample_config(32)
        sc.prompt = "a <embedding> on a wooden table"
        for tok in (jax_model.tokenizer, getattr(jax_model, "tokenizer_2", None)):
            if tok is not None:
                tok.register_placeholder("<embedding>", 2)
        rows = [jnp.asarray(tensors[k].numpy()) for k in keys]
        jax_latents = _record_steps(monkeypatch, jax_sched)
        if name == "sd15":
            ref = sample_stable_diffusion(jax_model, jax_model.unet_params, jax_model.te_params,
                                          jax_model.vae_params, jax_model.tokenizer, sc,
                                          extra_embeddings=rows[0])
        else:
            ref = sample_stable_diffusion_xl(
                jax_model, jax_model.unet_params, jax_model.te_params, jax_model.te2_params,
                jax_model.vae_params, jax_model.tokenizer, jax_model.tokenizer_2, sc,
                extra_embeddings=tuple(rows))
        _, noise_rng = jax.random.split(jax.random.PRNGKey(sc.seed))
        latent = 32 // jax_model.vae_config.spatial_scale
        noise = np.array(jax.random.normal(
            noise_rng, (1, latent, latent, jax_model.vae_config.latent_channels), jnp.float32))
        monkeypatch.setattr(pt_sampler, "_initial_latents",
                            lambda shape, generator, device: torch.from_numpy(noise).to(device))
        port_latents = _record_steps(monkeypatch, pt_sched)
    args = ["--model-type", FAMILY[name].model_type.name, "--base-model-name", "unused",
            "--prompt", "a <embedding> on a wooden table", "--destination",
            str(tmp_path / "out.png"), "--steps", "2", "--width", "32", "--height", "32",
            "--embedding-name", path, "--device", "cpu", "--seed", "3"]
    if name in ("sd15", "sdxl"):
        args += ["--cfg", "7", "--negative-prompt", "blurry"]
    out = sample_command.main(args)
    setup = seen["setup"]
    extras = setup.merged_inference_params()[-1]
    extras = extras if isinstance(extras, tuple) else (extras,)
    for key, extra in zip(keys, extras):
        np.testing.assert_array_equal(extra.numpy(), tensors[key].numpy(), err_msg=key)
    assert out.image.dtype == np.uint8 and (tmp_path / "out.png").exists()
    if jax_latents is not None:
        np.testing.assert_allclose(port_latents[-1].numpy(), np.asarray(jax_latents[-1]),
                                   atol=LATENT_ATOL, rtol=0)
        assert np.abs(out.image.astype(int) - ref.image.astype(int)).max() <= IMAGE_LEVELS


def test_f18_reference_hunyuan_sampler_gives_clip_no_rows():
    """ROADMAP F18: the reference's HunyuanVideo sampler hands its trained
    rows to Llama alone (onetrainer_tpu/sampling/hunyuan_sampler.py:38-45),
    though its setup registers the placeholder with CLIP-L's tokenizer too:
    the placeholder's id lies past CLIP-L's table, jax's gather clamps it
    to the table's last row (CLIP's end-of-text token), and the pooled
    embedding is CLIP-L's with that row in the placeholder's place, bit
    for bit, not with the embedding's. The port's sampler hands CLIP-L its
    rows (sampling/hunyuan_sampler.py)."""
    jax_model, _ = _hunyuan_pair()
    tok = jax_model.tokenizer_2
    tok.register_placeholder("<e>", 1)
    tokens = jnp.asarray(np.asarray(tok("a <e> cat"))[None])
    vocab = jax_model.te2_config.vocab_size
    assert int((tokens >= vocab).sum()) == 1
    variables = {"params": jax_model.te2_params}
    apply = jax_model.text_encoder_2.apply
    pooled = np.asarray(apply(variables, tokens)["pooled_output"])
    last_row = jax_model.te2_params["token_embedding"][vocab - 1:]
    as_last_row = np.asarray(apply(variables, tokens, None, last_row)["pooled_output"])
    np.testing.assert_array_equal(pooled, as_last_row)
    rows = jnp.asarray(np.random.default_rng(SEED).normal(
        size=(1, jax_model.te2_config.hidden_size)).astype(np.float32))
    with_rows = np.asarray(apply(variables, tokens, None, rows)["pooled_output"])
    assert np.abs(with_rows - pooled).max() > 1e-3
