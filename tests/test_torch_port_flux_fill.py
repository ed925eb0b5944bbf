"""Parity of the torch port's FLUX.1-fill slice with the reference
(onetrainer_tpu/models/flux.py `flux_fill_config`,
models/flux_model.py `create_flux_model`, train/flux_train_step.py's fill
branch, sampling/flux_sampler.py's fill branch, io/flux_checkpoints.py).

Both sides run a tiny FLUX.1-fill: tests/test_flux.py's tiny FLUX with a
288-wide `x_embedder` (4 latent channels: 16 noisy + 16 conditioning + 256
mask channels, packed) and a four-level VAE (a latent cell is 8x8 pixels,
as FLUX.1-fill's mask shuffle needs), in fp32, with the same seeded weights.
The tokenizers take crc32 word ids (tests/test_torch_port_inpaint.py), so
every process feeds the same ids.

Tolerances: the transformer forward 1e-4 absolute plus 1e-4 relative (as
tests/test_torch_port_flux.py); two LoRA steps (cached text, guidance 3.5,
CLIP-L and T5 dropout 0.5, the reference's draws replayed) on a batch from
each side's loader (64x64 images of other sizes, masks, one `-condlabel`
file): the batch's conditioning latent 1e-4 absolute and its 64-channel
mask exactly, the loss and grad norm 1e-4 relative, each group's adapters
1e-4 relative L2 (1e-3 on the NF4 base); the sampler's decoded latents
1e-4 absolute and the image within 2 levels (as
tests/test_torch_port_flux_sample.py); the diffusers directory's tensors
bitwise. Torch runs one thread.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.concept_config import ConceptConfig
from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.data import loader as jax_loader
from onetrainer_tpu.models import flux as jax_flux
from onetrainer_tpu.models import flux_model as jax_flux_model
from onetrainer_tpu.models.vae import AutoencoderKL, VAEConfig
from onetrainer_tpu.sampling.flux_sampler import sample_flux
from onetrainer_tpu.sampling.sd_sampler import sample_rng_for
from onetrainer_tpu.setup import flux_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import SDTokenizer, T5TokenizerWrapper
from onetrainer_tpu.util.enums import DataType, ModelType
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.data import loader as pt_loader
from onetrainer_tpu_torch.io.weights import flux_params_from_flax, lora_params_from_jax
from onetrainer_tpu_torch.models.flux_model import create_flux_model
from onetrainer_tpu_torch.ops.quant import NF4Array
from onetrainer_tpu_torch.sampling import flux_sampler as pt_sampler
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.setup.tokenizer import T5TokenizerWrapper as PortT5Tokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_flux import tiny_flux_config, tiny_flux_model
from tests.test_torch_port_flux import (
    ATOL, RTOL, T5_LENGTH, _configs, _jax_draws, port_flux_like, random_flux_params,
)
from tests.test_torch_port_flux_entry import _reference_state_dicts, write_flux_dir
from tests.test_torch_port_flux_sample import IMAGE_LEVELS, LATENT_ATOL
from tests.test_torch_port_inpaint import _inpaint_dataset, _write_inputs, crc32_words
from tests.test_torch_port_sd3_sample import _DecodeRecorder
from tests.test_torch_port_train_sdxl import (
    CACHE_ATOL, QLORA_REL, REL, SEED, STEPS, _assert_matches_reference,
)

FILL = ModelType.FLUX_FILL_DEV_1
SIZE = 64
FILL_GUIDANCE = 30.0   # the sampling guidance BFL's FLUX.1-Fill-dev card suggests


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokenizers(clip_cls, t5_cls):
    return (crc32_words(clip_cls(None, max_length=16, vocab_size=100, bos=98, eos=99)),
            crc32_words(t5_cls(None, max_length=T5_LENGTH, vocab_size=110)))


def tiny_fill_model():
    """tests/test_flux.py's tiny FLUX as FLUX.1-fill: 4 latent channels
    packed to 16, so 16 + 16 + 256 = 288 input channels, the output 16
    wide; a VAE of four 32-wide levels (8x8 pixels per latent cell)."""
    model = tiny_flux_model()
    model.model_type = FILL
    model.transformer_config = tiny_flux_config(in_channels=288, out_channels=16)
    model.vae_config = VAEConfig(block_out_channels=(32, 32, 32, 32), layers_per_block=1,
                                 latent_channels=4, scaling_factor=0.3611,
                                 shift_factor=0.1159, dtype=jnp.float32)
    return model


def tiny_fill_pair(seed: int = 1, **transformer_overrides):
    """(the reference's tiny FLUX.1-fill with weights, its flax params as
    numpy, the port's model with the same configs and weights)."""
    jax_model = tiny_fill_model()
    port = port_flux_like(jax_model, **transformer_overrides)
    params = random_flux_params(port, seed)
    flux_params_from_flax(port, *params)
    (jax_model.transformer_params, jax_model.te_params, jax_model.te2_params,
     jax_model.vae_params) = jax.tree.map(jnp.asarray, params)
    jax_model.tokenizer, jax_model.tokenizer_2 = _tokenizers(SDTokenizer, T5TokenizerWrapper)
    port.tokenizer, port.tokenizer_2 = _tokenizers(PortSDTokenizer, PortT5Tokenizer)
    return jax_model, params, port


def test_fill_configs_match_jax():
    """create_flux_model(FLUX_FILL_DEV_1) at the published widths: the
    reference's configurations, a 384-wide x_embedder, the output 64 wide;
    get_family takes the type."""
    ref = jax_flux_model.create_flux_model(FILL)
    port = create_flux_model(pt_enums.ModelType.FLUX_FILL_DEV_1, device="meta")
    for name in ("transformer_config", "vae_config", "te_config", "te2_config"):
        ours, theirs = getattr(port, name), getattr(ref, name)
        for field in dataclasses.fields(ours):
            if field.name not in ("dtype", "remat_policy"):
                assert getattr(ours, field.name) == getattr(theirs, field.name), \
                    (name, field.name)
    assert ref.transformer_config == jax_flux.flux_fill_config()
    assert tuple(port.transformer.x_embedder.weight.shape) == (3072, 384)
    assert tuple(port.transformer.proj_out.weight.shape) == (64, 3072)
    assert get_family(pt_enums.ModelType.FLUX_FILL_DEV_1).name == "flux"


def test_fill_transformer_forward_matches_jax():
    jax_model, params, port = tiny_fill_pair(seed=2)
    rng = np.random.default_rng(3)
    args = (rng.standard_normal((2, 16, 288)).astype(np.float32),
            np.asarray([0.25, 0.9], np.float32),
            rng.standard_normal((2, 20)).astype(np.float32),
            rng.standard_normal((2, 6, 24)).astype(np.float32),
            np.asarray(jax_flux.prepare_latent_image_ids(8, 8)))
    g = np.asarray([30.0, 3.5], np.float32)
    want = jax_flux.FluxTransformer2D(jax_model.transformer_config).apply(
        {"params": params[0]}, *map(jnp.asarray, args), None, jnp.asarray(g))
    with torch.no_grad():
        got = port.transformer(*map(torch.from_numpy, args), None, torch.from_numpy(g))
    assert got.shape == (2, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# -- two LoRA steps on the loaders' batches -----------------------------------------------

_CASES = {"cached_text": DataType.FLOAT_32, "cached_text_nf4": DataType.NFLOAT_4}


def _fill_configs(root: str, base_dtype):
    config, _ = _configs(False, base_dtype)
    config.model_type = FILL
    config.resolution = str(SIZE)
    config.aspect_ratio_bucketing = False
    config.latent_caching = False
    config.custom_conditioning_image = True
    config.unmasked_probability = 0.0
    concept = ConceptConfig.default_values()
    concept.path = root
    concept.seed = 42
    config.concepts = [concept]
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _loader(module, config, encode_images, encode_text):
    return module.Text2ImageDataLoader(config, encode_images, encode_text, quantization=64,
                                       latent_scale=8, conditioning_image=True,
                                       fill_mask_channels=True)


def _reference(case: str, root: str) -> dict:
    jax_model, params, _ = tiny_fill_pair()
    config, port_config = _fill_configs(root, _CASES[case])
    setup = jax_setup.create_flux_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    loader = _loader(jax_loader, config, *jax_setup.make_flux_encode_fns(setup))
    plan = loader.batches_for_epoch(0)[0]
    batch = loader.materialize_batch(plan)
    assert batch["latent_mask"].shape == (2, 8, 8, 64)
    assert batch["latent_conditioning_image"].shape == (2, 8, 8, 4)
    jbatch = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = _jax_draws(setup.step_cfg, jbatch, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, jbatch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(case=case, params=params, init=init, batch=batch, steps=steps,
                plan=[s.entry_index for s in plan], port_config=port_config)


@pytest.fixture(scope="module")
def fill_dataset(tmp_path_factory):
    """Three masked images at sizes other than 64x64, one with a
    `-condlabel` file (every image masked: tests/test_torch_port_inpaint.py
    says why)."""
    return _inpaint_dataset(str(tmp_path_factory.mktemp("fill")),
                            sizes=((80, 70), (64, 96), (75, 75)), cond=0, unmasked=None)


@pytest.fixture(scope="module", params=list(_CASES))
def reference(request, fill_dataset):
    return _reference(request.param, fill_dataset)


def test_fill_lora_steps_match_jax(reference):
    ref = reference
    port = port_flux_like(tiny_fill_model())
    flux_params_from_flax(port, *ref["params"])
    port.tokenizer, port.tokenizer_2 = _tokenizers(PortSDTokenizer, PortT5Tokenizer)
    family = get_family(ref["port_config"].model_type)
    setup = family.create_setup(port, ref["port_config"], 10)
    if ref["case"] == "cached_text_nf4":   # 288 x 32: above the policy's 4096 elements
        assert isinstance(port.transformer.x_embedder.weight, NF4Array)
    with torch.no_grad():
        for group, adapters in ref["init"].items():
            for key, entry in lora_params_from_jax(adapters, device="cpu").items():
                for name, value in entry.items():
                    setup.state.params[group][key][name].copy_(value)
    assert "x_embedder" in setup.state.params["transformer_lora"]
    loader = _loader(pt_loader, ref["port_config"], *family.make_encode_fns(setup))
    plan = loader.batches_for_epoch(0)[0]
    assert [s.entry_index for s in plan] == ref["plan"]
    batch = loader.materialize_batch(plan)
    assert list(batch) == list(ref["batch"])
    for name, value in ref["batch"].items():
        got = batch[name].numpy()
        if name == "latent_mask" or not np.issubdtype(value.dtype, np.floating):
            np.testing.assert_array_equal(got, value, err_msg=name)
        else:
            np.testing.assert_allclose(got, value, atol=CACHE_ATOL, rtol=0, err_msg=name)
    widths = []
    hook = port.transformer.register_forward_pre_hook(
        lambda module, args: widths.append(args[0].shape[-1]))
    gen = torch.Generator().manual_seed(0)
    metrics = []
    try:
        for ref_step in ref["steps"]:
            draws = {k: torch.from_numpy(v.copy()) for k, v in ref_step["draws"].items()
                     if k != "dropout_keep"}
            draws["dropout_keep"] = tuple(torch.from_numpy(m.copy())
                                          for m in ref_step["draws"]["dropout_keep"])
            out = setup.train_step(setup.state, batch, gen, **draws)
            metrics.append({k: float(v) for k, v in out.items()})
    finally:
        hook.remove()
    assert widths == [288] * STEPS
    rel = QLORA_REL if ref["case"] == "cached_text_nf4" else REL
    _assert_matches_reference(ref, setup, metrics, params_rel=rel, norm_rel=rel)


# -- the sampler -------------------------------------------------------------------------

@pytest.mark.parametrize("guidance", [FILL_GUIDANCE, 3.5], ids=["guidance_30", "guidance_3.5"])
def test_fill_sample_matches_jax(monkeypatch, tmp_path, guidance):
    """Fill sampling from a base image and mask at another size than the
    sample's. At guidance 30 the guidance features' angles reach 30 x 1000
    rad, where XLA's and ATen's fp32 frequency tables differ by an ulp and
    move the latents by 2.6e-4 (F11's mechanism,
    tests/test_torch_port_hunyuan.py); there both sides take one frequency
    table, as the HunyuanVideo tests do. At 3.5 each side keeps its own."""
    jax_model, _, port = tiny_fill_pair(seed=3)
    if guidance > 10:
        from onetrainer_tpu_torch.models import flux as pt_flux
        from tests.test_torch_port_hunyuan import _jax_table_features, _port_table_features
        monkeypatch.setattr(jax_flux, "timestep_embedding", _jax_table_features)
        monkeypatch.setattr(pt_flux, "timestep_embedding", _port_table_features)
    sc = SampleConfig.default_values()
    sc.prompt = "a red cube on a wooden table"
    sc.height = sc.width = SIZE
    sc.diffusion_steps = 3
    sc.cfg_scale = guidance
    sc.seed = 11
    sc.sample_inpainting = True
    sc.base_image_path, sc.mask_image_path = _write_inputs(str(tmp_path))
    jax_seen, port_seen = [], []
    monkeypatch.setattr(type(jax_model), "vae", property(
        lambda self: _DecodeRecorder(AutoencoderKL(self.vae_config), jax_seen)))
    m = jax_model
    want = sample_flux(m, m.transformer_params, m.te_params, m.te2_params, m.vae_params,
                       m.tokenizer, m.tokenizer_2, sc)
    vc = jax_model.vae_config
    latent = SIZE // vc.spatial_scale
    _, noise_rng = jax.random.split(sample_rng_for(sc))
    initial = np.asarray(jax.random.normal(noise_rng, (1, latent, latent,
                                                       vc.latent_channels), jnp.float32))
    setup, family = _sampling_setup(port)
    monkeypatch.setattr(pt_sampler, "_initial_latents",
                        lambda shape, generator, device: torch.from_numpy(initial.copy()))
    decode = port.vae.decode
    monkeypatch.setattr(port.vae, "decode",
                        lambda z: port_seen.append(z.numpy().copy()) or decode(z))
    widths = []
    hook = port.transformer.register_forward_pre_hook(
        lambda module, args: widths.append(args[0].shape[-1]))
    try:
        got = family.sample(setup, PortSampleConfig.default_values().from_dict(sc.to_dict()),
                            None)
    finally:
        hook.remove()
    assert widths == [288] * sc.diffusion_steps
    # the reference's VAE applications: the conditioning encode, then the decode
    assert len(port_seen) == 1 and len(jax_seen) == 2
    np.testing.assert_allclose(port_seen[0], jax_seen[-1], atol=LATENT_ATOL, rtol=0)
    assert got.image.shape == want.image.shape == (SIZE, SIZE, 3)
    diff = np.abs(got.image.astype(np.int32) - want.image.astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS and want.image.std() > 0


def _sampling_setup(port):
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.FLUX_FILL_DEV_1
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    return family.create_setup(port, config, 1), family


def test_fill_sample_without_inputs_takes_a_black_image_and_a_full_mask(monkeypatch):
    """Without `sample_inpainting` the transformer's extra channels are the
    shifted and scaled encode of a black image and an all-ones mask, as the
    reference feeds them. (Not held to the reference's latents: this tiny
    random VAE's encode of a constant image moves by 0.3 when its input
    moves by 1e-6, on either side.)"""
    _, _, port = tiny_fill_pair(seed=3)
    setup, family = _sampling_setup(port)
    seen = []
    hook = port.transformer.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].clone()))
    sc = PortSampleConfig.default_values()
    sc.height = sc.width = SIZE
    sc.diffusion_steps = 2
    sc.cfg_scale = FILL_GUIDANCE
    try:
        out = family.sample(setup, sc, None)
    finally:
        hook.remove()
    vc = port.vae_config
    with torch.no_grad():
        latent, _ = port.vae.encode(torch.zeros((1, SIZE, SIZE, 3)))
    cond = pt_sampler.pack_latents((latent - vc.shift_factor) * vc.scaling_factor)
    assert len(seen) == 2
    for x in seen:
        assert x.shape == (1, 16, 288)
        assert torch.equal(x[..., 16:32], cond)
        assert torch.equal(x[..., 32:], torch.ones((1, 16, 256)))
    assert out.image.shape == (SIZE, SIZE, 3) and out.image.dtype == np.uint8


# -- the diffusers directory ---------------------------------------------------------------

def test_fill_directory_loads_and_saves_as_the_reference(tmp_path):
    """A FLUX.1-fill diffusers directory (the transformer's config with
    in_channels 288, sharded) loads into the port bitwise as into the
    reference, the 288-wide x_embedder included, and the port's save reads
    back into the reference unchanged; so does its BFL single file (ported
    in the DiT fine-tune slice), into the port and into the reference."""
    _, _, port = tiny_fill_pair(seed=6)
    base = str(tmp_path / "ckpt")
    write_flux_dir(base, port)
    config = PortTrainConfig.default_values()
    config.model_type = pt_enums.ModelType.FLUX_FILL_DEV_1
    config.training_method = pt_enums.TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    config.train_dtype = pt_enums.DataType.FLOAT_32
    family = get_family(config.model_type)
    model = family.load(base, config, device="cpu")
    assert model.model_type == pt_enums.ModelType.FLUX_FILL_DEV_1
    assert model.transformer_config.in_channels == 288
    assert model.transformer_config.out_channels == 16
    ref = _reference_state_dicts(base)
    assert ref["transformer"]["x_embedder.weight"].shape == (32, 288)
    for name, module in model.modules().items():
        got = module.state_dict()
        assert set(got) == set(ref[name]), name
        for key, value in ref[name].items():
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    setup = family.create_setup(model, config, 1)
    out = str(tmp_path / "saved")
    family.save_model(setup, out, base)
    saved = _reference_state_dicts(out)
    for name, module in model.modules().items():
        for key, value in module.state_dict().items():
            np.testing.assert_array_equal(np.asarray(saved[name][key]), value.numpy(),
                                          err_msg=key)
    single = str(tmp_path / "fill.safetensors")
    family.save_single_file(setup, single)
    again = family.load(single, config, device="cpu")
    assert again.transformer_config.in_channels == 288
    for name, module in model.modules().items():
        for key, value in module.state_dict().items():
            assert torch.equal(again.modules()[name].state_dict()[key], value), key
    from onetrainer_tpu.io.single_file import load_flux_single_file
    from onetrainer_tpu.io.torch_flax import unet_flax_to_state_dict
    ref_single = load_flux_single_file(single, compute_dtype=jnp.float32, device=False)
    assert ref_single["transformer_config"].in_channels == 288
    for key, value in unet_flax_to_state_dict(ref_single["transformer_params"]).items():
        np.testing.assert_array_equal(np.asarray(value),
                                      model.transformer.state_dict()[key].numpy(), err_msg=key)
