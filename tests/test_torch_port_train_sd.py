"""Parity of the torch port's SD 1.5/2.x LoRA training slice with the
reference (onetrainer_tpu/setup/sd_setup.py `create_sd_setup`, LORA
branch, and onetrainer_tpu/train/sd_train_step.py `make_sd_train_step`).

Both sides are built through their setup entry points from one config
(the reference's `TrainConfig`, carried into the port's copy by
`to_dict`/`from_dict`) on a tiny SD model of each shape with the same
weights (`io.weights.sd_params_from_flax`):
- SD 1.5-shaped: epsilon prediction, conv proj_in/proj_out, a quick_gelu
  text encoder read at its last layer, text embeddings cached;
- SD 2.x-shaped: v-prediction (the config's force_v_prediction), linear
  projections, a gelu text encoder read at its penultimate layer (layer
  skip 1), trained with LoRA and run inside the step on the batch's
  tokens.
The port's adapters are set to the reference's initial adapters
(`io.weights.lora_params_from_jax`), and its batch comes through its own
`make_encode_fns` from the same images and prompts. Torch and JAX draw
different numbers from one seed, so the reference's own key splits
(`train_step` :376, `loss_fn` :350, `sd_predict` :223) are replayed to get
the timesteps, diffusion noise and latent-sampling noise JAX drew, and the
port's step takes them as overrides. Both sides run fp32.

The UNet's first block is 64 channels wide, for the reason
tests/test_torch_port_train_sdxl.py gives (GroupNorm(32, 32) zeroes a
resnet's time_emb_proj gradient).

Tolerances, as tests/test_torch_port_train_sdxl.py states them: loss and
grad_norm 1e-4 relative; the LoRA tensors of each group 1e-4 relative L2
after two steps; cached latents and text embeddings 1e-4 absolute. An NF4
UNet config quantizes the port's UNet to the reference's codes and scales
bit for bit (every other UNet tensor bf16, equal).

The reference setups are built once per module; torch runs one thread
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.models.clip import CLIPTextConfig
from onetrainer_tpu.models.sd import StableDiffusionModel as JaxSDModel
from onetrainer_tpu.models.unet import UNetConfig
from onetrainer_tpu.models.vae import VAEConfig
from onetrainer_tpu.ops import quant as jax_quant
from onetrainer_tpu.setup import sd_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import SDTokenizer
from onetrainer_tpu.util.enums import DataType, ModelType, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.torch_flax import merge_int_tokens, unet_state_dict_to_flax
from onetrainer_tpu_torch.io.weights import lora_params_from_jax, sd_params_from_flax
from onetrainer_tpu_torch.models import clip as pt_clip
from onetrainer_tpu_torch.models import unet as pt_unet
from onetrainer_tpu_torch.models import vae as pt_vae
from onetrainer_tpu_torch.models.sd import StableDiffusionModel
from onetrainer_tpu_torch.ops import quant as pt_quant
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_models import _port_config, _random_like
from tests.test_torch_port_train_sdxl import (
    CACHE_ATOL, PROMPTS, SEED, STEPS, _assert_matches_reference, _jax_draws, _tok,
)

# shape -> (model type, UNet config overrides, text-encoder activation,
# layer skip, v-prediction forced, text encoder trained)
SHAPES = {
    "sd15": (ModelType.STABLE_DIFFUSION_15, {}, "quick_gelu", 0, False, False),
    "sd2": (ModelType.STABLE_DIFFUSION_21, {"use_linear_projection": True}, "gelu", 1,
            True, True),
}


def tiny_sd_pair(shape: str, seed: int = 1):
    """(the reference's tiny SD model of `shape`, its flax params (unet,
    te, vae) as numpy, the port's model with the same configs and weights)."""
    model_type, unet_kw, act, layer_skip, _, _ = SHAPES[shape]
    jax_model = JaxSDModel(
        model_type=model_type,
        unet_config=UNetConfig(
            block_out_channels=(64, 64), cross_attn_blocks=(True, False),
            layers_per_block=1, transformer_layers_per_block=(1, 1),
            num_heads=(4, 4), cross_attention_dim=32, dtype=jnp.float32, **unet_kw),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                             dtype=jnp.float32),
        te_config=CLIPTextConfig(
            vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, max_position_embeddings=16, eos_token_id=99,
            hidden_act=act, dtype=jnp.float32),
        text_encoder_layer_skip=layer_skip,
    )
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


def _configs(shape: str, nf4: bool = False):
    model_type, _, _, _, force_v, train_te = SHAPES[shape]
    config = TrainConfig.default_values()
    config.model_type = model_type
    config.training_method = TrainingMethod.LORA
    config.batch_size = 2
    config.lora_rank = 4
    config.lora_alpha = 8.0
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0   # lr > 0 from the first step
    config.force_v_prediction = force_v
    config.text_encoder.train = train_te
    if nf4:
        config.unet.weight_dtype = DataType.NFLOAT_4
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _images():
    rng = np.random.default_rng(SEED)
    return rng.uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32)


def _batch(encode_images, encode_text, images, as_array):
    """A batch of two from the caches: latents of `images`, one prompt per
    sample."""
    batch = {name: as_array(value) for name, value in encode_images(images).items()}
    texts = [encode_text(p) for p in PROMPTS]
    for name in texts[0]:
        batch[name] = as_array(np.stack([np.asarray(t[name]) for t in texts]))
    batch["loss_weight"] = as_array(np.ones((2,), np.float32))
    return batch


def _reference(shape: str) -> dict:
    """Two reference LoRA steps from the setup entry point."""
    jax_model, params, port = tiny_sd_pair(shape)
    config, port_config = _configs(shape)
    setup = jax_setup.create_sd_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    images = _images()
    encode_images, encode_text = jax_setup.make_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, encode_text, images,
                                             jnp.asarray))
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = _jax_draws(setup.step_cfg, batch, rng, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(shape=shape, jax_model=jax_model, setup=setup, init=init, images=images,
                batch=jax.device_get(batch), steps=steps, port=port,
                port_config=port_config)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=list(SHAPES))
def reference(request):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _reference(request.param)


def _port_run(ref):
    """The port's setup through the family registry from the same config
    and weights, the reference's initial adapters, its own cached batch,
    and two steps on the reference's draws. -> (setup, per-step metrics,
    lora_up max after step 1)."""
    port = ref["port"]
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
    assert set(batch) == set(ref["batch"])
    for name, value in ref["batch"].items():
        if np.issubdtype(np.asarray(value).dtype, np.floating):
            np.testing.assert_allclose(batch[name].numpy(), value, atol=CACHE_ATOL,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(batch[name].numpy(), value, err_msg=name)

    gen = torch.Generator().manual_seed(0)
    metrics, up_max = [], None
    for step, ref_step in enumerate(ref["steps"]):
        draws = {k: torch.from_numpy(v.copy()) for k, v in ref_step["draws"].items()}
        out = setup.train_step(setup.state, batch, gen, **draws)
        metrics.append({k: float(v) for k, v in out.items()})
        if step == 0:
            up_max = max(float(e["lora_up"].detach().abs().max())
                         for e in setup.state.params["unet_lora"].values())
    return setup, metrics, up_max


def test_lora_steps_match_jax(reference):
    ref = reference
    _, _, _, layer_skip, force_v, train_te = SHAPES[ref["shape"]]
    setup, metrics, up_max = _port_run(ref)
    model = setup.model
    assert model.prediction_type == ref["jax_model"].prediction_type == (
        "v_prediction" if force_v else "epsilon")
    assert setup.step_cfg.text_encoder_layer_skip == layer_skip
    assert set(setup.state.params) == ({"unet_lora", "te_lora"} if train_te
                                       else {"unet_lora"})
    # gradient-flow canary (tests/test_trainer_sdxl.py): lora_up starts at
    # zero, so a non-zero up after one step proves grads reached it
    assert up_max > 0.0
    _assert_matches_reference(ref, setup, metrics)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_nf4_unet_config_quantizes_like_the_reference(shape):
    """An NF4 UNet config quantizes the port's SD UNet in its setup to the
    codes and scales of the reference's quantize_tree on the same weights,
    bit for bit, and casts every other UNet tensor to bf16 as it does."""
    jax_model, params, port = tiny_sd_pair(shape)
    _, port_config = _configs(shape, nf4=True)
    get_family(port_config.model_type).create_setup(port, port_config, 10)
    frozen = jax.jit(lambda tree: jax_quant.quantize_tree(tree, "nf4"))(
        jax_model.unet_params)
    unet = port.unet
    n_quantized = 0
    for name, layer in unet.named_modules():
        w = getattr(layer, "weight", None)
        if not pt_quant.is_quantized(w):
            continue
        n_quantized += 1
        node = frozen
        for part in merge_int_tokens(name + ".kernel"):
            node = node[part]
        np.testing.assert_array_equal(w.q.numpy(), np.asarray(node.q), err_msg=name)
        np.testing.assert_array_equal(w.scales.numpy(), np.asarray(node.scales))
    assert n_quantized == sum(jax_quant.is_quantized(leaf) for leaf in jax.tree.leaves(
        frozen, is_leaf=jax_quant.is_quantized)) > 10
    rest = unet_state_dict_to_flax({k: v.float().numpy() for k, v in unet.state_dict().items()})
    for path, value in jax_tf._flatten(rest).items():
        node = frozen
        for part in path:
            node = node[part]
        assert node.dtype == jnp.bfloat16, path
        np.testing.assert_array_equal(value, np.asarray(node, np.float32), err_msg=str(path))


def test_setup_refuses_unported_methods():
    """EMBEDDING, FINE_TUNE_VAE and additional embeddings alongside
    FINE_TUNE, once refused, build trainers of the vectors, of the VAE and
    of the UNet beside the vectors (tests/test_torch_port_embedding.py and
    tests/test_torch_port_vae_ft.py hold them to the reference); FINE_TUNE_VAE
    of another family than SD 1.5/2.x still raises, as the reference has
    none; FINE_TUNE builds a trainer (tests/test_torch_port_train_finetune.py
    holds it to the reference), and a FINE_TUNE config that trains no part
    a sampling-only setup."""
    from onetrainer_tpu_torch.config.train_config import TrainEmbeddingConfig
    from onetrainer_tpu_torch.setup.sd_setup import refuse_unported
    _, config = _configs("sd15")
    family = get_family(config.model_type)
    method = pt_enums.TrainingMethod
    built = [(dict(training_method=method.EMBEDDING), {"embeddings"}),
             (dict(training_method=method.FINE_TUNE_VAE), {"vae"}),
             (dict(training_method=method.FINE_TUNE,
                   additional_embeddings=[TrainEmbeddingConfig.default_values()]),
              {"unet", "embeddings"})]
    for fields, groups in built:
        _, _, port = tiny_sd_pair("sd15")
        case = config.clone()
        for name, value in fields.items():
            setattr(case, name, value)
        setup = family.create_setup(port, case, 1)
        assert set(setup.state.params) == groups and setup.train_step is not None
    case = config.clone()
    case.training_method = method.FINE_TUNE_VAE
    case.model_type = pt_enums.ModelType.STABLE_DIFFUSION_XL_10_BASE
    with pytest.raises(NotImplementedError):
        refuse_unported(case)
    _, _, port = tiny_sd_pair("sd15")
    case = config.clone()
    case.training_method = pt_enums.TrainingMethod.FINE_TUNE
    case.unet.train = case.text_encoder.train = False
    setup = family.create_setup(port, case, 1)
    assert setup.train_step is None and setup.merged_inference_params() == (
        port.unet, port.text_encoder, None)
    case.unet.train = True
    setup = family.create_setup(port, case, 1)
    assert set(setup.state.params) == {"unet"} and setup.train_step is not None
