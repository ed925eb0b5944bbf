"""Parity of the torch port's SD3 slice with the reference
(onetrainer_tpu/models/{sd3,t5,clip}.py, math/losses.py
`flow_matching_losses`, setup/sd3_setup.py `create_sd3_setup` and
train/sd3_train_step.py `make_sd3_train_step`).

Both sides run tests/test_sd3.py's tiny SD3 (two joint blocks of two d=16
heads; CLIP-L 6 wide and CLIP-G 10 wide, both projected; a two-layer T5
24 wide; a 4-channel VAE), in fp32, with the same seeded weights (the
port's state dicts through the reference's key maps, then
`io.weights.sd3_params_from_flax`). A `qk_norm` case adds SD3.5's RMS q/k
norms.

The LoRA steps run both setups from one config (the reference's
`TrainConfig` carried into the port's by `to_dict`/`from_dict`): LoRA r4
a8 on the transformer, CLIP-L and CLIP-G dropout 0.5 and T5 dropout 0.5,
two steps; once with the text cached by each side's `make_sd3_encode_fns`
and once with CLIP-L and CLIP-G trained (text encoded in the step). Torch
and JAX draw different numbers, so the reference's key splits
(`train_step` :199, `loss_fn` :183, `sd3_predict` :122 and the dropout
key :139) are replayed to get its timesteps, noise, latent-sampling noise
and per-encoder keep masks, and the port's step takes them.

Tolerances: forwards 1e-4 absolute plus 1e-4 relative (fp32 networks,
summed in another order); the text caches 1e-4 absolute; the loss and the
grad norm 1e-4 relative and each group's adapters 1e-4 relative L2 after
two steps (as tests/test_torch_port_train_sdxl.py states them);
`flow_matching_losses` 1e-6 relative. The checkpoint policies: the LoRA
gradients of one step with "full" and "dots_nb_attn" equal those without
checkpointing to 1e-6 relative L2 (the recompute runs the same ops; the
selective policy keeps some of their outputs instead).

The reference setups are built once per module; torch runs one thread.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.math.losses import LossConfig as JaxLossConfig
from onetrainer_tpu.math.losses import flow_matching_losses as jax_flow_losses
from onetrainer_tpu.models.clip import CLIPTextModel as JaxCLIP
from onetrainer_tpu.models.sd3 import SD3Transformer2D as JaxSD3
from onetrainer_tpu.models.sd3 import sd3_text_context as jax_text_context
from onetrainer_tpu.models.t5 import T5Encoder as JaxT5
from onetrainer_tpu.setup import sd3_setup as jax_setup
from onetrainer_tpu.setup.tokenizer import SDTokenizer, T5TokenizerWrapper
from onetrainer_tpu.train.sd_train_step import conditioning_dropout_mask as jax_keep
from onetrainer_tpu.util.enums import LossWeight, ModelType, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io.sd3_checkpoints import save_sd3_diffusers
from onetrainer_tpu_torch.io.weights import lora_params_from_jax, sd3_params_from_flax
from onetrainer_tpu_torch.math import losses as pt_losses
from onetrainer_tpu_torch.models import clip as pt_clip
from onetrainer_tpu_torch.models import sd3 as pt_sd3
from onetrainer_tpu_torch.models import t5 as pt_t5
from onetrainer_tpu_torch.models import vae as pt_vae
from onetrainer_tpu_torch.models.sd3_model import StableDiffusion3Model
from onetrainer_tpu_torch.setup.families import get_family
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.setup.tokenizer import T5TokenizerWrapper as PortT5Tokenizer
from onetrainer_tpu_torch.train.train_state import param_groups
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_sd3 import tiny_sd3_config, tiny_sd3_model
from tests.test_torch_port_models import _port_config, _random_like
from tests.test_torch_port_train_sdxl import (
    CACHE_ATOL, PROMPTS, SEED, STEPS, _assert_matches_reference, _jax_draws, _rel,
)

ATOL = RTOL = 1e-4
T5_LENGTH = 12
DROPOUT = 0.5


def _tokenizers(clip_cls, t5_cls):
    return (clip_cls(None, max_length=16, vocab_size=100, bos=98, eos=99),
            clip_cls(None, max_length=16, vocab_size=100, bos=98, eos=99),
            t5_cls(None, max_length=T5_LENGTH, vocab_size=110))


def port_sd3_like(jax_model, device="cpu", **transformer_overrides) -> StableDiffusion3Model:
    """The port's SD3 with the reference model's (tiny) configs."""
    tcfg = dataclasses.replace(
        _port_config(pt_sd3.SD3Config, jax_model.transformer_config),
        **transformer_overrides)
    return StableDiffusion3Model(
        model_type=pt_enums.ModelType(jax_model.model_type.value),
        transformer_config=tcfg,
        vae_config=_port_config(pt_vae.VAEConfig, jax_model.vae_config),
        te_config=_port_config(pt_clip.CLIPTextConfig, jax_model.te_config),
        te2_config=_port_config(pt_clip.CLIPTextConfig, jax_model.te2_config),
        te3_config=_port_config(pt_t5.T5Config, jax_model.te3_config),
        device=device)


def random_sd3_params(port, seed: int = 1) -> tuple:
    """Seeded weights for every parameter of the port's SD3, as the
    reference's flax trees (numpy): (transformer, te, te2, te3, vae)."""
    rng = np.random.default_rng(seed)
    sd = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
          for name, m in port.modules().items()}
    return (jax_tf.unet_state_dict_to_flax(sd["transformer"]),
            jax_tf.clip_state_dict_to_flax(sd["text_encoder"]),
            jax_tf.clip_state_dict_to_flax(sd["text_encoder_2"]),
            jax_tf.t5_state_dict_to_flax(sd["text_encoder_3"]),
            jax_tf.vae_state_dict_to_flax(sd["vae"]))


def tiny_sd3_pair(seed: int = 1, **transformer_overrides):
    """(the reference's tiny SD3 with weights, its flax params as numpy,
    the port's model with the same configs and weights)."""
    jax_model = tiny_sd3_model()
    port = port_sd3_like(jax_model, **transformer_overrides)
    params = random_sd3_params(port, seed)
    sd3_params_from_flax(port, *params)
    (jax_model.transformer_params, jax_model.te_params, jax_model.te2_params,
     jax_model.te3_params, jax_model.vae_params) = jax.tree.map(jnp.asarray, params)
    jax_model.tokenizer, jax_model.tokenizer_2, jax_model.tokenizer_3 = _tokenizers(
        SDTokenizer, T5TokenizerWrapper)
    port.tokenizer, port.tokenizer_2, port.tokenizer_3 = _tokenizers(
        PortSDTokenizer, PortT5Tokenizer)
    return jax_model, params, port


def sd3_config_jsons(model) -> dict:
    """Each component's config.json (diffusers' and transformers' keys) for
    a diffusers SD3 directory of the port's `model`."""
    t, v, t5 = model.transformer_config, model.vae_config, model.te3_config

    def clip(c):
        return {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                "intermediate_size": c.intermediate_size, "num_hidden_layers": c.num_layers,
                "num_attention_heads": c.num_heads,
                "max_position_embeddings": c.max_position_embeddings,
                "hidden_act": c.hidden_act, "eos_token_id": c.eos_token_id,
                "projection_dim": c.projection_dim,
                "architectures": ["CLIPTextModelWithProjection"]}
    return {
        "transformer": {
            "sample_size": t.sample_size, "patch_size": t.patch_size,
            "in_channels": t.in_channels, "out_channels": t.out_channels,
            "num_layers": t.num_layers, "num_attention_heads": t.num_heads,
            "attention_head_dim": t.head_dim, "joint_attention_dim": t.joint_attention_dim,
            "caption_projection_dim": t.caption_projection_dim,
            "pooled_projection_dim": t.pooled_projection_dim,
            "pos_embed_max_size": t.pos_embed_max_size,
            "qk_norm": "rms_norm" if t.qk_norm else None, "dual_attention_layers": []},
        "vae": {"in_channels": v.in_channels, "out_channels": v.out_channels,
                "latent_channels": v.latent_channels,
                "block_out_channels": list(v.block_out_channels),
                "layers_per_block": v.layers_per_block, "scaling_factor": v.scaling_factor,
                "shift_factor": v.shift_factor},
        "text_encoder": clip(model.te_config), "text_encoder_2": clip(model.te2_config),
        "text_encoder_3": {"vocab_size": t5.vocab_size, "d_model": t5.d_model,
                           "d_kv": t5.d_kv, "d_ff": t5.d_ff, "num_layers": t5.num_layers,
                           "num_heads": t5.num_heads},
    }


def write_sd3_dir(base: str, model, parts=None) -> None:
    """The port's SD3 `model` as a diffusers directory (fp32), its configs
    beside the weights; `parts` limits the components written."""
    configs = sd3_config_jsons(model)
    sds = {name: m.state_dict() for name, m in model.modules().items()}
    save_sd3_diffusers(base, model, sds["transformer"], sds["vae"], sds["text_encoder"],
                       sds["text_encoder_2"], sds["text_encoder_3"])
    for name, config in configs.items():
        if parts is not None and name not in parts:
            shutil.rmtree(os.path.join(base, name))
            continue
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(config, f)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(port: torch.Tensor, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


def _inputs(seed=3, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 8, 8, 4)).astype(np.float32),
            np.asarray([100.0, 500.0][:batch], np.float32),
            rng.standard_normal((batch, 16)).astype(np.float32),
            rng.standard_normal((batch, 10, 24)).astype(np.float32))


@pytest.mark.parametrize("qk_norm", [False, True], ids=["sd3", "qk_norm"])
def test_transformer_forward_matches_jax(qk_norm):
    jax_model = tiny_sd3_model()
    jax_cfg = tiny_sd3_config(pooled_projection_dim=16, qk_norm=qk_norm)
    jax_model.transformer_config = jax_cfg
    port = port_sd3_like(jax_model)
    params = random_sd3_params(port, seed=2)
    sd3_params_from_flax(port, *params)
    if qk_norm:
        assert "transformer_blocks.0.attn.norm_added_k.weight" in \
            port.transformer.state_dict()
    # the last block is context-pre-only: no to_add_out, no ff_context
    last = port.transformer.transformer_blocks[-1]
    assert last.attn.to_add_out is None and last.ff_context is None
    args = _inputs()
    want = JaxSD3(jax_cfg).apply({"params": params[0]}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = port.transformer(*map(torch.from_numpy, args))
    assert got.shape == (2, 8, 8, 4) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("layer_skip", [0, 1])
def test_t5_encoder_matches_jax(layer_skip):
    jax_model, params, port = tiny_sd3_pair()
    ids = np.asarray([[5, 17, 90, 3, 1, 0, 0, 0, 0, 0, 0, 0],
                      [4, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    want = JaxT5(jax_model.te3_config).apply({"params": params[3]}, jnp.asarray(ids),
                                             layer_skip=layer_skip)
    with torch.no_grad():
        got = port.text_encoder_3(torch.from_numpy(ids), layer_skip=layer_skip)
    assert got.shape == (2, 12, 24)
    _close(got, want)


def test_relative_position_buckets_match_jax():
    from onetrainer_tpu.models.t5 import _relative_position_bucket
    rel = np.arange(-300, 301, dtype=np.int32)
    np.testing.assert_array_equal(
        pt_t5.relative_position_bucket(torch.from_numpy(rel)).numpy(),
        np.asarray(_relative_position_bucket(jnp.asarray(rel))))


def test_clip_l_with_projection_matches_jax():
    """SD3's CLIP-L projects its pooled output (projection_dim 768 at full
    width, 6 here): hidden states and pooled output as the reference."""
    jax_model, params, port = tiny_sd3_pair()
    assert port.te_config.projection_dim == jax_model.te_config.projection_dim == 6
    ids = np.asarray([[98, 5, 7, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99]],
                     np.int32)
    want = JaxCLIP(jax_model.te_config).apply({"params": params[1]}, jnp.asarray(ids))
    with torch.no_grad():
        got = port.text_encoder(torch.from_numpy(ids))
    _close(got["pooled_output"], want["pooled_output"])
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        _close(g, w)


def test_sd3_text_context_matches_jax():
    rng = np.random.default_rng(4)
    parts = [rng.standard_normal(s).astype(np.float32)
             for s in ((2, 16, 6), (2, 16, 10), (2, 12, 24), (2, 6), (2, 10))]
    want = jax_text_context(*map(jnp.asarray, parts))
    got = pt_sd3.sd3_text_context(*map(torch.from_numpy, parts))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("weight,masked", [(LossWeight.CONSTANT, False),
                                           (LossWeight.SIGMA, False),
                                           (LossWeight.SIGMA, True)],
                         ids=["constant", "sigma", "sigma_masked"])
def test_flow_matching_losses_match_jax(weight, masked):
    rng = np.random.default_rng(5)
    batch = {"loss_weight": np.asarray([1.0, 0.5], np.float32),
             "latent_mask": rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)}
    data = {"predicted": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
            "target": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
            "timestep": np.asarray([10, 900], np.int32)}
    kw = dict(mse_strength=1.0, mae_strength=0.5, log_cosh_strength=0.25,
              masked_training=masked, raw_masked_training=masked,
              normalize_masked_area_loss=masked, unmasked_weight=0.2)
    want = jax_flow_losses(jax.tree.map(jnp.asarray, batch), jax.tree.map(jnp.asarray, data),
                           JaxLossConfig(loss_weight_fn=weight, **kw))
    got = pt_losses.flow_matching_losses(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(v) for k, v in data.items()},
        pt_losses.LossConfig(loss_weight_fn=pt_enums.LossWeight(weight.value), **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- two LoRA steps through the setups ---------------------------------------------

def _configs(train_te: bool):
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_3
    config.training_method = TrainingMethod.LORA
    config.batch_size = 2
    config.lora_rank = 4
    config.lora_alpha = 8.0
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.prior.train = True
    config.text_encoder.train = config.text_encoder_2.train = train_te
    for part in (config.text_encoder, config.text_encoder_2, config.text_encoder_3):
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


def _jax_keep_masks(step_cfg, rng, step, b):
    """The per-encoder keep masks of the reference's step `step`:
    `sd3_conditioning`'s draws from fold_in(rng_predict, 0xd0)."""
    rng_loss, _ = jax.random.split(jax.random.fold_in(rng, step))
    _, rng_predict = jax.random.split(rng_loss)
    dropout_rng = jax.random.fold_in(rng_predict, 0xd0)
    return tuple(
        np.asarray(jax_keep(jax.random.fold_in(dropout_rng, i), b, p)) if p > 0 else None
        for i, p in enumerate((step_cfg.te_dropout, step_cfg.te2_dropout,
                               step_cfg.te3_dropout)))


def _reference(train_te: bool) -> dict:
    jax_model, params, _ = tiny_sd3_pair()
    config, port_config = _configs(train_te)
    setup = jax_setup.create_sd3_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    images = _images()
    encode_images, encode_text = jax_setup.make_sd3_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, encode_text, images,
                                             jnp.asarray))
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        draws = _jax_draws(setup.step_cfg, batch, rng, step)
        draws["dropout_keep"] = _jax_keep_masks(setup.step_cfg, rng, step, 2)
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(train_te=train_te, params=params, init=init, images=images,
                batch=jax.device_get(batch), steps=steps, port_config=port_config)


_REFERENCES: dict = {}


def _reference_once(train_te: bool) -> dict:
    if train_te not in _REFERENCES:
        _REFERENCES[train_te] = _reference(train_te)
    return _REFERENCES[train_te]


@pytest.fixture(scope="module", params=[False, True], ids=["cached_text", "live_text"])
def reference(request):
    return _reference_once(request.param)


def _port_setup(ref, **transformer_overrides):
    """The port's setup through the registry, with the reference's initial
    adapters, and its own cached batch (held to the reference's)."""
    jax_model = tiny_sd3_model()
    port = port_sd3_like(jax_model, **transformer_overrides)
    sd3_params_from_flax(port, *ref["params"])
    port.tokenizer, port.tokenizer_2, port.tokenizer_3 = _tokenizers(
        PortSDTokenizer, PortT5Tokenizer)
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
    return setup, batch


def _draws(ref_step) -> dict:
    draws = {k: torch.from_numpy(v.copy()) for k, v in ref_step["draws"].items()
             if k != "dropout_keep"}
    draws["dropout_keep"] = tuple(None if m is None else torch.from_numpy(m.copy())
                                  for m in ref_step["draws"]["dropout_keep"])
    return draws


def test_lora_steps_match_jax(reference):
    ref = reference
    setup, batch = _port_setup(ref)
    assert setup.step_cfg.vae_shift_factor == pytest.approx(0.0609)
    assert set(setup.state.params) == ({"transformer_lora", "te_lora", "te2_lora"}
                                       if ref["train_te"] else {"transformer_lora"})
    assert ("sd3_context" in batch) is not ref["train_te"]
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
    _assert_matches_reference(ref, setup, metrics)


@pytest.mark.parametrize("policy", ["full", "dots_nb_attn"])
def test_checkpoint_policies_give_the_gradients_of_no_checkpointing(policy):
    """One step's LoRA gradients under each ported policy against the same
    step without checkpointing, on the reference's first draws (text
    cached)."""
    reference = _reference_once(False)
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
        port_sd3_like(tiny_sd3_model(), gradient_checkpointing=True, remat_policy="dots")


def test_f9_reference_ignores_dual_attention_and_port_refuses(tmp_path):
    """F9: an SD3.5-medium transformer carries `dual_attention_layers` and
    per-block `attn2` weights. The reference's loader reads them and its
    model never uses them: changing every attn2 tensor leaves its output
    unchanged. The port's loader refuses the checkpoint (config or
    weights) instead of dropping them."""
    import json

    from onetrainer_tpu.io.sd3_checkpoints import load_sd3_diffusers as jax_load
    from onetrainer_tpu.io.sd3_checkpoints import sd3_config_from_diffusers as jax_cfg_of
    from onetrainer_tpu.io.safetensors_io import save_safetensors as jax_save
    from onetrainer_tpu_torch.io import sd3_checkpoints as pt_ckpt

    base = str(tmp_path / "sd35")
    _, _, port = tiny_sd3_pair()
    write_sd3_dir(base, port, parts=("transformer",))
    tdir = tmp_path / "sd35" / "transformer"
    cfg = json.loads((tdir / "config.json").read_text())
    cfg["dual_attention_layers"] = [0]
    (tdir / "config.json").write_text(json.dumps(cfg))
    weights = tdir / "diffusion_pytorch_model.safetensors"
    from onetrainer_tpu.io.safetensors_io import load_safetensors as jax_read
    sd = {k: np.asarray(v) for k, v in jax_read(str(weights)).items()}
    rng = np.random.default_rng(9)
    attn2 = {k.replace(".attn.", ".attn2."): rng.standard_normal(v.shape).astype(np.float32)
             for k, v in sd.items() if k.startswith("transformer_blocks.0.attn.")
             and "add_" not in k and "to_add_out" not in k}

    outs = []
    for scale in (1.0, -3.0):
        jax_save(str(weights), {**sd, **{k: v * scale for k, v in attn2.items()}})
        loaded = jax_load(base, weight_dtype=np.float32, compute_dtype=jnp.float32,
                          device=False)
        # the reference reads the attn2 tensors into its tree, and its
        # config keeps no trace of the dual-attention layers
        assert "attn2" in loaded["transformer_params"]["transformer_blocks_0"]
        assert jax_cfg_of(cfg) == jax_cfg_of({**cfg, "dual_attention_layers": []})
        tcfg = dataclasses.replace(loaded["transformer_config"], dtype=jnp.float32)
        args = [jnp.asarray(a) for a in _inputs()]
        outs.append(np.asarray(jax.jit(JaxSD3(tcfg).apply)(
            {"params": loaded["transformer_params"]}, *args)))
    np.testing.assert_array_equal(outs[0], outs[1])

    with pytest.raises(NotImplementedError, match="F9"):
        pt_ckpt.load_sd3_diffusers(base, device="cpu")
    cfg["dual_attention_layers"] = []
    (tdir / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="attn2.*F9"):
        pt_ckpt.load_sd3_diffusers(base, device="cpu")
