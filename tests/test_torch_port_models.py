"""Parity of the torch port's SDXL models (CLIP text encoders, UNet, VAE)
with the JAX reference, on tiny configs (tests/test_sdxl.py:tiny_sdxl_model)
with the reference's weights carried into the port by
onetrainer_tpu_torch/io/weights.py.

Both sides compute in fp32 with TF32 off; inputs are numpy arrays from a
seed. Tolerance: 1e-4 absolute plus 1e-4 relative, the rounding of a few
dozen fp32 matmuls and convolutions summed in another order (outputs are
O(1)).
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.io.torch_flax import (
    clip_state_dict_to_flax, unet_flax_to_state_dict, unet_state_dict_to_flax,
    vae_state_dict_to_flax,
)
from onetrainer_tpu_torch.io.weights import init_sdxl_weights, sdxl_params_from_flax
from onetrainer_tpu_torch.models import clip as pt_clip
from onetrainer_tpu_torch.models import unet as pt_unet
from onetrainer_tpu_torch.models import vae as pt_vae
from onetrainer_tpu_torch.models.sdxl import StableDiffusionXLModel
from onetrainer_tpu_torch.util.enums import ModelType
from tests.test_sdxl import tiny_sdxl_model

ATOL = RTOL = 1e-4


def _port_config(cls, ref_cfg):
    kwargs = {f.name: getattr(ref_cfg, f.name) for f in fields(cls)
              if f.name != "dtype"}
    return cls(**kwargs, dtype=torch.float32)


def port_model_like(jax_model, device="cpu") -> StableDiffusionXLModel:
    """The port's model with the reference model's (tiny) configs."""
    return StableDiffusionXLModel(
        model_type=ModelType(jax_model.model_type.value),
        unet_config=_port_config(pt_unet.UNetConfig, jax_model.unet_config),
        vae_config=_port_config(pt_vae.VAEConfig, jax_model.vae_config),
        te_config=_port_config(pt_clip.CLIPTextConfig, jax_model.te_config),
        te2_config=_port_config(pt_clip.CLIPTextConfig, jax_model.te2_config),
        device=device)


def _random_like(name: str, t: torch.Tensor, rng) -> np.ndarray:
    noise = rng.standard_normal(tuple(t.shape)).astype(np.float32)
    if t.dim() >= 2:                       # linear, conv, embedding tables
        return noise * t[0].numel() ** -0.5
    if name.endswith("weight"):            # norm scales
        return 1.0 + 0.05 * noise
    return 0.05 * noise                    # biases


def random_flax_params(port_model, seed=0):
    """Seeded random weights for every parameter of the port's model, as
    the reference's flax param trees (numpy): (unet, te, te2, vae). Built
    through the reference's torch->flax key maps."""
    rng = np.random.default_rng(seed)
    sd = {name: {k: _random_like(k, v, rng) for k, v in m.state_dict().items()}
          for name, m in port_model.modules().items()}
    return (unet_state_dict_to_flax(sd["unet"]),
            clip_state_dict_to_flax(sd["text_encoder"]),
            clip_state_dict_to_flax(sd["text_encoder_2"]),
            vae_state_dict_to_flax(sd["vae"]))


def tiny_pair(seed=0):
    """(reference tiny SDXL model, its flax params, the port's model with
    those params carried in by io/weights.py)."""
    jax_model = tiny_sdxl_model()
    port = port_model_like(jax_model)
    params = random_flax_params(port, seed)
    sdxl_params_from_flax(port, *params)   # overwrites every parameter
    return jax_model, params, port


@pytest.fixture(scope="module")
def tiny():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tiny_pair()


def _close(port: torch.Tensor, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def _tokens():
    return np.asarray([[98, 5, 7, 11, 99] + [99] * 11,
                       [98, 3, 99] + [99] * 13], np.int32)


@pytest.mark.parametrize("which", ["text_encoder", "text_encoder_2"])
def test_clip_matches_jax(tiny, which):
    jax_model, (_, te, te2, _), port = tiny
    params = te if which == "text_encoder" else te2
    tokens = _tokens()
    ref = jax.jit(getattr(jax_model, which).apply)({"params": params},
                                                  jnp.asarray(tokens))
    with torch.no_grad():
        out = getattr(port, which)(torch.from_numpy(tokens))
    assert len(out["hidden_states"]) == len(ref["hidden_states"])
    for a, b in zip(out["hidden_states"], ref["hidden_states"]):
        _close(a, b)
    _close(out["last_hidden_state"], ref["last_hidden_state"])
    _close(out["pooled_output"], ref["pooled_output"])


def test_clip_padding_mask_and_extra_embeddings_match_jax(tiny):
    """Textual-inversion rows appended to the token table (ids >= vocab)
    and a padding mask combined with the causal mask."""
    jax_model, (_, te, _, _), port = tiny
    tokens = np.asarray([[98, 100, 101, 7, 99] + [99] * 11,
                         [98, 102, 99] + [99] * 13], np.int32)
    mask = (np.arange(16)[None] < np.asarray([[5], [3]])).astype(np.int32)
    extra = np.random.default_rng(9).standard_normal((3, 32)).astype(np.float32)
    ref = jax.jit(jax_model.text_encoder.apply)(
        {"params": te}, jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(extra))
    with torch.no_grad():
        out = port.text_encoder(torch.from_numpy(tokens), torch.from_numpy(mask),
                                torch.from_numpy(extra))
    _close(out["last_hidden_state"], ref["last_hidden_state"])
    _close(out["pooled_output"], ref["pooled_output"])


def test_unet_matches_jax(tiny):
    jax_model, (unet, *_), port = tiny
    rng = np.random.default_rng(3)
    sample = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    ts = np.asarray([3, 700], np.int32)
    context = rng.standard_normal((2, 16, 80), dtype=np.float32)
    pooled = rng.standard_normal((2, 48), dtype=np.float32)
    time_ids = np.asarray([[128, 96, 0, 0, 128, 96], [64, 64, 8, 4, 64, 64]],
                          np.float32)
    ref = jax.jit(jax_model.unet.apply)({"params": unet}, *map(jnp.asarray, (
        sample, ts, context, pooled, time_ids)))
    with torch.no_grad():
        out = port.unet(*map(torch.from_numpy, (sample, ts, context, pooled,
                                                time_ids)))
    assert out.shape == (2, 16, 16, 4) and out.dtype == torch.float32
    _close(out, ref)


def test_unet_conv_projection_matches_jax():
    """The SD 1.x-style UNet branches SDXL does not take: 1x1-conv
    proj_in/proj_out, cross-attention in the top block, no addition
    embedding."""
    from onetrainer_tpu.models.unet import UNet2DCondition, UNetConfig
    cfg = dict(block_out_channels=(32, 64), cross_attn_blocks=(True, False),
               layers_per_block=1, num_heads=(2, 2), cross_attention_dim=24,
               use_linear_projection=False)
    ref_model = UNet2DCondition(UNetConfig(**cfg, dtype=jnp.float32))
    port = pt_unet.UNet2DCondition(pt_unet.UNetConfig(**cfg, dtype=torch.float32))
    rng = np.random.default_rng(8)
    params = unet_state_dict_to_flax(
        {k: _random_like(k, v, rng) for k, v in port.state_dict().items()})
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                          unet_flax_to_state_dict(params).items()}, strict=True)
    sample = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    ts = np.asarray([10, 900], np.int32)
    context = rng.standard_normal((2, 7, 24), dtype=np.float32)
    ref = jax.jit(ref_model.apply)({"params": params}, jnp.asarray(sample),
                                   jnp.asarray(ts), jnp.asarray(context))
    with torch.no_grad():
        out = port(torch.from_numpy(sample), torch.from_numpy(ts),
                   torch.from_numpy(context))
    _close(out, ref)


def test_vae_decode_matches_jax(tiny):
    jax_model, (*_, vae), port = tiny
    z = np.random.default_rng(4).standard_normal((1, 8, 8, 4), dtype=np.float32)
    ref = jax.jit(lambda p, z: jax_model.vae.apply(
        p, z, method=jax_model.vae.decode))({"params": vae}, jnp.asarray(z))
    with torch.no_grad():
        out = port.vae.decode(torch.from_numpy(z))
    assert out.shape == (1, 16, 16, 3)
    _close(out, ref)


def test_vae_encode_matches_jax(tiny):
    jax_model, (*_, vae), port = tiny
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    mean_ref, logvar_ref = jax.jit(lambda p, x: jax_model.vae.apply(
        p, x, method=jax_model.vae.encode))({"params": vae}, jnp.asarray(x))
    with torch.no_grad():
        mean, logvar = port.vae.encode(torch.from_numpy(x))
    assert mean.shape == (2, 8, 8, 4)
    _close(mean, mean_ref)
    _close(logvar, logvar_ref)


def test_weight_carry_matches_reference_trees(tiny):
    """The carried trees have exactly the reference modules' param
    structure and shapes, and state_dict() maps back onto them value for
    value through the reference's own key maps."""
    jax_model, (unet, te, te2, vae), port = tiny
    u = jax_model.unet_config
    rng = jax.random.PRNGKey(0)
    ids = jnp.zeros((1, 8), jnp.int32)
    expected = {
        "unet": jax.eval_shape(
            jax_model.unet.init, rng, jnp.zeros((1, 16, 16, u.in_channels)),
            jnp.asarray([1]), jnp.zeros((1, 8, u.cross_attention_dim)),
            jnp.zeros((1, u.addition_pooled_dim)), jnp.zeros((1, 6)))["params"],
        "te": jax.eval_shape(jax_model.text_encoder.init, rng, ids)["params"],
        "te2": jax.eval_shape(jax_model.text_encoder_2.init, rng, ids)["params"],
        "vae": jax.eval_shape(jax_model.vae.init, rng,
                              jnp.zeros((1, 16, 16, 3)), rng)["params"],
    }
    for name, tree in (("unet", unet), ("te", te), ("te2", te2), ("vae", vae)):
        shapes = jax.tree.map(lambda a: tuple(a.shape), tree)
        assert shapes == jax.tree.map(lambda a: tuple(a.shape), expected[name]), name
    back = unet_state_dict_to_flax(
        {k: v.numpy() for k, v in port.unet.state_dict().items()})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(unet)):
        np.testing.assert_array_equal(a, b)


def test_init_sdxl_weights_is_seeded(tiny):
    jax_model = tiny[0]
    a, b = port_model_like(jax_model, "meta"), port_model_like(jax_model, "meta")
    init_sdxl_weights(a, seed=3, device="cpu")
    init_sdxl_weights(b, seed=3, device="cpu")
    for name, module in a.modules().items():
        other = dict(b.modules()[name].named_parameters())
        for pname, p in module.named_parameters():
            assert p.device.type == "cpu" and torch.isfinite(p).all()
            assert torch.equal(p, other[pname]), f"{name}.{pname}"
    assert torch.equal(a.unet.conv_norm_out.weight,
                       torch.ones_like(a.unet.conv_norm_out.weight))
