"""Parity of the port's LoRA (onetrainer_tpu_torch/peft) with the JAX
reference (onetrainer_tpu/peft/lora.py, peft/layers.py) on the tiny SDXL
models of tests/test_sdxl.py, weights carried from the reference's trees.

Adapters are the reference's (its `init_peft_params`, `lora_up` then
filled with seeded numpy values so the LoRA term is not zero), carried
into the port by `io.weights.lora_params_from_jax`. Both sides compute in
fp32. Tolerances: the UNet output and every adapter gradient agree to
1e-4 relative L2 (a network of fp32 matmuls and convolutions summed in
another order), over a floor of 1e-7 of the global gradient norm: a
resnet's time_emb_proj feeds a per-channel constant into a GroupNorm, and
where the norm has one channel per group (32 channels, 32 groups) that
constant cancels, so its exact gradient is zero and both sides return
fp32 rounding noise (~1e-8 of the global norm, measured); merged weights
W + up.down.alpha/r to 1e-6 absolute (one rank-4 product per weight).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.peft import lora as jax_lora
from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map, unet_flax_to_state_dict
from onetrainer_tpu_torch.io.weights import lora_params_from_jax
from onetrainer_tpu_torch.peft import lora as pt_lora
from tests.test_torch_port_models import tiny_pair

REL = 1e-4
GRAD_FLOOR = 1e-7   # of the global gradient norm
MERGE_ATOL = 1e-6
RANK, ALPHA = 4, 8.0


@pytest.fixture(scope="module")
def tiny():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tiny_pair(seed=2)


def _cfgs(**kw):
    return (jax_lora.PeftConfig(rank=RANK, alpha=ALPHA, **kw),
            pt_lora.PeftConfig(rank=RANK, alpha=ALPHA, **kw))


def _jax_adapters(params, jcfg, seed):
    """The reference's adapters with a seeded non-zero lora_up (numpy)."""
    adapters = jax_lora.init_peft_params(jax.random.PRNGKey(seed), params, jcfg)
    rng = np.random.default_rng(seed)
    return {k: {"lora_down": np.asarray(e["lora_down"]),
                "lora_up": 0.1 * rng.standard_normal(e["lora_up"].shape,
                                                     dtype=np.float32)}
            for k, e in adapters.items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("layer_filter", [(), ("attn1", "proj_in")])
def test_adapted_module_keys_and_shapes_match_jax(tiny, layer_filter):
    _, (unet, te, _, _), port = tiny
    jcfg, pcfg = _cfgs(layer_filter=layer_filter)
    jax_keys = jax_lora.peft_module_keys(unet, jcfg)
    assert sorted(pt_lora.peft_module_keys(port.unet, pcfg)) == sorted(jax_keys)
    ref = jax_lora.init_peft_params(jax.random.PRNGKey(0), unet, jcfg)
    got = pt_lora.init_peft_params(torch.Generator().manual_seed(0), port.unet, pcfg)
    assert {k: {n: tuple(t.shape) for n, t in e.items()} for k, e in got.items()} \
        == {k: {n: tuple(t.shape) for n, t in e.items()} for k, e in ref.items()}
    if not layer_filter:   # the CLIP key map names text-encoder adapters alike
        assert sorted(pt_lora.peft_module_keys(port.text_encoder, pcfg,
                                               clip_torch_key_map)) \
            == sorted(jax_lora.peft_module_keys(te, jcfg))


def test_init_up_zero_down_bounded_and_seeded(tiny):
    port = tiny[2]
    _, pcfg = _cfgs()
    a = pt_lora.init_peft_params(torch.Generator().manual_seed(5), port.unet, pcfg)
    b = pt_lora.init_peft_params(torch.Generator().manual_seed(5), port.unet, pcfg)
    for key, entry in a.items():
        fan_in = entry["lora_down"][0].numel()
        assert torch.count_nonzero(entry["lora_up"]) == 0, key
        assert entry["lora_down"].abs().max() <= fan_in ** -0.5, key
        assert entry["lora_down"].dtype == torch.float32
        assert torch.equal(entry["lora_down"], b[key]["lora_down"]), key


def _unet_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16, 4), dtype=np.float32),
            np.asarray([10, 900], np.int32),
            rng.standard_normal((2, 8, 80), dtype=np.float32),
            rng.standard_normal((2, 48), dtype=np.float32),
            np.tile(np.asarray([[128, 128, 0, 0, 128, 128]], np.float32), (2, 1)),
            rng.standard_normal((2, 16, 16, 4), dtype=np.float32))


def test_lora_forward_and_grads_match_jax(tiny):
    jax_model, (unet, *_), port = tiny
    jcfg, pcfg = _cfgs()
    adapters = _jax_adapters(unet, jcfg, seed=1)
    *inputs, w = _unet_inputs(3)

    def loss(adapters):
        out = jax_model.unet.apply(
            jax_lora.lora_variables(unet, adapters, jcfg),
            *map(jnp.asarray, inputs))
        return jnp.sum(out * jnp.asarray(w)), out
    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, adapters))

    port_adapters = lora_params_from_jax(adapters, device="cpu")
    flat = [t.requires_grad_() for e in port_adapters.values() for t in e.values()]
    pt_lora.attach_peft(port.unet, port_adapters, pcfg)
    try:
        out = port.unet(*map(torch.from_numpy, inputs))
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), flat)
    finally:
        pt_lora.attach_peft(port.unet, None, None)
    assert _rel(out.detach().numpy(), ref_out) <= REL
    ref_flat = [np.asarray(ref_grads[key][name], np.float64)
                for key, entry in port_adapters.items() for name in entry]
    floor = GRAD_FLOOR * np.sqrt(sum(np.sum(r ** 2) for r in ref_flat))
    names = [(key, name) for key, entry in port_adapters.items() for name in entry]
    for got, ref, where in zip(grads, ref_flat, names):
        err = np.linalg.norm(got.numpy().astype(np.float64) - ref)
        assert err <= REL * np.linalg.norm(ref) + floor, where
    assert any(np.abs(np.asarray(ref_grads[k]["lora_down"])).max() > 0
               for k in ref_grads)


def test_detached_unet_is_the_base_model(tiny):
    jax_model, (unet, *_), port = tiny
    *inputs, _ = _unet_inputs(4)
    ref = jax.jit(jax_model.unet.apply)({"params": unet}, *map(jnp.asarray, inputs))
    with torch.no_grad():
        out = port.unet(*map(torch.from_numpy, inputs))
    assert _rel(out.numpy(), ref) <= REL


def test_apply_peft_merged_weights_match_jax(tiny):
    _, (unet, *_), port = tiny
    jcfg, pcfg = _cfgs()
    adapters = _jax_adapters(unet, jcfg, seed=2)
    ref = unet_flax_to_state_dict(jax.tree.map(
        np.asarray, jax_lora.apply_peft(unet, jax.tree.map(jnp.asarray, adapters),
                                        jcfg)))
    merged = pt_lora.apply_peft(port.unet, lora_params_from_jax(adapters, "cpu"), pcfg)
    assert set(merged) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(merged[key].numpy(), value, atol=MERGE_ATOL,
                                   rtol=0, err_msg=key)


def test_adapted_layers_equal_merged_weights(tiny):
    # sampling after LoRA training runs the adapted layers; export merges
    # the adapters into the base (merge_peft_into_base): the two agree
    import copy
    _, (unet, *_), port = tiny
    jcfg, pcfg = _cfgs()
    adapters = lora_params_from_jax(_jax_adapters(unet, jcfg, seed=3), "cpu")
    inputs = [torch.from_numpy(x) for x in _unet_inputs(5)[:-1]]
    merged = pt_lora.merge_peft_into_base(copy.deepcopy(port.unet), adapters, pcfg)
    pt_lora.attach_peft(port.unet, adapters, pcfg)
    try:
        with torch.no_grad():
            adapted = port.unet(*inputs)
            from_merged = merged(*inputs)
    finally:
        pt_lora.attach_peft(port.unet, None, None)
    assert _rel(adapted.numpy(), from_merged.numpy()) <= REL


def test_unported_peft_options_raise():
    from onetrainer_tpu_torch.util.enums import PeftType
    for cfg in (pt_lora.PeftConfig(peft_type=PeftType.LOHA),
                pt_lora.PeftConfig(decompose=True),
                pt_lora.PeftConfig(dropout=0.1)):
        with pytest.raises(NotImplementedError):
            cfg.check_supported()
