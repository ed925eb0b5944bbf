"""Parity of the port's PEFT (onetrainer_tpu_torch/peft: LoRA, DoRA, LoHa,
rank dropout, kohya files, continuing from one) with the JAX reference
(onetrainer_tpu/peft/lora.py, peft/layers.py) on the tiny SDXL models of
tests/test_sdxl.py, weights carried from the reference's trees, and on a
linear layer and 3x3 and 1x1 convs (each section states its tolerances:
per layer fp32 1e-5 relative L2, DoRA's initial magnitude 1e-6; merges
into an NF4 base within one bf16 step; kohya files bit for bit; one SDXL
step per PEFT type as tests/test_torch_port_train_sdxl.py holds steps).

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

from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.peft import lora as jax_lora
from onetrainer_tpu_torch.io.torch_flax import clip_torch_key_map, unet_flax_to_state_dict
from onetrainer_tpu_torch.io.weights import lora_params_from_jax, lora_params_to_jax
from onetrainer_tpu_torch.ops.quant import module_is_quantized
from onetrainer_tpu_torch.peft import lora as pt_lora
from onetrainer_tpu_torch.util.enums import PeftType
from tests.test_torch_port_inpaint import crc32_words
from tests.test_torch_port_models import tiny_pair

REL = 1e-4
GRAD_FLOOR = 1e-7   # of the global gradient norm
MERGE_ATOL = 1e-6
RANK, ALPHA = 4, 8.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the tiny layers gain nothing from more, and a
    loaded machine running the suite on several workers loses much."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tiny_pair(seed=2)


def _cfgs(**kw):
    """(the reference's config, the port's) with the same fields; a
    `peft_type` is the port's enum, carried to the reference's by value."""
    from onetrainer_tpu.util.enums import PeftType as JaxPeftType
    jax_kw = dict(kw)
    if "peft_type" in kw:
        jax_kw["peft_type"] = JaxPeftType(kw["peft_type"].value)
    return (jax_lora.PeftConfig(rank=RANK, alpha=ALPHA, **jax_kw),
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


@pytest.mark.parametrize("layer_filter", [(), ("attn1", "proj_in")])
def test_adapter_shapes_are_the_init_shapes_of_jax(tiny, layer_filter):
    """`adapter_shapes` (what the card's K5 checks size their leaves by)
    gives the shapes of the reference's adapters, without creating them."""
    _, (unet, _, _, _), port = tiny
    jcfg, pcfg = _cfgs(layer_filter=layer_filter)
    ref = jax_lora.init_peft_params(jax.random.PRNGKey(0), unet, jcfg)
    assert pt_lora.adapter_shapes(port.unet, pcfg) \
        == {k: {n: tuple(t.shape) for n, t in e.items()} for k, e in ref.items()}


def test_sdxl_unet_adapter_set_on_meta():
    """The SDXL QLoRA step's adapter set at rank 16, from a UNet built on
    the "meta" device: 794 layers, 1588 tensors, 49,412,736 elements."""
    from onetrainer_tpu_torch.models.unet import UNet2DCondition, sdxl_unet_config
    with torch.device("meta"):
        unet = UNet2DCondition(sdxl_unet_config())
    shapes = pt_lora.adapter_shapes(unet, pt_lora.PeftConfig(rank=16))
    assert len(shapes) == 794
    assert sum(int(np.prod(s)) for e in shapes.values() for s in e.values()) == 49_412_736
    assert shapes["down_blocks_1/attentions_0/transformer_blocks_0/attn1/to_q"] \
        == {"lora_down": (16, 640), "lora_up": (640, 16)}


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


MERGE_UP_STD = 0.02
MERGE_EFFECT_RATIO = 10.0


def test_dora_merge_into_nf4_equals_in_layer(tiny):
    """DoRA (bf16 adapters, lora_up of MERGE_UP_STD) on an NF4 UNet that
    computes in bf16, merged into the base (bf16 weights): every merged
    weight equals the bf16 weight its layer computes with in-layer, bit
    for bit; the merged forward differs from the in-layer one only at the
    layer that computes in fp32 (conv_out), whose in-layer W' is fp32 and
    merged W' bf16: with its merged weight in its place, the forwards are
    equal bit for bit. That gap is far below
    the adapters' own effect (in-layer against the bare base), as
    chip_smoke.py's sdxl_dora phase checks at full width."""
    import copy
    import dataclasses

    from onetrainer_tpu_torch.models.layers import weight_in
    from onetrainer_tpu_torch.models.unet import UNet2DCondition
    from onetrainer_tpu_torch.ops.quant import quantize_module
    from onetrainer_tpu_torch.peft.layers import adapter_of, attach_adapter
    port = tiny[2]
    unet = UNet2DCondition(dataclasses.replace(port.unet.cfg, dtype=torch.bfloat16))
    unet.load_state_dict(port.unet.state_dict())
    quantize_module(unet, "nf4", min_size=0)
    cfg = pt_lora.PeftConfig(rank=RANK, alpha=RANK, decompose=True,
                             weight_dtype=torch.bfloat16)
    adapters = pt_lora.init_peft_params(torch.Generator().manual_seed(0), unet, cfg)
    gen = torch.Generator().manual_seed(1)
    for entry in adapters.values():
        entry["lora_up"] = (MERGE_UP_STD * torch.randn(entry["lora_up"].shape,
                                                       generator=gen)).to(torch.bfloat16)
    inputs = [torch.from_numpy(x) for x in _unet_inputs(6)[:-1]]
    merged = pt_lora.merge_peft_into_base(copy.deepcopy(unet), adapters, cfg)
    layers = dict(merged.named_modules())
    with torch.no_grad():
        base = unet(*inputs)
        pt_lora.attach_peft(unet, adapters, cfg)
        in_layer = unet(*inputs)
        for name, layer in unet.named_modules():
            if adapter_of(layer) is not None:
                assert torch.equal(weight_in(layer, torch.bfloat16), layers[name].weight), name
        from_merged = merged(*inputs)
        gap = _rel(from_merged.float(), in_layer.float())
        effect = _rel(in_layer.float(), base.float())
        assert 0 < gap and effect >= MERGE_EFFECT_RATIO * gap
        attach_adapter(unet.conv_out, None)
        del unet.conv_out.weight
        unet.conv_out.weight = torch.nn.Parameter(layers["conv_out"].weight.float(),
                                                  requires_grad=False)
        assert torch.equal(unet(*inputs), from_merged)


# -- per layer: LoRA, LoHa and DoRA on nn.Linear and nn.Conv2d --------------------

LAYER_REL = 1e-5
INIT_ATOL = 1e-6
# DoRA: (output axis, norm epsilon)
LAYER_CASES = {
    "lora": dict(),
    "loha": dict(peft_type=PeftType.LOHA),
    "dora": dict(decompose=True),
    "dora_out_noeps": dict(decompose=True, decompose_output_axis=True,
                           decompose_norm_epsilon=False),
    "dora_out": dict(decompose=True, decompose_output_axis=True),
    "dora_noeps": dict(decompose=True, decompose_norm_epsilon=False),
}


class _Layers(torch.nn.Module):
    """A linear layer, a 3x3 and a 1x1 conv (adapter keys "lin", "conv3",
    "conv1"); wide enough for NF4 to quantize each (min_size 0)."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(24, 20)
        self.conv3 = torch.nn.Conv2d(6, 8, 3, padding=1)
        self.conv1 = torch.nn.Conv2d(6, 8, 1)

    def forward(self, x, img, dtype=torch.float32):
        from onetrainer_tpu_torch.models.layers import conv, linear
        return (linear(self.lin, x, dtype), conv(self.conv3, img, dtype),
                conv(self.conv1, img, dtype))


def _layers(seed=0):
    torch.manual_seed(seed)
    return _Layers()


def _jax_layer_params(layers) -> dict:
    """The flax tree of `_Layers`: dense [in, out], conv HWIO kernels."""
    sd = {k: v.detach().numpy() for k, v in layers.state_dict().items()}
    return {"lin": {"kernel": sd["lin.weight"].T, "bias": sd["lin.bias"]},
            "conv3": {"kernel": sd["conv3.weight"].transpose(2, 3, 1, 0),
                      "bias": sd["conv3.bias"]},
            "conv1": {"kernel": sd["conv1.weight"].transpose(2, 3, 1, 0),
                      "bias": sd["conv1.bias"]}}


def _nonzero(adapters: dict, seed: int) -> dict:
    """The reference's adapters (numpy) with the zero-initialised factor
    (lora_up, hada_w2_a) filled, so the term is not zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, entry in adapters.items():
        out[key] = {n: np.asarray(v, np.float32) for n, v in entry.items()}
        for zero in ("lora_up", "hada_w2_a"):
            if zero in out[key]:
                out[key][zero] = 0.1 * rng.standard_normal(out[key][zero].shape,
                                                           dtype=np.float32)
    return out


def _jax_layer_apply(params, adapters, jcfg, x, img, rng=None):
    """The reference's LoraDense/LoraConv outputs (img NHWC) for the
    adapters through its `adapters_to_lora_collection`."""
    from onetrainer_tpu.peft.layers import LoraConv, LoraDense
    col = jax_lora.adapters_to_lora_collection(adapters, jcfg, rng)
    y = LoraDense(features=20).apply({"params": params["lin"], "lora": col["lin"]}, x)
    c3 = LoraConv(features=8, kernel_size=(3, 3), padding=((1, 1), (1, 1))).apply(
        {"params": params["conv3"], "lora": col["conv3"]}, img)
    c1 = LoraConv(features=8, kernel_size=(1, 1), padding="VALID").apply(
        {"params": params["conv1"], "lora": col["conv1"]}, img)
    return y, c3, c1


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 24), dtype=np.float32),
            rng.standard_normal((2, 5, 5, 6), dtype=np.float32),
            [rng.standard_normal(s, dtype=np.float32)
             for s in ((3, 20), (2, 5, 5, 8), (2, 5, 5, 8))])


def _layer_loss_jax(params, jcfg, x, img, ws, rng=None):
    def loss(adapters):
        outs = _jax_layer_apply(params, adapters, jcfg, jnp.asarray(x), jnp.asarray(img), rng)
        return sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(outs, ws)), outs
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _port_layer_outputs(layers, adapters, pcfg, x, img, keep=None):
    attached = pt_lora.attach_peft(layers, adapters, pcfg)
    masks = pt_lora.RankDropout(pcfg.dropout, {"g": attached}).masked({"g": keep}) \
        if keep else nullcontext()
    try:
        with masks:
            y, c3, c1 = layers(torch.from_numpy(x), torch.from_numpy(img).permute(0, 3, 1, 2))
            return y, c3.permute(0, 2, 3, 1), c1.permute(0, 2, 3, 1)
    finally:
        pt_lora.attach_peft(layers, None, None)


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_outputs_and_grads_match_jax(case):
    """Each adapter type on nn.Linear and nn.Conv2d (3x3, 1x1): the
    adapters' shapes and DoRA's initial magnitude against the reference's
    `init_peft_params` from the same W (1e-6), and the layer outputs and
    every adapter gradient against its LoraDense/LoraConv with the adapters
    carried across (fp32, LAYER_REL relative L2)."""
    layers = _layers()
    params = _jax_layer_params(layers)
    jcfg, pcfg = _cfgs(**LAYER_CASES[case])
    ref = jax.device_get(jax_lora.init_peft_params(jax.random.PRNGKey(0), params, jcfg))
    got = pt_lora.init_peft_params(torch.Generator().manual_seed(0), layers, pcfg)
    assert {k: {n: tuple(t.shape) for n, t in e.items()} for k, e in got.items()} \
        == {k: {n: tuple(t.shape) for n, t in e.items()} for k, e in ref.items()}
    assert got.keys() == pt_lora.adapter_shapes(layers, pcfg).keys()
    if pcfg.decompose:
        for key, entry in ref.items():
            np.testing.assert_allclose(got[key]["dora_scale"].numpy(),
                                       entry["dora_scale"], atol=INIT_ATOL, rtol=0)
    adapters = _nonzero(ref, seed=3)
    x, img, ws = _layer_inputs(4)
    (_, ref_outs), ref_grads = _layer_loss_jax(params, jcfg, x, img, ws)(
        jax.tree.map(jnp.asarray, adapters))
    carried = lora_params_from_jax(adapters, "cpu")
    flat = [t.requires_grad_() for e in carried.values() for t in e.values()]
    outs = _port_layer_outputs(layers, carried, pcfg, x, img)
    grads = torch.autograd.grad(
        sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws)), flat)
    for out, want in zip(outs, ref_outs):
        assert _rel(out.detach().numpy(), want) <= LAYER_REL
    names = [(k, n) for k, e in carried.items() for n in e]
    for g, (key, name) in zip(grads, names):
        assert _rel(g.numpy(), ref_grads[key][name]) <= LAYER_REL, (key, name)
    back = lora_params_to_jax(carried)
    assert all(np.array_equal(back[k][n], adapters[k][n]) for k, n in names)


@pytest.mark.parametrize("case", ["lora", "loha", "dora", "dora_out_noeps"])
@pytest.mark.parametrize("nf4", [False, True], ids=["fp32", "nf4"])
def test_apply_peft_per_layer_matches_jax(case, nf4):
    """`apply_peft` against the reference's: fp32 bases to MERGE_ATOL; an
    NF4 base with the reference's codes (the port's plain K4 twin here)
    decodes to bf16 and merges in fp32 to bf16 results, equal to the
    reference's within one bf16 step (2^-8 relative: the fp32 sums round
    to bf16 after additions in another order); `merge_peft_into_base`
    leaves a bf16 base with those weights."""
    from onetrainer_tpu.ops.quant import quantize_tree
    from onetrainer_tpu_torch.ops.quant import quantize_module
    layers = _layers(1)
    params = _jax_layer_params(layers)
    jcfg, pcfg = _cfgs(**LAYER_CASES[case])
    adapters = _nonzero(jax.device_get(
        jax_lora.init_peft_params(jax.random.PRNGKey(1), params, jcfg)), seed=5)
    if nf4:
        params = quantize_tree(jax.tree.map(jnp.asarray, params), "nf4", min_size=0)
        quantize_module(layers, "nf4", min_size=0)
        assert np.array_equal(np.asarray(params["lin"]["kernel"].q), layers.lin.weight.q.numpy())
    ref = jax.device_get(jax_lora.apply_peft(params, jax.tree.map(jnp.asarray, adapters), jcfg))
    carried = lora_params_from_jax(adapters, "cpu")
    merged = pt_lora.apply_peft(layers, carried, pcfg)
    for key in ("lin", "conv3", "conv1"):
        kernel = np.asarray(ref[key]["kernel"], np.float32)
        want = kernel.T if key == "lin" else kernel.transpose(3, 2, 0, 1)
        got = merged[key + ".weight"]
        assert got.dtype == (torch.bfloat16 if nf4 else torch.float32)
        if nf4:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                                       atol=0, err_msg=key)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=MERGE_ATOL, rtol=0,
                                       err_msg=key)
    pt_lora.merge_peft_into_base(layers, carried, pcfg)
    assert not module_is_quantized(layers)
    assert torch.equal(layers.lin.weight, merged["lin.weight"])


def test_rank_dropout_matches_jax_masks_and_rate():
    """Rank dropout: with p = 0 the step draws nothing and the layer is
    the adapter's own; with the reference's masks (its
    `adapters_to_lora_collection` folds the adapter's index into the key)
    handed in, the layer outputs and gradients equal the reference's to
    LAYER_REL; the port's own masks keep each rank row with probability
    1 - p (within 5 binomial standard deviations over 20000 rows)."""
    p = 0.3
    layers = _layers(2)
    params = _jax_layer_params(layers)
    jcfg, pcfg = _cfgs(dropout=p)
    adapters = _nonzero(jax.device_get(
        jax_lora.init_peft_params(jax.random.PRNGKey(2), params, jcfg)), seed=6)
    x, img, ws = _layer_inputs(7)
    rng = jax.random.PRNGKey(8)
    (_, ref_outs), ref_grads = _layer_loss_jax(params, jcfg, x, img, ws, rng)(
        jax.tree.map(jnp.asarray, adapters))
    keep = {key: np.asarray(jax.random.bernoulli(
        jax.random.fold_in(rng, i), 1.0 - p,
        (entry["lora_down"].shape[0],) + (1,) * (entry["lora_down"].ndim - 1)))
        for i, (key, entry) in enumerate(adapters.items())}
    assert 0 < sum(int(k.sum()) for k in keep.values()) < 3 * RANK
    carried = lora_params_from_jax(adapters, "cpu")
    flat = [t.requires_grad_() for e in carried.values() for t in e.values()]
    outs = _port_layer_outputs(layers, carried, pcfg, x, img,
                               {k: torch.from_numpy(v.copy()) for k, v in keep.items()})
    grads = torch.autograd.grad(
        sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws)), flat)
    for out, want in zip(outs, ref_outs):
        assert _rel(out.detach().numpy(), want) <= LAYER_REL
    names = [(k, n) for k, e in carried.items() for n in e]
    for g, (key, name) in zip(grads, names):
        assert _rel(g.numpy(), ref_grads[key][name]) <= LAYER_REL, (key, name)
    # p = 0: no masks, the plain adapter term
    jcfg0, pcfg0 = _cfgs()
    (_, plain_ref), _ = _layer_loss_jax(params, jcfg0, x, img, ws, rng)(
        jax.tree.map(jnp.asarray, adapters))
    with torch.no_grad():
        plain = _port_layer_outputs(layers, carried, pcfg0, x, img)
    for out, want in zip(plain, plain_ref):
        assert _rel(out.numpy(), want) <= LAYER_REL
    rows = pt_lora.draw_rank_keep({"k": {"lora_down": torch.zeros(20000, 3)}}, p,
                                  torch.Generator().manual_seed(0))["k"]
    n = rows.numel()
    assert rows.shape == (n, 1) and rows.dtype == torch.bool
    assert abs(int(rows.sum()) - n * (1 - p)) <= 5 * np.sqrt(n * p * (1 - p))


# -- kohya files and continuing from them -------------------------------------------

@pytest.mark.parametrize("case", ["lora", "loha", "dora", "dora_out_noeps"])
def test_kohya_both_ways_match_jax_bitwise(tiny, case, tmp_path):
    """The kohya tensors of LoRA, DoRA (dora_scale) and LoHa (hada_*, conv
    LoHa's [r, in, kh, kw] factors included) on the tiny SDXL UNet equal
    the reference's `peft_to_kohya_state_dict` bit for bit, and read back
    through both packages' `kohya_state_dict_to_peft` to the adapters;
    `apply_lora_checkpoint` loads such a file into fresh adapters of
    another rank and adopts the file's rank and alpha, as the
    reference's. The adapters are the port's draws (whose shapes the
    tests above hold to the reference's init), carried to the
    reference's trees: the file format is under test, not the draws."""
    _, _, port = tiny
    jcfg, pcfg = _cfgs(layer_filter=("attn1", "conv"), **LAYER_CASES[case])
    adapters = _nonzero(lora_params_to_jax(pt_lora.init_peft_params(
        torch.Generator().manual_seed(3), port.unet, pcfg)), seed=7)
    assert any(e.get("lora_down", e.get("hada_w1_b")).ndim == 4 for e in adapters.values())
    want = jax_lora.peft_to_kohya_state_dict(adapters, jcfg, "lora_unet")
    carried = lora_params_from_jax(adapters, "cpu")
    got = pt_lora.peft_to_kohya_state_dict(carried, pcfg, "lora_unet")
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value)), key
    keys = pt_lora.peft_module_keys(port.unet, pcfg)
    back, alpha = pt_lora.kohya_state_dict_to_peft(got, "lora_unet", keys)
    ref_back, ref_alpha = jax_lora.kohya_state_dict_to_peft(want, "lora_unet", keys)
    assert alpha == ref_alpha == ALPHA
    for key, entry in adapters.items():
        assert set(back[key]) == set(entry) == set(ref_back[key])
        for name, value in entry.items():
            assert torch.equal(back[key][name], carried[key][name]), (key, name)
    path = str(tmp_path / "lora.safetensors")
    from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
    save_safetensors(path, got)
    import dataclasses
    other = dataclasses.replace(pcfg, rank=RANK + 2, alpha=1.0)
    fresh = {"unet_lora": pt_lora.init_peft_params(torch.Generator().manual_seed(0),
                                                   port.unet, other)}
    ref_fresh = {"unet_lora": lora_params_to_jax(fresh["unet_lora"])}
    adopted = pt_lora.apply_lora_checkpoint(path, fresh, {"unet_lora": "lora_unet"}, other)
    ref_adopted = jax_lora.apply_lora_checkpoint(path, ref_fresh,
                                                 {"unet_lora": "lora_unet"}, jcfg)
    assert (adopted.rank, adopted.alpha) == (ref_adopted.rank, ref_adopted.alpha) \
        == (RANK, ALPHA)
    for key, entry in carried.items():
        for name, value in entry.items():
            assert torch.equal(fresh["unet_lora"][key][name], value), (key, name)
            assert np.array_equal(np.asarray(ref_fresh["unet_lora"][key][name]),
                                  value.numpy()), (key, name)


def test_lora_weight_dtypes():
    """fp16, bf16 and fp8 adapters are made in their dtype, as the
    reference's; integer dtypes raise the reference's own messages."""
    layers = _layers()
    for dtype in (torch.float16, torch.bfloat16, torch.float8_e4m3fn):
        for kind in ("lora", "loha", "dora"):
            cfg = pt_lora.PeftConfig(rank=RANK, weight_dtype=dtype, **LAYER_CASES[kind])
            got = pt_lora.init_peft_params(torch.Generator().manual_seed(0), layers, cfg)
            assert all(t.dtype == dtype for e in got.values() for t in e.values())
    for dtype, kind, message in ((torch.int8, "lora", "`uniform` must be a float dtype"),
                                 (torch.uint8, "loha", "`normal` must be a float")):
        with pytest.raises(ValueError, match=message):
            pt_lora.init_peft_params(torch.Generator(), layers, pt_lora.PeftConfig(
                weight_dtype=dtype, **LAYER_CASES[kind]))


def test_unported_peft_options_raise():
    """LoHa, DoRA, rank dropout and fp8 adapter weights, once refused, now
    set up; what stays refused of ROADMAP item 4 is the checkpoint
    policies (the UNet's beyond tx_only)."""
    import dataclasses

    from onetrainer_tpu_torch.models.unet import UNet2DCondition, sdxl_unet_config
    layers = _layers()
    for cfg in (pt_lora.PeftConfig(peft_type=PeftType.LOHA),
                pt_lora.PeftConfig(decompose=True),
                pt_lora.PeftConfig(dropout=0.1),
                pt_lora.PeftConfig(weight_dtype=torch.float8_e4m3fn)):
        adapters = pt_lora.init_peft_params(torch.Generator(), layers, cfg)
        assert set(adapters) == {"lin", "conv3", "conv1"}
    with pytest.raises(NotImplementedError, match="remat policy 'dots' is not ported"):
        UNet2DCondition(dataclasses.replace(sdxl_unet_config(), gradient_checkpointing=True,
                                            remat_policy="dots"))


# -- one SDXL step each: DoRA on an NF4 UNet with rank dropout, LoHa ----------------

# the DoRA step: bf16 adapters on an NF4 base with stochastic rounding, held
# as tests/test_torch_port_train_sdxl.py holds the QLoRA steps (loss 1e-4,
# bf16 grad_norm 2^-6, adapters after the step 1e-3 relative L2); the
# LoHa step: fp32 adapters on the fp32 base (all to 1e-4). The LoHa step
# adapts the self-attention projections and the resnets' 3x3 conv1
# (`lora_layers`), the DoRA step the self-attention queries: the
# reference's DoRA step over NF4 compiles for about half as long over
# these as over the LoHa step's layers (DoRA on 3x3 and 1x1 convs is held
# per layer above).
DORA_STEP_LAYERS = "attn1/to_q"
STEP_LAYERS = "attn1,conv1"
STEP_CASES = {
    "dora_nf4": dict(lora_decompose=True, dropout_probability=0.1, qlora=True,
                     lora_layers=DORA_STEP_LAYERS),
    "loha": dict(peft_type="LOHA", lora_layers=STEP_LAYERS),
}
# the cases held as the QLoRA steps are (16-bit adapters: an update one
# step apart moves p + u across a rounding threshold now and then)
LOOSE = ("dora_nf4",)


def _peft_reference(case: str, batch: dict) -> dict:
    """One reference SDXL step through its setup entry point with the
    PEFT settings of `case`, on the cached `batch`, and the rank-dropout
    masks its step drew (its `adapters_to_lora_collection` over the sorted
    adapter keys of the jitted state, one key per adapter folded into the
    step's PEFT key)."""
    from onetrainer_tpu.util.enums import PeftType as JaxPeftType
    from tests import test_torch_port_train_sdxl as sdxl_t
    fields = dict(STEP_CASES[case])
    qlora = fields.pop("qlora", False)
    jax_model = _crc32(sdxl_t._jax_model())
    port = sdxl_t.port_model_like(jax_model)
    params = sdxl_t.random_flax_params(port, seed=1)
    (jax_model.unet_params, jax_model.te_params, jax_model.te2_params,
     jax_model.vae_params) = jax.tree.map(jnp.asarray, params)
    config, _ = sdxl_t._configs(False, qlora)
    for name, value in fields.items():
        setattr(config, name, JaxPeftType[value] if name == "peft_type" else value)
    port_config = sdxl_t.PortTrainConfig.default_values().from_dict(config.to_dict())
    if qlora:
        jax_model.unet_params = jax.jit(lambda tree: sdxl_t.quantize_tree(tree, "nf4"))(
            jax_model.unet_params)
    setup = sdxl_t.jax_setup.create_sdxl_setup(jax_model, config, total_steps=10)
    init = jax.device_get(setup.state.params)
    batch = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(sdxl_t.SEED)
    draws = sdxl_t._jax_draws(setup.step_cfg, batch, rng, 0)
    if qlora:
        draws["round_bits"] = sdxl_t._jax_round_bits(setup.state.params, rng, 0)
    p = config.dropout_probability
    if p > 0:
        rng_peft = jax.random.split(jax.random.split(jax.random.fold_in(rng, 0))[0])[0]
        draws["rank_keep"] = {"unet_lora": {
            key: np.asarray(jax.random.bernoulli(
                jax.random.fold_in(rng_peft, i), 1.0 - p,
                (entry["lora_down"].shape[0],) + (1,) * (entry["lora_down"].ndim - 1)))
            for i, (key, entry) in enumerate(sorted(init["unet_lora"].items()))}}
    state, metrics = setup.train_step(setup.state, setup.frozen, batch, rng)
    return dict(jax_model=jax_model, params=params, init=init, draws=draws,
                port_config=port_config, loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]), after=jax.device_get(state.params))


@pytest.fixture(scope="module")
def sdxl_batch():
    """The tiny SDXL's cached batch (both packages' caches agree:
    tests/test_torch_port_train_sdxl.py)."""
    from tests import test_torch_port_train_sdxl as sdxl_t
    jax_model = _crc32(sdxl_t._jax_model())
    port = sdxl_t.port_model_like(jax_model)
    params = sdxl_t.random_flax_params(port, seed=1)
    (jax_model.unet_params, jax_model.te_params, jax_model.te2_params,
     jax_model.vae_params) = jax.tree.map(jnp.asarray, params)
    config, _ = sdxl_t._configs(False)
    setup = sdxl_t.jax_setup.create_sdxl_setup(jax_model, config, total_steps=10)
    encode_images, encode_text = sdxl_t.jax_setup.make_sdxl_encode_fns(setup)
    batch = jax.device_get(sdxl_t._batch(encode_images, encode_text, sdxl_t._images(),
                                         jnp.asarray))
    return dict(batch=batch, jax_model=jax_model, params=params)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sdxl_peft_step_matches_jax(sdxl_batch, case):
    """One SDXL step through both setups for DoRA on an NF4 UNet (bf16
    adapters and dora_scale, stochastic rounding on the reference's bits,
    rank dropout 0.1 on the reference's masks) and LoHa: the port's
    adapters start as the reference's, its step takes the reference's
    draws; the loss, the gradient norm and every adapter after the update
    are held to the reference's. K4 and K5 are not launched on the CPU."""
    from onetrainer_tpu_torch.ops.nf4 import nf4_dequant_flat
    from onetrainer_tpu_torch.ops.sr_update import sr_update_leaves
    from onetrainer_tpu_torch.setup.families import get_family
    from tests import test_torch_port_train_sdxl as sdxl_t
    ref = _peft_reference(case, sdxl_batch["batch"])
    loose = case in LOOSE
    port = _crc32(sdxl_t._port_model(ref["jax_model"], ref["params"], None))
    family = get_family(ref["port_config"].model_type)
    setup = family.create_setup(port, ref["port_config"], 10)
    rank_dropout = setup.train_step.rank_dropout
    assert (rank_dropout.p if rank_dropout else 0.0) == ref["port_config"].dropout_probability
    with torch.no_grad():
        for key, entry in lora_params_from_jax(ref["init"]["unet_lora"], "cpu").items():
            assert set(entry) == set(setup.state.params["unet_lora"][key])
            for name, value in entry.items():
                setup.state.params["unet_lora"][key][name].copy_(value)
    batch = {k: torch.as_tensor(np.array(v)) for k, v in sdxl_batch["batch"].items()}
    draws = {k: torch.from_numpy(v.copy()) for k, v in ref["draws"].items()
             if k not in ("round_bits", "rank_keep")}
    if "round_bits" in ref["draws"]:
        draws["round_bits"] = jax.tree.map(torch.from_numpy, ref["draws"]["round_bits"])
    if "rank_keep" in ref["draws"]:
        draws["rank_keep"] = jax.tree.map(lambda m: torch.from_numpy(m.copy()),
                                          ref["draws"]["rank_keep"])
    launches = (nf4_dequant_flat.launches, sr_update_leaves.launches)
    out = setup.train_step(setup.state, batch, torch.Generator().manual_seed(0), **draws)
    assert (nf4_dequant_flat.launches, sr_update_leaves.launches) == launches
    assert float(out["loss"]) == pytest.approx(ref["loss"], rel=sdxl_t.REL)
    assert float(out["grad_norm"]) == pytest.approx(
        ref["grad_norm"], rel=sdxl_t.QLORA_NORM_REL if loose else sdxl_t.REL)
    after = setup.state.params["unet_lora"]
    moved = 0
    for key, entry in ref["after"]["unet_lora"].items():
        for name, value in entry.items():
            moved += not np.array_equal(np.asarray(value, np.float32),
                                        np.asarray(ref["init"]["unet_lora"][key][name],
                                                   np.float32))
            assert after[key][name].dtype == torch.float32 if value.dtype == np.float32 \
                else after[key][name].dtype == torch.bfloat16
    got = np.concatenate([after[k][n].detach().float().numpy().ravel()
                          for k, e in ref["after"]["unet_lora"].items() for n in e])
    want = np.concatenate([np.asarray(v, np.float32).ravel()
                           for e in ref["after"]["unet_lora"].values() for v in e.values()])
    assert np.isfinite(got).all()
    assert _rel(got, want) <= (sdxl_t.QLORA_REL if loose else sdxl_t.REL)
    assert moved > 0


# -- fp16 and fp8 LoRA weights ------------------------------------------------------

# the JAX package trains fp16 and fp8 adapters with optax's AdamW in their
# dtype, which gives inf or NaN after one step (ROADMAP F15, F17; asserted
# below); the port computes their AdamW in fp32 (train/optimizers.py). Its
# step is held to the reference's step in fp32 from the same values,
# rounded to the dtype. AdamW's first update is lr * g / (|g| + eps) per
# element, the same on both sides wherever the gradient survives the
# dtype: so after rounding each adapter element equals the reference's,
# or lies one step of the dtype from it (the port's fp16 update rounds to
# fp16 before the sum; a p + u within the two sides' difference of a
# rounding threshold), or kept its value where its gradient rounded to 0
# in the dtype (the port's AdamW then gives 0); at most LOW_PRECISION_APART
# of the elements are not equal. The loss to 1e-6 (the factors scaled by
# alpha/r = 2, exact in both dtypes; fp32 sums in another order), the
# gradient norm to the dtype's eps (each gradient rounded to the dtype).
LOW_PRECISION = {"fp16": ("FLOAT_16", torch.float16, jnp.float16),
                 "fp8": ("FLOAT_8", torch.float8_e4m3fn, jnp.float8_e4m3fn)}
LOW_PRECISION_LR = 0.05
LOW_PRECISION_APART = 0.01
LOSS_REL = 1e-6


def _crc32(model):
    """`model` with crc32 word ids in both tokenizers: no result follows
    PYTHONHASHSEED."""
    crc32_words(model.tokenizer), crc32_words(model.tokenizer_2)
    return model


def _flat_adapters(tree: dict) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k][n], np.float32).ravel()
                           for k in sorted(tree) for n in sorted(tree[k])])


def _held_to_rounded(got, want, start, jdtype) -> int:
    """Assert each element of `got` equals `want` (the fp32 reference
    rounded to `jdtype`), lies one `jdtype` step from it, or equals
    `start`; -> how many are not equal."""
    ml = np.dtype(jdtype)
    up = np.nextafter(want.astype(ml), np.asarray(np.inf, ml)).astype(np.float32)
    down = np.nextafter(want.astype(ml), np.asarray(-np.inf, ml)).astype(np.float32)
    assert np.isfinite(got).all()
    assert np.all((got == want) | (got == up) | (got == down) | (got == start))
    return int(np.count_nonzero(got != want))


@pytest.mark.parametrize("name", list(LOW_PRECISION))
def test_low_precision_lora_step_matches_jax(name):
    """fp16 and fp8 LoRA adapters on the linear layer and both convs: one
    step of the port's train step (train/sd_train_step.py:make_train_step,
    AdamW behind the clip) against the reference's LoraDense/LoraConv and
    its AdamW (onetrainer_tpu/train/optimizers.py) in fp32 from the same
    values; the reference's optimizer in the dtype gives inf or NaN (fp16:
    some elements, F15; fp8: every element, F17)."""
    from types import SimpleNamespace

    import optax

    from onetrainer_tpu.config.train_config import TrainConfig as JaxTrainConfig
    from onetrainer_tpu.train.optimizers import create_group_optimizer as jax_optimizer
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.train.optimizers import create_group_optimizer
    from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, make_train_step
    from onetrainer_tpu_torch.train.train_state import create_train_state
    _, dtype, jdtype = LOW_PRECISION[name]
    layers = _layers(3)
    params = _jax_layer_params(layers)
    jcfg = jax_lora.PeftConfig(rank=RANK, alpha=ALPHA)   # fp32, holding the dtype's values
    pcfg = pt_lora.PeftConfig(rank=RANK, alpha=ALPHA, weight_dtype=dtype)
    adapters = pt_lora.init_peft_params(torch.Generator().manual_seed(4), layers, pcfg)
    rng = np.random.default_rng(8)
    for entry in adapters.values():
        up = 0.1 * rng.standard_normal(tuple(entry["lora_up"].shape), dtype=np.float32)
        entry["lora_up"] = torch.from_numpy(up).to(dtype)
    assert all(t.dtype == dtype for e in adapters.values() for t in e.values())
    values = {k: {n: t.float().numpy() for n, t in e.items()} for k, e in adapters.items()}
    x, img, ws = _layer_inputs(9)

    config = JaxTrainConfig.default_values()
    tx = optax.chain(optax.clip_by_global_norm(1.0), jax_optimizer(
        {"g": LOW_PRECISION_LR}, config.optimizer.optimizer, config.optimizer,
        lambda tree: jax.tree.map(lambda _: "g", tree)))

    def update(tree, grads):
        return optax.apply_updates(tree, tx.update(grads, tx.init(tree), tree)[0])
    tree = jax.tree.map(jnp.asarray, values)
    (loss, _), grads = _layer_loss_jax(params, jcfg, x, img, ws)(tree)
    after = jax.jit(update)(tree, grads)
    # the reference's optimizer on the adapters and gradients in the dtype,
    # as its step runs it (F15, F17)
    own = jax.jit(update)(*jax.tree.map(lambda v: v.astype(jdtype), (tree, grads)))
    finite = np.concatenate([np.isfinite(np.asarray(v, np.float32)).ravel()
                             for v in jax.tree.leaves(own)])
    assert not finite.all() and (dtype == torch.float16 or not finite.any())

    port_opt = TrainConfig.default_values().optimizer
    port_tx = create_group_optimizer({"g": LOW_PRECISION_LR}, port_opt.optimizer, port_opt, 1.0)
    state = create_train_state({"g": adapters}, port_tx)

    def predict(model, batch, generator, cfg, coefficients):
        y, c3, c1 = layers(torch.from_numpy(x), torch.from_numpy(img).permute(0, 3, 1, 2))
        outs = (y, c3.permute(0, 2, 3, 1), c1.permute(0, 2, 3, 1))
        return sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws)).reshape(1)
    step = make_train_step(SimpleNamespace(modules=lambda: {"layers": layers}),
                           SDStepConfig.from_train_config(TrainConfig.default_values()),
                           port_tx, predict, losses=lambda batch, data: data)
    pt_lora.attach_peft(layers, adapters, pcfg)
    try:
        out = step(state, {}, torch.Generator().manual_seed(0))
    finally:
        pt_lora.attach_peft(layers, None, None)
    assert float(out["loss"]) == pytest.approx(float(loss), rel=LOSS_REL)
    assert float(out["grad_norm"]) == pytest.approx(float(optax.global_norm(grads)),
                                                    rel=float(torch.finfo(dtype).eps))
    assert all(t.dtype == dtype for e in state.params["g"].values() for t in e.values())
    got = _flat_adapters({k: {n: t.detach().float().numpy() for n, t in e.items()}
                          for k, e in state.params["g"].items()})
    want = _flat_adapters(jax.tree.map(lambda v: np.asarray(v).astype(jdtype), after))
    start = _flat_adapters(values)
    assert _held_to_rounded(got, want, start, jdtype) <= LOW_PRECISION_APART * got.size
    assert np.count_nonzero(want != start) > got.size // 2   # the step moves them


@pytest.mark.parametrize("name", list(LOW_PRECISION))
def test_sdxl_low_precision_lora_step_matches_fp32(sdxl_batch, name):
    """The SDXL setup with fp16 or fp8 LoRA weights (`lora_weight_dtype`)
    sets up and steps, and from the same adapter values its step agrees
    with the fp32 setup's step (which tests/test_torch_port_train_sdxl.py
    holds to the reference's), whose adapters are rounded to the dtype:
    the loss to LOSS_REL and the gradient norm to the dtype's eps, as the
    layer step above; the fp16 adapters bit for bit to the fp32 AdamW on
    the fp16 step's own gradients, and to QLORA_REL relative L2 of the fp32
    step over the elements whose gradient fp16 does not flush to 0 (the
    tiny UNet has gradients below fp16's normal range, where the rounded
    gradient moves AdamW's g / (|g| + eps) by a few fp16 steps; one below
    half its smallest subnormal, 2^-25, becomes 0, and its element then
    takes no Adam step where the fp32 step moves it by up to lr); each fp8
    adapter element equal, one fp8 step apart, or kept where its gradient
    rounds to 0 in fp8 (most of those the fp32 step moves: the tiny UNet's
    lora_up gradients lie mostly below fp8's 2^-10), some moved."""
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import DataType
    from tests import test_torch_port_train_sdxl as sdxl_t
    data_type, dtype, jdtype = LOW_PRECISION[name]
    batch = {k: torch.as_tensor(np.array(v)) for k, v in sdxl_batch["batch"].items()}
    runs = {}
    for weights in (data_type, "FLOAT_32"):
        _, config = sdxl_t._configs(False)
        config.lora_layers = STEP_LAYERS
        config.learning_rate = LOW_PRECISION_LR
        config.lora_weight_dtype = DataType[weights]
        port = _crc32(sdxl_t._port_model(sdxl_batch["jax_model"], sdxl_batch["params"],
                                         None))
        setup = get_family(config.model_type).create_setup(port, config, 10)
        params = setup.state.params["unet_lora"]
        if weights == data_type:
            start = {k: {n: t.detach().float().clone() for n, t in e.items()}
                     for k, e in params.items()}
        with torch.no_grad():
            for key, entry in params.items():
                for leaf, t in entry.items():
                    t.copy_(start[key][leaf])
        seen = {}
        leaf_updates = setup.tx.leaf_updates

        def recording(groups, grads, state, norm=None, seen=seen, leaf_updates=leaf_updates):
            seen["grads"] = [g.detach().float().clone() for g in grads["unet_lora"]]
            seen["norm"] = float(norm)
            yield from leaf_updates(groups, grads, state, norm)
        setup.tx.leaf_updates = recording
        out = setup.train_step(setup.state, batch, torch.Generator().manual_seed(0))
        grads, i = {}, 0   # the optimizer's order: adapter keys, then sorted names
        for key, entry in params.items():
            grads[key] = {}
            for leaf in sorted(entry):
                grads[key][leaf] = seen["grads"][i]
                i += 1
        runs[weights] = dict(out=out, grads=grads, norm=seen["norm"], setup=setup,
                             dtypes={t.dtype for e in params.values()
                                     for t in e.values()},
                             after=_flat_adapters({k: {n: t.detach().float().numpy()
                                                       for n, t in e.items()}
                                                   for k, e in params.items()}))
    low, ref = runs[data_type], runs["FLOAT_32"]
    assert low["dtypes"] == {dtype}
    assert float(low["out"]["loss"]) == pytest.approx(float(ref["out"]["loss"]), rel=LOSS_REL)
    assert float(low["out"]["grad_norm"]) == pytest.approx(
        float(ref["out"]["grad_norm"]), rel=float(torch.finfo(dtype).eps))
    got = low["after"]
    want = ref["after"].astype(np.dtype(jdtype)).astype(np.float32)
    first = _flat_adapters({k: {n: t.numpy() for n, t in e.items()} for k, e in start.items()})
    assert np.isfinite(got).all()
    if dtype == torch.float16:
        from onetrainer_tpu_torch.train import optimizers as pt_opt
        # the fp16 step is the fp32 AdamW on its own (fp16) gradients, bit
        # for bit: fp16's rounding of the gradient is its one difference
        assert low["norm"] < 1.0   # the clip is not reached
        cfg = low["setup"].config.optimizer
        opt = pt_opt.create_optimizer(cfg.optimizer, cfg,
                                      low["setup"].tx.groups["unet_lora"].schedule)
        p0 = [start[k][n] for k in start for n in sorted(start[k])]
        g16 = [low["grads"][k][n] for k in start for n in sorted(start[k])]
        emulated, i = {}, 0
        for p, u in zip(p0, opt.updates(p0, g16, opt.init(p0))):
            key, leaf = [(k, n) for k in start for n in sorted(start[k])][i]
            emulated.setdefault(key, {})[leaf] = (p + u).to(dtype).float().numpy()
            i += 1
        np.testing.assert_array_equal(got, _flat_adapters(emulated))
        flat16 = _flat_adapters({k: {n: g.numpy() for n, g in e.items()}
                                 for k, e in low["grads"].items()})
        flat32 = _flat_adapters({k: {n: g.numpy() for n, g in e.items()}
                                 for k, e in ref["grads"].items()})
        flushed = (flat16 == 0) & (flat32 != 0)
        assert np.count_nonzero(flushed) <= 1e-4 * got.size
        assert _rel(got[~flushed], want[~flushed]) <= sdxl_t.QLORA_REL
    else:
        _held_to_rounded(got, want, first, jdtype)
        assert np.count_nonzero(got != first) > 0
