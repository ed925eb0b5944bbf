"""The port's weight quantization against the reference's
(onetrainer_tpu/ops/quant.py, ops/nf4_pallas.py, setup/quantize.py).

Tolerances: none where the arithmetic is the same. NF4 codes and scales,
fp8 and int8 codes and scale, and every dequantized value (fp32 and bf16)
are compared bit for bit: both sides divide, round and multiply in fp32
with the same IEEE operations. The plain K4 is bit-exact against the
reference's Pallas kernel in interpret mode and its jnp path. A LoRA layer
on each quantized base computes in fp32 on both sides: 1e-5 (matmul and
convolution sums in another order).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.ops import quant as jq
from onetrainer_tpu.ops.nf4_pallas import nf4_dequant_flat as jax_nf4_dequant_flat
from onetrainer_tpu.ops.nf4_pallas import nf4_pad_len as jax_nf4_pad_len
from onetrainer_tpu.peft.layers import LoraConv, LoraDense
from onetrainer_tpu.setup.quantize import quantize_frozen_parts as jax_quantize_frozen_parts
from onetrainer_tpu.util import enums as jax_enums
from onetrainer_tpu.util.model_names import ModelWeightDtypes
from onetrainer_tpu_torch.io.torch_flax import clip_flax_to_state_dict, unet_flax_to_state_dict
from onetrainer_tpu_torch.io.weights import quantized_params_from_jax, sdxl_params_from_flax
from onetrainer_tpu_torch.models import layers as pt_layers
from onetrainer_tpu_torch.ops import nf4 as pt_nf4
from onetrainer_tpu_torch.ops import quant as pq
from onetrainer_tpu_torch.peft.layers import LoraAdapter, attach_adapter
from onetrainer_tpu_torch.peft.lora import PeftConfig, init_peft_params
from onetrainer_tpu_torch.setup.quantize import quantize_frozen_parts
from onetrainer_tpu_torch.util import enums as pt_enums
from onetrainer_tpu_torch.util.model_names import ModelWeightDtypes as PortWeightDtypes
from tests.test_sdxl import tiny_sdxl_model
from tests.test_torch_port_models import port_model_like, random_flax_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = [(16, 256), (3, 3, 40, 64), (1000, 7)]
# the reference's NF4 functions compiled whole, once per shape (op by op
# they compile each primitive per shape, which is slower on the CPU). The
# per-tensor formats run op by op, as the reference's setup runs them:
# compiled, XLA turns absmax / 448 into a multiply by 1/448
_jax_quantize_nf4 = jax.jit(jq.quantize_nf4)
_jax_dequantize_nf4 = jax.jit(jq.dequantize_nf4, static_argnums=1)


def _jax_dequantize(x, dtype):
    if isinstance(x, jq.NF4Array):
        return _jax_dequantize_nf4(x, dtype)
    return jq.dequantize_array(x, dtype)


FORMATS = {"nf4": ("nf4", "nf4"),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
           "int8": (jnp.int8, torch.int8)}


def _bits(a) -> np.ndarray:
    """The bit pattern of an array (jax or torch), as unsigned integers."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.float()
        a = a.view(torch.uint8) if a.element_size() == 1 else a
        a = a.numpy()
    else:
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return a.view(f"u{a.dtype.itemsize}")


def _sample(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 2.0)
    x.flat[:2] = (0.0, 1e-30)
    return x


def _quantize_both(fmt, x):
    jdt, tdt = FORMATS[fmt]
    if fmt == "nf4":
        return _jax_quantize_nf4(jnp.asarray(x)), pq.quantize_nf4(torch.from_numpy(x))
    return jq.quantize_array(jnp.asarray(x), jdt), pq.quantize_array(torch.from_numpy(x), tdt)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_codes_scales_and_values_are_bit_exact(fmt):
    for i, shape in enumerate(SHAPES):
        x = _sample(shape, i)
        ref, got = _quantize_both(fmt, x)
        np.testing.assert_array_equal(_bits(got.q), _bits(ref.q), err_msg=str(shape))
        if fmt == "nf4":
            np.testing.assert_array_equal(_bits(got.scales), _bits(ref.scales))
            assert got.shape == tuple(ref.shape) and ref.block == pt_nf4.NF4_BLOCK
        else:
            np.testing.assert_array_equal(_bits(got.scale), _bits(ref.scale))
        assert pq.logical_shape(got) == tuple(jq.logical_shape(ref)) == shape
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            np.testing.assert_array_equal(
                _bits(pq.maybe_dequantize(got, tdt)), _bits(_jax_dequantize(ref, jdt)),
                err_msg=f"{shape} {tdt}")


def test_plain_k4_matches_pallas_interpret_and_jnp():
    """nf4_dequant_reference (the plain K4, which nf4_dequant_flat runs on
    the CPU) against the reference's Pallas kernel in interpret mode and
    its jnp dequant, as tests/test_quant.py holds the two reference paths."""
    for i, shape in enumerate([(16, 256), (777, 3)]):
        x = _sample(shape, 10 + i)
        ref, got = _quantize_both("nf4", x)
        n = x.size
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            plain = pt_nf4.nf4_dequant_reference(got.q, got.scales, tdt)
            assert torch.equal(pt_nf4.nf4_dequant_flat(got.q, got.scales, tdt), plain)
            pallas = jax_nf4_dequant_flat(ref.q, ref.scales, out_dtype=jdt, interpret=True)
            np.testing.assert_array_equal(_bits(plain), _bits(pallas))
            np.testing.assert_array_equal(_bits(plain[:n].reshape(shape)),
                                          _bits(_jax_dequantize(ref, jdt)))
    for n in (1, 2, 2047, 2048, 2049, 777_000, 29_491_200):
        assert pt_nf4.nf4_pad_len(n) == jax_nf4_pad_len(n)


def test_kernel_code_table_is_nf4_code():
    """csrc/nf4_dequant.cu carries NF4_CODE as hexadecimal fp32 literals;
    they are the fp32 values the plain version multiplies by."""
    src = (Path(pt_nf4.__file__).parent.parent / "csrc" / "nf4_dequant.cu").read_text()
    table = src[src.index("kCode[16]"):src.index("};", src.index("kCode[16]"))]
    values = [float.fromhex(v) for v in re.findall(r"(-?0x[0-9a-fA-F.]+p[+-]\d+)f", table)]
    np.testing.assert_array_equal(np.float32(values), np.float32(jq.NF4_CODE))
    assert pt_nf4.NF4_CODE == jq.NF4_CODE


def _dense_case(rng):
    x = rng.standard_normal((3, 7, 80)).astype(np.float32)
    kernel = (rng.standard_normal((80, 96)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(96) * 0.1).astype(np.float32)
    down = (rng.standard_normal((4, 80)) * 0.1).astype(np.float32)
    up = (rng.standard_normal((96, 4)) * 0.1).astype(np.float32)
    return x, kernel, bias, down, up


@pytest.mark.parametrize("fmt", list(FORMATS))
@torch.no_grad()
def test_lora_layer_on_quantized_base_matches_jax(fmt):
    """LoraDense / LoraConv over a quantized kernel (dequantized in the
    layer) against the port's linear / conv with the same quantized weight
    and adapter, in fp32."""
    rng = np.random.default_rng(3)
    jdt, tdt = FORMATS[fmt]
    scale = 8.0 / 4

    def quantize_jax(k):
        return _jax_quantize_nf4(jnp.asarray(k)) if fmt == "nf4" else \
            jq.quantize_array(jnp.asarray(k), jdt)

    def quantize_port(k):
        return pq.quantize_nf4(torch.from_numpy(k)) if fmt == "nf4" else \
            pq.quantize_array(torch.from_numpy(k), tdt)

    # dense
    x, kernel, bias, down, up = _dense_case(rng)
    want = LoraDense(96, dtype=jnp.float32).apply(
        {"params": {"kernel": quantize_jax(kernel), "bias": bias},
         "lora": {"lora_down": down * scale, "lora_up": up}}, jnp.asarray(x))
    layer = torch.nn.Linear(80, 96)
    layer.bias.data = torch.from_numpy(bias)
    del layer.weight
    layer.weight = quantize_port(kernel)
    attach_adapter(layer, LoraAdapter(torch.from_numpy(down), torch.from_numpy(up), scale))
    got = pt_layers.linear(layer, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    # 3x3 conv, NHWC on the reference's side
    xc = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    kc = (rng.standard_normal((3, 3, 16, 32)) * 0.1).astype(np.float32)
    bc = (rng.standard_normal(32) * 0.1).astype(np.float32)
    dc = (rng.standard_normal((4, 16, 3, 3)) * 0.1).astype(np.float32)
    uc = (rng.standard_normal((32, 4)) * 0.1).astype(np.float32)
    want = LoraConv(32, (3, 3), padding=((1, 1), (1, 1)), dtype=jnp.float32).apply(
        {"params": {"kernel": quantize_jax(kc), "bias": bc},
         "lora": {"lora_down": dc * scale, "lora_up": uc}}, jnp.asarray(xc))
    conv = torch.nn.Conv2d(16, 32, 3, padding=1)
    conv.bias.data = torch.from_numpy(bc)
    del conv.weight
    conv.weight = quantize_port(kc)
    attach_adapter(conv, LoraAdapter(torch.from_numpy(dc), torch.from_numpy(uc), scale))
    got = pt_layers.conv(conv, torch.from_numpy(xc).permute(0, 3, 1, 2), torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(80, 96)
        self.conv = torch.nn.Conv2d(16, 32, 3, padding=1)
        self.depthwise = torch.nn.Conv2d(16, 16, 3, groups=16)
        self.small = torch.nn.Linear(8, 8)
        self.table = torch.nn.Embedding(50, 96)
        self.norm = torch.nn.LayerNorm(96)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_adapter_init_on_quantized_base_equals_unquantized(fmt):
    """QLoRA: adapters over a quantized base select the same layers with
    the same shapes and draws as over the full-precision base (the
    reference's guard, tests/test_peft.py:246: a skipped quantized layer
    leaves an empty adapter set and a forward-only step)."""
    cfg = PeftConfig(rank=4)
    torch.manual_seed(0)
    net = _Net()
    want = init_peft_params(torch.Generator().manual_seed(0), net, cfg)
    pq.quantize_module(net, FORMATS[fmt][1], min_size=1)
    assert all(pq.is_quantized(m.weight) for m in (net.proj, net.conv, net.small))
    assert isinstance(net.table.weight, torch.Tensor)   # embedding tables stay tensors
    got = init_peft_params(torch.Generator().manual_seed(0), net, cfg)
    assert set(got) == set(want) == {"proj", "conv", "small"}
    for key, entry in want.items():
        for name, value in entry.items():
            assert torch.equal(got[key][name], value), (fmt, key, name)


def test_quantize_frozen_parts_policy_matches_jax():
    """The tiny SDXL UNet in NF4 and TE2 in fp8 through both setups'
    quantize_frozen_parts: the same layers quantized with the same codes
    and scales, everything else bf16 with the same values (embedding
    tables, biases, norm scales and small kernels included), TE1 (fp32)
    untouched; the reference's quantized trees carried into a fresh port
    model equal the port's own; and to_load_dtype keeps quantized types
    at bf16."""
    jax_model = tiny_sdxl_model()
    jax_model.unet_config = dataclasses.replace(jax_model.unet_config,
                                                block_out_channels=(64, 64))
    port = port_model_like(jax_model)
    unet, te, te2, vae = random_flax_params(port, seed=2)
    sdxl_params_from_flax(port, unet, te, te2, vae)

    def wd(cls, enums):
        return cls(enums.DataType.BFLOAT_16, enums.DataType.BFLOAT_16,
                   enums.DataType.NFLOAT_4, enums.DataType.NONE, enums.DataType.FLOAT_32,
                   enums.DataType.FLOAT_8, *([enums.DataType.NONE] * 9))
    parts = {"unet": "unet", "text_encoder": "text_encoder",
             "text_encoder_2": "text_encoder_2"}
    frozen = jax_quantize_frozen_parts(
        {"unet": jax.tree.map(jnp.asarray, unet), "text_encoder": jax.tree.map(jnp.asarray, te),
         "text_encoder_2": jax.tree.map(jnp.asarray, te2)},
        wd(ModelWeightDtypes, jax_enums), parts)
    quantize_frozen_parts({k: port.modules()[k] for k in parts},
                          wd(PortWeightDtypes, pt_enums), parts)

    for key, module, to_sd in (("unet", port.unet, unet_flax_to_state_dict),
                               ("text_encoder_2", port.text_encoder_2,
                                clip_flax_to_state_dict)):
        carried = port_model_like(jax_model).modules()[key]
        quantized_params_from_jax(carried, jax.device_get(frozen[key]), to_sd,
                                  device="cpu")
        n_quantized = 0
        for name, layer in module.named_modules():
            w = getattr(layer, "weight", None)
            if not pq.is_quantized(w):
                continue
            n_quantized += 1
            other = carried.get_submodule(name).weight
            assert type(other) is type(w), name
            for a, b in zip(w[:2], other[:2]):
                np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
        assert n_quantized == sum(jq.is_quantized(leaf) for leaf in jax.tree.leaves(
            frozen[key], is_leaf=jq.is_quantized)) > 0, key
        state, carried_state = module.state_dict(), carried.state_dict()
        assert set(state) == set(carried_state)
        for name, value in state.items():
            assert value.dtype == torch.bfloat16 or not value.is_floating_point(), name
            assert torch.equal(value, carried_state[name]), name
    assert port.text_encoder.text_model.embeddings.token_embedding.weight.dtype == torch.float32
    assert not any(pq.is_quantized(getattr(m, "weight", None))
                   for m in port.text_encoder.modules())
    emb = port.text_encoder_2.text_model.embeddings.token_embedding.weight
    assert isinstance(emb, torch.Tensor) and emb.dtype == torch.bfloat16
    for member in jax_enums.DataType:
        want = member.to_load_dtype()
        got = pt_enums.DataType(member.value).to_load_dtype()
        assert (got is None) == (want is None)
        if want is not None:
            assert str(got).removeprefix("torch.") == jnp.dtype(want).name
    # a second pass leaves a quantized part alone
    before = port.unet.conv_in.weight
    quantize_frozen_parts({"unet": port.unet}, wd(PortWeightDtypes, pt_enums), {"unet": "unet"})
    assert port.unet.conv_in.weight is before
