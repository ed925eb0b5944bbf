"""Weight carry for the port's SD 1.5/2.x and SDXL modules.

- `sd_params_from_flax` and `sdxl_params_from_flax` load the reference's
  flax param trees (as numpy arrays) into the port's modules through the
  port's copy of the reference's key maps (`io/torch_flax.py`), strictly:
  every key must match.
- `lora_params_from_jax` turns the reference's LoRA adapter tree into the
  port's adapters (same keys, same torch layout, same dtype).
- `quantized_params_from_jax` loads a part the reference quantized
  (setup/quantize.py there): NF4 codes and scales and fp8/int8 codes and
  scale carried unchanged, every other leaf in its own dtype.
- `sd3_params_from_flax` does the same for SD3's transformer, three text
  encoders and VAE; `flux_params_from_flax` for FLUX's transformer, CLIP-L,
  T5 and VAE (the transformer's RMS norm `scale` leaves carried as
  diffusers' `weight`, as the generic key map carries every rank-1 leaf);
  `hunyuan_params_from_flax` for HunyuanVideo's transformer (its patchify
  kernel as the port's dense weight), Llama (`llama_params_from_flax`),
  CLIP-L and the causal VAE (`video_vae_params_from_flax`);
  `pixart_params_from_flax` for PixArt's transformer, T5 and VAE;
  `sana_params_from_flax` for Sana's transformer (`sana_flax_to_state_dict`),
  Gemma-2 (`gemma_params_from_flax`) and DC-AE (`dcae_params_from_flax`);
  `wuerstchen_params_from_flax` for a Würstchen v2 or Stable Cascade
  prior, its CLIP and the EfficientNet encoder, and
  `wuerstchen_decoder_params_from_flax` for DiffNeXt, the Paella VQGAN and
  the decoder's CLIP.
- `init_sd_weights` materialises full-width weights of either family on a
  device from a seeded `torch.Generator`, for runs without a checkpoint;
  `init_sd3_weights` those of an SD3 model, `init_flux_weights` those of a
  FLUX model, `init_hunyuan_weights` those of a HunyuanVideo model,
  `init_pixart_weights` those of a PixArt model, `init_sana_weights`
  those of a Sana model and `init_wuerstchen_weights` those of a Würstchen
  v2 or Stable Cascade model and its decoder stage.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from onetrainer_tpu_torch.io.torch_flax import (
    _nest, clip_flax_to_state_dict, t5_flax_to_state_dict, unet_flax_to_state_dict,
    vae_flax_to_state_dict,
)
from onetrainer_tpu_torch.ops.nf4 import NF4_BLOCK
from onetrainer_tpu_torch.ops.quant import NF4Array, QuantizedArray, logical_shape

# numpy dtypes without a torch counterpart in numpy (ml_dtypes' bf16 and
# fp8), carried by their bit patterns
_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(value, device: torch.device | str = "cpu") -> torch.Tensor:
    """A numpy (or numpy-convertible) array as a tensor of the same dtype
    and values, bf16 and fp8 included."""
    a = np.asarray(value)
    if a.dtype.name in _VIEWS:
        view, dtype = _VIEWS[a.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(a).view(view).copy()
                                ).view(dtype).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _load(module: nn.Module, state_dict: dict) -> None:
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in state_dict.items()}, strict=True)


def sd_params_from_flax(model, unet: dict, te: dict, vae: dict) -> None:
    """Load flax param trees into an SD 1.5/2.x `model`'s unet, text encoder
    and vae."""
    _load(model.unet, unet_flax_to_state_dict(unet))
    _load(model.text_encoder, clip_flax_to_state_dict(te))
    _load(model.vae, vae_flax_to_state_dict(vae))


def sdxl_params_from_flax(model, unet: dict, te: dict, te2: dict,
                          vae: dict) -> None:
    """Load flax param trees into `model`'s unet, text encoders and vae."""
    _load(model.unet, unet_flax_to_state_dict(unet))
    _load(model.text_encoder, clip_flax_to_state_dict(te))
    _load(model.text_encoder_2, clip_flax_to_state_dict(te2))
    _load(model.vae, vae_flax_to_state_dict(vae))


def sd3_params_from_flax(model, transformer: dict, te: dict, te2: dict, te3: dict,
                         vae: dict) -> None:
    """Load flax param trees into an SD3 `model`'s transformer, text
    encoders (CLIP-L, CLIP-G, T5) and vae."""
    _load(model.transformer, unet_flax_to_state_dict(transformer))
    _load(model.text_encoder, clip_flax_to_state_dict(te))
    _load(model.text_encoder_2, clip_flax_to_state_dict(te2))
    _load(model.text_encoder_3, t5_flax_to_state_dict(te3))
    _load(model.vae, vae_flax_to_state_dict(vae))


def flux_params_from_flax(model, transformer: dict, te: dict, te2: dict,
                          vae: dict) -> None:
    """Load flax param trees into a FLUX `model`'s transformer, text
    encoders (CLIP-L, T5) and vae."""
    _load(model.transformer, unet_flax_to_state_dict(transformer))
    _load(model.text_encoder, clip_flax_to_state_dict(te))
    _load(model.text_encoder_2, t5_flax_to_state_dict(te2))
    _load(model.vae, vae_flax_to_state_dict(vae))


def llama_params_from_flax(module: nn.Module, params: dict) -> None:
    """Load the reference's Llama flax tree into a `LlamaEncoder`."""
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import llama_flax_to_state_dict
    _load(module, llama_flax_to_state_dict(params))


def video_vae_params_from_flax(module: nn.Module, params: dict) -> None:
    """Load the reference's causal video VAE flax tree into an
    `AutoencoderKLVideo`."""
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import video_vae_flax_to_state_dict
    _load(module, video_vae_flax_to_state_dict(params))


def hunyuan_params_from_flax(model, transformer: dict, te: dict, te2: dict,
                             vae: dict) -> None:
    """Load flax param trees into a HunyuanVideo `model`'s transformer, text
    encoders (Llama, CLIP-L) and vae."""
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import (
        hunyuan_flax_to_state_dict, hunyuan_transformer_state_dict,
    )
    _load(model.transformer,
          hunyuan_transformer_state_dict(hunyuan_flax_to_state_dict(transformer)))
    llama_params_from_flax(model.text_encoder, te)
    _load(model.text_encoder_2, clip_flax_to_state_dict(te2))
    video_vae_params_from_flax(model.vae, vae)


def pixart_params_from_flax(model, transformer: dict, te: dict, vae: dict) -> None:
    """Load flax param trees into a PixArt `model`'s transformer, T5 and vae."""
    _load(model.transformer, unet_flax_to_state_dict(transformer))
    _load(model.text_encoder, t5_flax_to_state_dict(te))
    _load(model.vae, vae_flax_to_state_dict(vae))


def gemma_params_from_flax(module: nn.Module, params: dict) -> None:
    """Load the reference's Gemma-2 flax tree into a `Gemma2Encoder`."""
    from onetrainer_tpu_torch.io.sana_checkpoints import gemma_flax_to_state_dict
    _load(module, gemma_flax_to_state_dict(params))


def dcae_params_from_flax(module: nn.Module, params: dict) -> None:
    """Load the reference's DC-AE flax tree into an `AutoencoderDC`."""
    from onetrainer_tpu_torch.io.sana_checkpoints import dcae_flax_to_state_dict
    _load(module, dcae_flax_to_state_dict(params))


def sana_params_from_flax(model, transformer: dict, te: dict, vae: dict) -> None:
    """Load flax param trees into a Sana `model`'s transformer, Gemma-2 and
    DC-AE."""
    from onetrainer_tpu_torch.io.sana_checkpoints import (
        sana_flax_to_state_dict, sana_transformer_state_dict,
    )
    _load(model.transformer, sana_transformer_state_dict(sana_flax_to_state_dict(transformer)))
    gemma_params_from_flax(model.text_encoder, te)
    dcae_params_from_flax(model.vae, vae)


def wuerstchen_params_from_flax(model, prior: dict, te: dict | None = None,
                                effnet: dict | None = None) -> None:
    """Load the reference's flax trees into a Würstchen v2 or Stable Cascade
    `model`: the prior (diffusers' keys through the generic map), the CLIP
    text encoder and the EfficientNet encoder (torchvision's keys through
    the port's copy of the reference's effnet map), each when given."""
    from onetrainer_tpu_torch.io.torch_flax import flax_params_to_torch
    from onetrainer_tpu_torch.io.wuerstchen_checkpoints import effnet_flax_key_map
    _load(model.prior, flax_params_to_torch(prior))
    if te is not None:
        _load(model.text_encoder, clip_flax_to_state_dict(te))
    if effnet is not None:
        _load(model.effnet, flax_params_to_torch(effnet, key_map=effnet_flax_key_map))


def wuerstchen_decoder_params_from_flax(model, decoder: dict, vqgan: dict,
                                        te: dict | None = None) -> None:
    """Load the reference's DiffNeXt and Paella VQGAN flax trees (and the
    decoder's CLIP, when given) into `model`'s decoder stage."""
    from onetrainer_tpu_torch.io.torch_flax import flax_params_to_torch
    _load(model.decoder, flax_params_to_torch(decoder))
    _load(model.vqgan, flax_params_to_torch(vqgan))
    if te is not None:
        _load(model.decoder_text_encoder, clip_flax_to_state_dict(te))


# the adapter leaves of LoRA, DoRA and LoHa (peft/lora.py), in both packages
ADAPTER_LEAVES = frozenset({"lora_down", "lora_up", "dora_scale", "hada_w1_a",
                            "hada_w1_b", "hada_w2_a", "hada_w2_b"})


def lora_params_from_jax(adapters: dict,
                         device: torch.device | str = "cuda") -> dict:
    """The reference's adapter tree {module_key: {leaf: array}} (numpy, in
    the torch layout both packages store adapters in: LoRA's, DoRA's and
    LoHa's leaves) as the port's adapters on `device`, in the reference's
    dtype (fp32, fp16 or bf16)."""
    out = {}
    for key, entry in adapters.items():
        if not set(entry) <= ADAPTER_LEAVES:
            raise NotImplementedError(
                f"{key}: not a LoRA, DoRA or LoHa adapter, got {sorted(entry)}")
        out[key] = {name: tensor_from_numpy(value, device)
                    for name, value in entry.items()}
    return out


def lora_params_to_jax(adapters: dict) -> dict:
    """The port's adapters as the reference's tree: numpy arrays on the
    host in the same layout, bf16 and fp8 as ml_dtypes' (bit for bit)."""
    import ml_dtypes
    views = {dtype: (view, name) for name, (view, dtype) in _VIEWS.items()}
    out = {}
    for key, entry in adapters.items():
        out[key] = {}
        for name, t in entry.items():
            t = t.detach().cpu()
            if t.dtype in views:
                view, ml_name = views[t.dtype]
                out[key][name] = t.view(torch.int16 if view == np.int16 else torch.uint8) \
                    .numpy().view(getattr(ml_dtypes, ml_name))
            else:
                out[key][name] = t.numpy().copy()
    return out


def _quantized_from_jax(value, device):
    """A reference NF4Array / QuantizedArray as the port's, or None."""
    if hasattr(value, "scales") and hasattr(value, "block"):
        if value.block != NF4_BLOCK:
            raise NotImplementedError(f"NF4 block {value.block} is not ported (64 only)")
        return NF4Array(tensor_from_numpy(value.q, device),
                        tensor_from_numpy(value.scales, device), tuple(value.shape))
    if hasattr(value, "q") and hasattr(value, "scale"):
        return QuantizedArray(tensor_from_numpy(value.q, device),
                              tensor_from_numpy(value.scale, device))
    return None


@torch.no_grad()
def quantized_params_from_jax(module: nn.Module, tree: dict, to_state_dict,
                              device: torch.device | str = "cuda") -> None:
    """Load a reference param tree whose kernels are quantized into
    `module` exactly: each quantized kernel becomes the layer's quantized
    weight (kernel layout, codes and scales as they are), every other
    leaf a parameter of its own dtype (bf16 under the reference's
    policy), on `device` (the card unless the caller passes another).
    `to_state_dict` is the part's key map, e.g. `unet_flax_to_state_dict`."""
    plain, quantized = {}, {}
    for path, value in _leaves(tree):
        q = _quantized_from_jax(value, device)
        if q is None:
            plain[path] = value
            continue
        # the layer's state-dict key, through the part's own key map
        stand_in = np.broadcast_to(np.float32(0), logical_shape(q))
        (key,) = to_state_dict(_nest({path: stand_in}))
        quantized[key] = q
    state = {k: tensor_from_numpy(v, device) for k, v in to_state_dict(_nest(plain)).items()}
    missing, unexpected = module.load_state_dict(state, strict=False, assign=True)
    if unexpected or set(missing) != set(quantized):
        raise KeyError(f"tree does not match the module: missing {sorted(missing)[:8]}, "
                       f"unexpected {sorted(unexpected)[:8]}")
    for key, q in quantized.items():
        layer = module.get_submodule(key.removesuffix(".weight"))
        del layer.weight
        layer.weight = q


def _leaves(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@torch.no_grad()
def _init_module(module: nn.Module, gen: torch.Generator,
                 device: torch.device) -> None:
    module.to_empty(device=device)
    for sub in module.modules():
        if isinstance(sub, (nn.GroupNorm, nn.LayerNorm)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            sub.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(sub, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            # variance-preserving: std 1/sqrt(fan_in)
            fan_in = sub.weight[0].numel()
            sub.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
            if sub.bias is not None:
                sub.bias.zero_()


def init_sd_weights(model, seed: int, device: torch.device | str) -> None:
    """Seeded random weights for every module of `model` (SD 1.5/2.x or
    SDXL), on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules().values():
        _init_module(module, gen, device)
    model.device = device



@torch.no_grad()
def init_sd3_weights(model, seed: int, device: torch.device | str) -> None:
    """Seeded random weights for every module of an SD3, FLUX or HunyuanVideo
    `model`, on `device`, each parameter in the dtype it has on "meta" (cast
    a full-width FLUX transformer to bf16 there: 23.8 GB, not 47.6): dense,
    conv and embedding weights as `init_sd_weights` draws them, RMS, T5 and
    Llama norm weights 1, SD3's position table ~ N(0, 0.02)."""
    from onetrainer_tpu_torch.models.flux import RMSNorm
    from onetrainer_tpu_torch.models.llama import LlamaRMSNorm
    from onetrainer_tpu_torch.models.sd3 import PatchEmbed
    from onetrainer_tpu_torch.models.t5 import T5LayerNorm
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules().values():
        _init_module(module, gen, device)
        for sub in module.modules():
            if isinstance(sub, (RMSNorm, T5LayerNorm, LlamaRMSNorm)):
                sub.weight.fill_(1.0)
            elif isinstance(sub, PatchEmbed):
                sub.pos_embed.normal_(0.0, 0.02, generator=gen)
    model.device = device


@torch.no_grad()
def init_pixart_weights(model, seed: int, device: torch.device | str) -> None:
    """Seeded random weights for every module of a PixArt or Sana `model`,
    on `device`, each parameter in the dtype it has on "meta": dense, conv,
    embedding and norm weights as `init_sd3_weights` draws them, the
    AdaLN-single tables ~ N(0, 0.02) (the reference's init), Gemma's norm
    weights 0 (it scales by 1 + weight), the RMS norms' weights 1 and
    DC-AE's norm biases 0."""
    from onetrainer_tpu_torch.models.dcae import RMSNorm2d
    from onetrainer_tpu_torch.models.gemma import GemmaRMSNorm
    from onetrainer_tpu_torch.models.sana import SanaRMSNorm
    from onetrainer_tpu_torch.models.t5 import T5LayerNorm
    init_sd3_weights(model, seed, device)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed + 1)
    for module in model.modules().values():
        for sub in module.modules():
            if isinstance(sub, (SanaRMSNorm, T5LayerNorm)):
                sub.weight.fill_(1.0)
            elif isinstance(sub, GemmaRMSNorm):
                sub.weight.zero_()
            elif isinstance(sub, RMSNorm2d):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
            table = getattr(sub, "scale_shift_table", None)
            if isinstance(table, nn.Parameter):
                table.normal_(0.0, 0.02, generator=gen)


init_sana_weights = init_pixart_weights


# FLUX's parts (its DiT, CLIP-L, T5, VAE) and HunyuanVideo's (its DiT,
# Llama, CLIP-L, the causal VAE's conv3d weights) draw as SD3's do
init_flux_weights = init_hunyuan_weights = init_sd3_weights


@torch.no_grad()
def init_wuerstchen_weights(model, seed: int, device: torch.device | str,
                            parts: tuple[str, ...] | None = None) -> None:
    """Seeded random weights for a Würstchen v2 or Stable Cascade `model`'s
    parts (`parts`, default: the prior, the text encoder, the effnet and,
    when set, the decoder stage), on `device`, each parameter in the dtype
    it has on "meta": dense, conv and embedding weights as `init_sd_weights`
    draws them (transposed convs' too), GRN's gamma and beta and the VQGAN
    blocks' gammas 0 (diffusers' init), BatchNorm's statistics 0 and 1."""
    from onetrainer_tpu_torch.models.paella_vq import MixingResidualBlock
    from onetrainer_tpu_torch.models.wuerstchen import FrozenBatchNorm, GlobalResponseNorm
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    parts = parts or tuple(name for name in ("prior", "text_encoder", "effnet", "decoder",
                                             "vqgan", "decoder_text_encoder")
                           if getattr(model, name, None) is not None)
    for name in parts:
        module = getattr(model, name)
        _init_module(module, gen, device)
        for sub in module.modules():
            if isinstance(sub, nn.ConvTranspose2d):
                sub.weight.normal_(0.0, sub.weight[0].numel() ** -0.5, generator=gen)
                sub.bias.zero_()
            elif isinstance(sub, GlobalResponseNorm):
                sub.gamma.zero_()
                sub.beta.zero_()
            elif isinstance(sub, FrozenBatchNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
                sub.running_mean.zero_()
                sub.running_var.fill_(1.0)
            elif isinstance(sub, MixingResidualBlock):
                sub.gammas.zero_()
    model.device = device
