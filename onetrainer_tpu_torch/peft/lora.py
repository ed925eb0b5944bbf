"""LoRA adapters for the port's modules.

Counterpart of onetrainer_tpu/peft/lora.py, LoRA only. Adapters live apart
from the base modules, in a dict keyed by the reference's module path
(`down_blocks_1/attentions_0/transformer_blocks_0/attn1/to_q`, `SEP` "/"):
{module_key: {"lora_down": [r, in(, kh, kw)], "lora_up": [out, r]}}, the
torch layout the reference stores them in. A module's key is its
state_dict name mapped onto the reference's flax path (list indices
merged, `key_map` first for modules whose names differ, e.g. CLIP's
`io.torch_flax.clip_torch_key_map`).

`attach_peft` hands the adapter tensors to the layers, which apply them
inside the layer (peft/layers.py); `apply_peft` / `merge_peft_into_base`
give merged weights W + up.down.alpha/r for sampling and export;
`peft_to_kohya_state_dict` and `kohya_state_dict_to_peft` carry adapters
to and from kohya's flat key layout, the LoRA files the ecosystem reads.
DoRA, LoHa and rank dropout raise NotImplementedError.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

import torch
from torch import nn

from onetrainer_tpu_torch.io.torch_flax import merge_int_tokens
from onetrainer_tpu_torch.ops.quant import is_quantized, module_is_quantized, weight_shape
from onetrainer_tpu_torch.peft.layers import LoraAdapter, attach_adapter
from onetrainer_tpu_torch.util.enums import PeftType

SEP = "/"

KeyMap = Callable[[str], "str | None"]


@dataclass(frozen=True)
class PeftConfig:
    peft_type: PeftType = PeftType.LORA
    rank: int = 16
    alpha: float = 1.0
    dropout: float = 0.0
    decompose: bool = False               # DoRA
    layer_filter: tuple[str, ...] = ()    # substrings; empty = all layers
    weight_dtype: torch.dtype = torch.float32

    @staticmethod
    def from_train_config(config) -> "PeftConfig":
        layer_filter = tuple(
            t.strip() for t in (config.lora_layers or "").split(",") if t.strip())
        return PeftConfig(
            peft_type=config.peft_type,
            rank=config.lora_rank,
            alpha=config.lora_alpha,
            dropout=config.dropout_probability,
            decompose=config.lora_decompose,
            layer_filter=layer_filter,
            weight_dtype=config.weight_dtypes().lora.to_torch_dtype() or torch.float32,
        )

    def check_supported(self) -> None:
        if self.peft_type != PeftType.LORA:
            raise NotImplementedError(f"{self.peft_type} is not ported yet (LoRA only)")
        if self.decompose:
            raise NotImplementedError("DoRA is not ported yet")
        if self.dropout > 0:
            raise NotImplementedError("LoRA rank dropout is not ported yet")


def module_key(name: str, key_map: KeyMap | None = None) -> str | None:
    """The reference's module path for the port's module `name`."""
    key = name + ".weight"
    if key_map is not None:
        key = key_map(key)
        if key is None:
            return None
    return SEP.join(merge_int_tokens(key)[:-1])


def _adaptable(module: nn.Module, key_map: KeyMap | None,
               layer_filter: tuple[str, ...]):
    """(key, layer) for every layer the reference's `_kernel_paths` adapts:
    dense and conv kernels, minus grouped/depthwise convs. A quantized
    frozen weight (QLoRA) is selected like any other: skipping it would
    leave an empty adapter set and a step that only runs forward."""
    for name, layer in module.named_modules():
        if isinstance(layer, nn.Conv2d):
            if layer.groups != 1:
                continue
        elif not isinstance(layer, nn.Linear):
            continue
        key = module_key(name, key_map)
        if key is None:
            continue
        if layer_filter and not any(f in key for f in layer_filter):
            continue
        yield key, layer


def peft_module_keys(module: nn.Module, cfg: PeftConfig,
                     key_map: KeyMap | None = None) -> list[str]:
    """Module keys that init_peft_params would adapt for this module."""
    return [key for key, _ in _adaptable(module, key_map, cfg.layer_filter)]


def adapter_shapes(module: nn.Module, cfg: PeftConfig,
                   key_map: KeyMap | None = None) -> dict:
    """{module_key: {"lora_down": shape, "lora_up": shape}}: the shapes
    init_peft_params gives the adapters, from each weight's logical shape
    (a module on the "meta" device will do)."""
    shapes = {}
    for key, layer in _adaptable(module, key_map, cfg.layer_filter):
        shape = tuple(weight_shape(layer.weight))
        shapes[key] = {"lora_down": (cfg.rank,) + shape[1:], "lora_up": (shape[0], cfg.rank)}
    return shapes


def init_peft_params(generator: torch.Generator, module: nn.Module,
                     cfg: PeftConfig, key_map: KeyMap | None = None) -> dict:
    """Create the adapters {module_key: {"lora_down", "lora_up"}} on the
    module's device: down ~ U(+-1/sqrt(fan_in)) (kaiming_uniform(a=sqrt(5))),
    up = 0, in `cfg.weight_dtype`. `generator` must live on that device.
    Shapes come from each weight's logical (torch-layout) shape, so a
    quantized base gets the adapters of its unquantized form."""
    cfg.check_supported()
    adapters = {}
    for key, layer in _adaptable(module, key_map, cfg.layer_filter):
        weight = layer.weight
        shape = weight_shape(weight)
        device = (weight.q if is_quantized(weight) else weight).device
        bound = 1.0 / math.sqrt(math.prod(shape[1:]))
        down = torch.empty((cfg.rank,) + shape[1:], dtype=cfg.weight_dtype,
                           device=device)
        down.uniform_(-bound, bound, generator=generator)
        up = torch.zeros((shape[0], cfg.rank), dtype=cfg.weight_dtype, device=device)
        adapters[key] = {"lora_down": down, "lora_up": up}
    return adapters


def attach_peft(module: nn.Module, adapters: dict | None, cfg: PeftConfig | None,
                key_map: KeyMap | None = None) -> None:
    """Hand each adapter's tensors to its layer (the layer adds the LoRA
    term in its forward). Layers without an adapter, and every layer when
    `adapters` is None, are detached."""
    if adapters:
        cfg.check_supported()
    for key, layer in _adaptable(module, key_map, ()):
        entry = (adapters or {}).get(key)
        attach_adapter(layer, None if entry is None else LoraAdapter(
            entry["lora_down"], entry["lora_up"], cfg.alpha / cfg.rank))


def _delta(entry: dict, cfg: PeftConfig, shape: torch.Size) -> torch.Tensor:
    down = entry["lora_down"].float().reshape(cfg.rank, -1)
    return (entry["lora_up"].float() @ down).reshape(shape) * (cfg.alpha / cfg.rank)


@torch.no_grad()
def apply_peft(module: nn.Module, adapters: dict, cfg: PeftConfig,
               key_map: KeyMap | None = None) -> dict[str, torch.Tensor]:
    """The module's state_dict with every adapter merged into its weight,
    W + up.down.alpha/r (fp32, then the weight's dtype)."""
    cfg.check_supported()
    if module_is_quantized(module):
        raise NotImplementedError("merging into a quantized base is not ported yet")
    names = {key: name for name, _ in module.named_modules()
             if (key := module_key(name, key_map)) is not None}
    out = dict(module.state_dict())
    for key, entry in adapters.items():
        wname = names[key] + ".weight"
        w = out[wname]
        out[wname] = (w.float() + _delta(entry, cfg, w.shape)).to(w.dtype)
    return out


def merge_peft_into_base(module: nn.Module, adapters: dict, cfg: PeftConfig,
                         key_map: KeyMap | None = None) -> nn.Module:
    """Bake the adapters into `module`'s weights, in place (for merged
    export and sampling); returns the module."""
    module.load_state_dict(apply_peft(module, adapters, cfg, key_map), strict=True)
    return module


# -- kohya-format safetensors interop ---------------------------------------------

# CLIP text-encoder adapter groups: the kohya ecosystem names TE modules
# through the HF module tree ('lora_te_text_model_encoder_layers_0_mlp_fc1');
# the module keys drop the text_model/encoder nesting, so re-insert it.
_CLIP_TE_PREFIXES = frozenset({"lora_te", "lora_te1", "lora_te2",
                               "lora_prior_te"})


def _module_key_to_kohya(prefix: str, module_key: str) -> str:
    # 'down_blocks_0/attentions_0/.../to_q' -> prefix + '_down_blocks_0_...'
    key = module_key
    if prefix in _CLIP_TE_PREFIXES and key.startswith("layers_"):
        key = "text_model_encoder_" + key
    return prefix + "_" + key.replace(SEP, "_")


def peft_to_kohya_state_dict(adapters: dict, cfg: PeftConfig,
                             prefix: str) -> dict[str, torch.Tensor]:
    """Adapters -> kohya-style flat tensors: lora_down.weight [r, in(,kh,
    kw)], lora_up.weight [out, r(,1,1)] and alpha (fp32), detached, in the
    adapters' dtype and on their device (reference output contract:
    modules/modelSaver/mixin/LoRASaverMixin via omi/kohya key sets)."""
    cfg.check_supported()
    out: dict[str, torch.Tensor] = {}
    for module_key, entry in adapters.items():
        kkey = _module_key_to_kohya(prefix, module_key)
        down = entry["lora_down"].detach()
        up = entry["lora_up"].detach()
        if down.ndim == 4:
            up = up.reshape(up.shape[0], up.shape[1], 1, 1)
        out[f"{kkey}.lora_down.weight"] = down
        out[f"{kkey}.lora_up.weight"] = up
        out[f"{kkey}.alpha"] = torch.tensor(cfg.alpha, dtype=torch.float32)
    return out


def kohya_state_dict_to_peft(state_dict: dict, prefix: str,
                             module_keys: list[str]) -> tuple[dict, float | None]:
    """kohya tensors (one prefix) -> adapters (+ alpha if present).

    The kohya flattening ('down_blocks_0_..._to_q') is ambiguous to invert
    textually, so `module_keys` (the adapter keys valid for the target
    model, e.g. from peft_module_keys) provides the reverse lookup. Other
    leaves than LoRA's (DoRA, LoHa) raise."""
    reverse = {_module_key_to_kohya(prefix, mk): mk for mk in module_keys}
    adapters: dict[str, dict] = {}
    alpha = None
    for key, tensor in state_dict.items():
        if not key.startswith(prefix + "_"):
            continue
        module_part, _, leaf = key.partition(".")
        if module_part not in reverse:
            continue
        entry = adapters.setdefault(reverse[module_part], {})
        if leaf == "lora_down.weight":
            entry["lora_down"] = tensor
        elif leaf == "lora_up.weight":
            entry["lora_up"] = tensor.reshape(tensor.shape[0], tensor.shape[1]) \
                if tensor.ndim == 4 else tensor
        elif leaf == "alpha":
            alpha = float(tensor.reshape(-1)[0])
        else:
            raise NotImplementedError(f"{key}: only LoRA tensors are ported")
    return adapters, alpha
