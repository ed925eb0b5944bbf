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
give merged weights W + up.down.alpha/r for sampling and export.
DoRA, LoHa and rank dropout raise NotImplementedError.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

import torch
from torch import nn

from onetrainer_tpu_torch.io.torch_flax import merge_int_tokens
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
    dense and conv kernels, minus grouped/depthwise convs."""
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


def init_peft_params(generator: torch.Generator, module: nn.Module,
                     cfg: PeftConfig, key_map: KeyMap | None = None) -> dict:
    """Create the adapters {module_key: {"lora_down", "lora_up"}} on the
    module's device: down ~ U(+-1/sqrt(fan_in)) (kaiming_uniform(a=sqrt(5))),
    up = 0, in `cfg.weight_dtype`. `generator` must live on that device."""
    cfg.check_supported()
    adapters = {}
    for key, layer in _adaptable(module, key_map, cfg.layer_filter):
        weight = layer.weight
        fan_in = weight[0].numel()
        bound = 1.0 / math.sqrt(fan_in)
        down = torch.empty((cfg.rank,) + tuple(weight.shape[1:]),
                           dtype=cfg.weight_dtype, device=weight.device)
        down.uniform_(-bound, bound, generator=generator)
        up = torch.zeros((weight.shape[0], cfg.rank), dtype=cfg.weight_dtype,
                         device=weight.device)
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
