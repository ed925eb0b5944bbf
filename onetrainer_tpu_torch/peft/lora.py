"""PEFT adapters (LoRA, DoRA, LoHa) for the port's modules.

Counterpart of onetrainer_tpu/peft/lora.py. Adapters live apart from the
base modules, in a dict keyed by the reference's module path
(`down_blocks_1/attentions_0/transformer_blocks_0/attn1/to_q`, `SEP` "/"),
in the torch layout the reference stores them in:

    LoRA  {"lora_down": [r, in(, kh, kw)], "lora_up": [out, r]}
    DoRA  LoRA's plus "dora_scale": [out, 1] / [1, in] (linear),
          [out, 1, 1, 1] / [1, in, 1, 1] (conv)
    LoHa  {"hada_w1_a": [out, r], "hada_w1_b": [r, in(, kh, kw)],
           "hada_w2_a": [out, r], "hada_w2_b": [r, in(, kh, kw)]}

A module's key is its state_dict name mapped onto the reference's flax
path (list indices merged, `key_map` first for modules whose names differ,
e.g. CLIP's `io.torch_flax.clip_torch_key_map`).

`attach_peft` hands the adapter tensors to the layers, which apply them
inside the layer (peft/layers.py); `RankDropout` sets rank dropout's keep
masks on the attached LoRA adapters for one step. `apply_peft` /
`merge_peft_into_base` give merged weights (over a quantized base: decoded
through K4 and merged in fp32, bf16 results) for sampling and export;
`peft_to_kohya_state_dict` and `kohya_state_dict_to_peft` carry adapters
to and from kohya's flat key layout, the LoRA files the ecosystem reads,
and `apply_lora_checkpoint` continues training from such a file.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from contextlib import contextmanager
from dataclasses import dataclass, replace

import torch
from torch import nn

from onetrainer_tpu_torch.io.torch_flax import merge_int_tokens
from onetrainer_tpu_torch.ops.quant import (
    dequantized_weight, is_quantized, module_is_quantized, weight_shape,
)
from onetrainer_tpu_torch.peft.layers import (
    LoraAdapter, LohaAdapter, attach_adapter, dora_norm,
)
from onetrainer_tpu_torch.util.enums import PeftType

SEP = "/"

KeyMap = Callable[[str], "str | None"]

LOHA_LEAVES = ("hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b")


@dataclass(frozen=True)
class PeftConfig:
    peft_type: PeftType = PeftType.LORA
    rank: int = 16
    alpha: float = 1.0
    dropout: float = 0.0
    decompose: bool = False               # DoRA
    decompose_output_axis: bool = False
    decompose_norm_epsilon: bool = True
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
            decompose_output_axis=config.lora_decompose_output_axis,
            decompose_norm_epsilon=config.lora_decompose_norm_epsilon,
            layer_filter=layer_filter,
            weight_dtype=config.weight_dtypes().lora.to_torch_dtype() or torch.float32,
        )

    @property
    def dora_eps(self) -> float:
        return torch.finfo(torch.float32).eps if self.decompose_norm_epsilon else 0.0


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


def _shapes(shape: tuple, cfg: PeftConfig) -> dict:
    """The adapter shapes of a weight of torch-layout `shape`."""
    r = cfg.rank
    down = (r,) + tuple(shape[1:])
    if cfg.peft_type == PeftType.LOHA:
        return {"hada_w1_a": (shape[0], r), "hada_w1_b": down,
                "hada_w2_a": (shape[0], r), "hada_w2_b": down}
    if cfg.peft_type != PeftType.LORA:
        raise ValueError(cfg.peft_type)
    out = {"lora_down": down, "lora_up": (shape[0], r)}
    if cfg.decompose:
        spatial = (1,) * (len(shape) - 2)
        out["dora_scale"] = (shape[0], 1) + spatial if cfg.decompose_output_axis \
            else (1, shape[1]) + spatial
    return out


def adapter_shapes(module: nn.Module, cfg: PeftConfig,
                   key_map: KeyMap | None = None) -> dict:
    """{module_key: {leaf: shape}}: the shapes init_peft_params gives the
    adapters, from each weight's logical shape (a module on the "meta"
    device will do)."""
    return {key: _shapes(weight_shape(layer.weight), cfg)
            for key, layer in _adaptable(module, key_map, cfg.layer_filter)}


def _check_weight_dtype(cfg: PeftConfig) -> None:
    """The reference draws its adapters with jax.random in the weight
    dtype, which refuses integer dtypes with these messages."""
    dtype = cfg.weight_dtype
    if not dtype.is_floating_point:
        name = str(dtype).removeprefix("torch.")
        raise ValueError(
            f"dtype argument to `normal` must be a float or complex dtype, got {name}"
            if cfg.peft_type == PeftType.LOHA else
            f"dtype argument to `uniform` must be a float dtype, got {name}")


def init_peft_params(generator: torch.Generator, module: nn.Module,
                     cfg: PeftConfig, key_map: KeyMap | None = None) -> dict:
    """Create the adapters {module_key: {leaf: tensor}} on the module's
    device in `cfg.weight_dtype`, from `generator` (which must live on that
    device; fp8 adapters are drawn in fp32 and rounded, torch having no
    fp8 draws). LoRA: down ~ U(+-1/sqrt(fan_in)) (kaiming_uniform(a=sqrt(5))),
    up = 0, and under DoRA `dora_scale`, the weight's norm (fp32; a
    quantized weight decoded to bf16 first, through K4 for NF4 on the
    card). LoHa: w1a ~ 0.1 N(0, 1), w1b ~ N(0, 1), w2a = 0, w2b ~ N(0, 1).
    Shapes come from each weight's logical (torch-layout) shape, so a
    quantized base gets the adapters of its unquantized form."""
    _check_weight_dtype(cfg)
    dt = cfg.weight_dtype if cfg.weight_dtype.itemsize > 1 else torch.float32
    adapters = {}
    for key, layer in _adaptable(module, key_map, cfg.layer_filter):
        weight = layer.weight
        shape = weight_shape(weight)
        device = (weight.q if is_quantized(weight) else weight).device
        shapes = _shapes(shape, cfg)

        def normal(name: str, std: float = 1.0) -> torch.Tensor:
            t = torch.empty(shapes[name], dtype=dt, device=device)
            return t.normal_(0.0, std, generator=generator)

        if cfg.peft_type == PeftType.LOHA:
            entry = {"hada_w1_a": normal("hada_w1_a", 0.1),
                     "hada_w1_b": normal("hada_w1_b"),
                     "hada_w2_a": torch.zeros(shapes["hada_w2_a"], dtype=dt, device=device),
                     "hada_w2_b": normal("hada_w2_b")}
        else:
            bound = 1.0 / math.sqrt(math.prod(shape[1:]))
            down = torch.empty(shapes["lora_down"], dtype=dt, device=device)
            entry = {"lora_down": down.uniform_(-bound, bound, generator=generator),
                     "lora_up": torch.zeros(shapes["lora_up"], dtype=dt, device=device)}
            if cfg.decompose:
                with torch.no_grad():
                    w = dequantized_weight(weight, torch.bfloat16) if is_quantized(weight) \
                        else weight
                    entry["dora_scale"] = dora_norm(
                        w.float(), cfg.decompose_output_axis).to(dt)
        adapters[key] = {name: t.to(cfg.weight_dtype) for name, t in entry.items()}
    return adapters


def _make_adapter(entry: dict, cfg: PeftConfig) -> LoraAdapter | LohaAdapter:
    """The layer-side adapter of one entry (its tensors by reference)."""
    scale = cfg.alpha / cfg.rank
    if "hada_w1_a" in entry:
        return LohaAdapter(*(entry[name] for name in LOHA_LEAVES), scale)
    dora = entry.get("dora_scale") if cfg.decompose else None
    return LoraAdapter(entry["lora_down"], entry["lora_up"], scale,
                       dora_scale=dora, dora_eps=cfg.dora_eps if dora is not None else 0.0,
                       dropout=cfg.dropout)


def attach_peft(module: nn.Module, adapters: dict | None, cfg: PeftConfig | None,
                key_map: KeyMap | None = None) -> dict:
    """Hand each adapter's tensors to its layer (the layer applies them in
    its forward). Layers without an adapter, and every layer when
    `adapters` is None, are detached. -> {module_key: adapter} of the
    attached adapters."""
    attached = {}
    for key, layer in _adaptable(module, key_map, ()):
        entry = (adapters or {}).get(key)
        adapter = None if entry is None else _make_adapter(entry, cfg)
        attach_adapter(layer, adapter)
        if adapter is not None:
            attached[key] = adapter
    return attached


def draw_rank_keep(adapters: dict, p: float, generator: torch.Generator) -> dict:
    """Rank dropout's keep masks of one step, {module_key: bool [r, 1(, 1,
    1)]}: each rank row of each LoRA `down` kept with probability 1 - p
    (the reference's `adapters_to_lora_collection`), drawn from
    `generator` in the adapters' order. LoHa has no rank dropout."""
    keep = {}
    for key, entry in adapters.items():
        down = entry.get("lora_down")
        if down is None:
            continue
        u = torch.rand((down.shape[0],), generator=generator, device=generator.device)
        keep[key] = (u < 1.0 - p).reshape((-1,) + (1,) * (down.dim() - 1))
    return keep


@dataclass(frozen=True)
class RankDropout:
    """A LoRA run's rank dropout: its rate `p` (`PeftConfig.dropout`) and
    the adapters `attach_peft` attached, {group: {module_key: adapter}},
    which hold one step's keep masks."""
    p: float
    adapters: dict

    def draw(self, params: dict, generator: torch.Generator) -> dict:
        """One step's masks {group: {module_key: mask}} for the adapter
        groups of `params`, in their order (`draw_rank_keep`); other groups
        (embedding vectors) draw none."""
        return {group: draw_rank_keep(tree, self.p, generator)
                for group, tree in params.items() if group in self.adapters}

    @contextmanager
    def masked(self, keep: dict):
        """The masks `keep` {group: {module_key: mask}} on their LoRA
        adapters while the context lasts (the forward and the backward,
        whose recompute under gradient checkpointing sees the same
        masks)."""
        masked = [(self.adapters[group][key], mask)
                  for group, masks in keep.items() for key, mask in masks.items()]
        for adapter, mask in masked:
            adapter.keep = torch.as_tensor(mask, device=adapter.down.device)
        try:
            yield
        finally:
            for adapter, _ in masked:
                adapter.keep = None


def _merged_delta(entry: dict, cfg: PeftConfig, shape: tuple) -> torch.Tensor:
    """The adapter's delta in fp32 and torch layout `shape` (the
    reference's `_delta_2d` without dropout: alpha/r on the product)."""
    scale = cfg.alpha / cfg.rank
    if "hada_w1_a" in entry:
        delta = LohaAdapter(*(entry[name] for name in LOHA_LEAVES), 1.0).delta()
    else:
        down = entry["lora_down"].float()
        delta = entry["lora_up"].float() @ down.reshape(down.shape[0], -1)
    return (delta * scale).reshape(shape)


def _merged_weight(weight, entry: dict, cfg: PeftConfig) -> torch.Tensor:
    """W + dW (and DoRA's m (W + dW) / (||W + dW|| + eps)) in fp32, cast to
    the weight's dtype (a quantized weight: decoded to bf16 first, bf16
    out), as the reference's `_merged_kernel`."""
    w = dequantized_weight(weight, torch.bfloat16) if is_quantized(weight) else weight
    wp = w.float() + _merged_delta(entry, cfg, w.shape)
    if cfg.decompose and "dora_scale" in entry:
        m = entry["dora_scale"].float()
        norm = dora_norm(wp, m.shape[0] != 1) + cfg.dora_eps
        wp = m.reshape(norm.shape) * wp / norm
    return wp.to(w.dtype)


@torch.no_grad()
def apply_peft(module: nn.Module, adapters: dict, cfg: PeftConfig | None,
               key_map: KeyMap | None = None) -> dict[str, torch.Tensor]:
    """The module's state_dict with every adapter merged into its weight
    (`_merged_weight`); a quantized weight without an adapter appears
    decoded to bf16, as the reference's `apply_peft` gives it."""
    out = {k: v.detach() for k, v in module.state_dict().items()}
    for name, layer in module.named_modules():
        if not isinstance(layer, (nn.Linear, nn.Conv2d)):
            continue
        key = module_key(name, key_map)
        entry = adapters.get(key) if key is not None else None
        if entry is not None:
            out[name + ".weight"] = _merged_weight(layer.weight, entry, cfg)
        elif is_quantized(layer.weight):
            out[name + ".weight"] = dequantized_weight(layer.weight, torch.bfloat16)
    return out


def merge_peft_into_base(module: nn.Module, adapters: dict, cfg: PeftConfig,
                         key_map: KeyMap | None = None) -> nn.Module:
    """Bake the adapters into `module`'s weights, in place (for merged
    export and sampling); a quantized base becomes a bf16 one. Returns the
    module."""
    merged = apply_peft(module, adapters, cfg, key_map)
    if module_is_quantized(module):
        for name, layer in module.named_modules():
            if is_quantized(getattr(layer, "weight", None)):
                del layer.weight
                layer.weight = nn.Parameter(merged[name + ".weight"].contiguous(),
                                            requires_grad=False)
    module.load_state_dict(merged, strict=True)
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
    """Adapters -> kohya-style flat tensors, detached, in the adapters'
    dtype and on their device: lora_down.weight [r, in(,kh,kw)],
    lora_up.weight [out, r(,1,1)] and dora_scale, or LoHa's hada_w1_a,
    hada_w1_b, hada_w2_a and hada_w2_b as they are; alpha (fp32) for
    each (reference output contract: modules/modelSaver/mixin/
    LoRASaverMixin via omi/kohya key sets)."""
    out: dict[str, torch.Tensor] = {}
    for module_key, entry in adapters.items():
        kkey = _module_key_to_kohya(prefix, module_key)
        if cfg.peft_type == PeftType.LOHA:
            for name in LOHA_LEAVES:
                out[f"{kkey}.{name}"] = entry[name].detach()
        else:
            down = entry["lora_down"].detach()
            up = entry["lora_up"].detach()
            if down.ndim == 4:
                up = up.reshape(up.shape[0], up.shape[1], 1, 1)
            out[f"{kkey}.lora_down.weight"] = down
            out[f"{kkey}.lora_up.weight"] = up
            if "dora_scale" in entry:
                out[f"{kkey}.dora_scale"] = entry["dora_scale"].detach()
        out[f"{kkey}.alpha"] = torch.tensor(cfg.alpha, dtype=torch.float32)
    return out


def kohya_state_dict_to_peft(state_dict: dict, prefix: str,
                             module_keys: list[str]) -> tuple[dict, float | None]:
    """kohya tensors (one prefix) -> adapters (+ alpha if present): LoRA's,
    DoRA's `dora_scale` and LoHa's leaves; other leaves are skipped, as
    the reference's.

    The kohya flattening ('down_blocks_0_..._to_q') is ambiguous to invert
    textually, so `module_keys` (the adapter keys valid for the target
    model, e.g. from peft_module_keys) provides the reverse lookup."""
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
        elif leaf == "dora_scale" or leaf in LOHA_LEAVES:
            entry[leaf] = tensor
        elif leaf == "alpha":
            alpha = float(tensor.reshape(-1)[0])
    return adapters, alpha


@torch.no_grad()
def apply_lora_checkpoint(path: str, trainable: dict, lora_prefixes: dict[str, str],
                          cfg: PeftConfig) -> PeftConfig:
    """Continue training from a kohya-format LoRA file: the file's tensors
    replace the freshly initialised ones of `trainable`'s adapter groups
    (in place of the dict entries, in the configured weight dtype, on the
    fresh tensors' device), and the file's rank and alpha are adopted
    (reference: modules/modelLoader/mixin/LoRALoaderMixin.py:14-90; the
    JAX package's `apply_lora_checkpoint`). Modules the file lacks keep
    their fresh initialisation (up = 0: the base model). -> the config
    with the file's rank and alpha."""
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    state_dict = load_safetensors(path)
    alpha = rank = None
    loaded_any = False
    for group, prefix in lora_prefixes.items():
        adapters = trainable.get(group)
        if adapters is None:
            continue
        loaded, group_alpha = kohya_state_dict_to_peft(state_dict, prefix, list(adapters))
        for key, entry in loaded.items():
            device = next(iter(adapters[key].values())).device
            adapters[key] = {**adapters[key], **{
                name: torch.as_tensor(value).to(device=device, dtype=cfg.weight_dtype)
                for name, value in entry.items()}}
            factor = entry.get("lora_down", entry.get("hada_w1_b"))
            if factor is not None:
                rank = int(factor.shape[0])
            loaded_any = True
        if group_alpha is not None:
            alpha = group_alpha
    if not loaded_any:
        raise ValueError(f"LoRA file {path} contains no tensors matching prefixes "
                         f"{sorted(lora_prefixes.values())}")
    return replace(cfg, rank=rank if rank is not None else cfg.rank,
                   alpha=alpha if alpha is not None else cfg.alpha)
