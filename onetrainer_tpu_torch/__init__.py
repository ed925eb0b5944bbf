"""PyTorch/CUDA port of onetrainer_tpu for NVIDIA Hopper (H100).

The JAX package `onetrainer_tpu` is the reference. This package keeps its
module paths and public names, imports torch and never jax, and reuses the
reference's framework-free modules (config, enums, tokenizer, the
torch<->flax key maps) by import.

Ported so far: SDXL text-to-image sampling (models, schedulers, sampler,
setup, family registry) with the folded flash-attention forward as a
hand-written sm_90a CUDA kernel (`csrc/flash_fwd.cu`).
"""
