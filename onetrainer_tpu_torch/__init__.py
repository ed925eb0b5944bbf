"""PyTorch/CUDA port of onetrainer_tpu for NVIDIA Hopper (H100).

The JAX package `onetrainer_tpu` is the reference. This package keeps its
module paths and public names, imports torch and never jax, and imports
nothing of the JAX package: the framework-free modules it needs (config,
enums, tokenizer, the torch<->flax key maps) are its own copies.

Ported so far, for SDXL: text-to-image sampling (models, schedulers,
sampler, setup, family registry) and the LoRA training step (PEFT layers,
losses, noise and timestep draws, AdamW, schedules, gradient
checkpointing), with the folded flash attention as hand-written sm_90a
CUDA kernels: the forward (`csrc/flash_fwd.cu`) and the backward
(`csrc/flash_bwd.cu`). Entry points run on the card unless the caller
passes a CPU device.
"""
