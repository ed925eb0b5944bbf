"""PyTorch/CUDA port of onetrainer_tpu for NVIDIA Hopper (H100).

The JAX package `onetrainer_tpu` is the reference. This package keeps its
module paths and public names, imports torch and never jax, and imports
nothing of the JAX package: the framework-free modules it needs (config,
enums, tokenizer, the torch<->flax key maps) are its own copies.

Ported so far, for SD 1.5/2.x and SDXL: text-to-image sampling (models,
schedulers, sampler, setup, family registry), the LoRA and QLoRA training
step (PEFT layers, losses, noise and timestep draws, AdamW, schedules,
gradient checkpointing), checkpoint load and save, the cached data loader,
the trainer loop and the train and sample commands (`scripts/`), with the
folded flash attention, the NF4 dequant and the stochastic-rounding update
as hand-written sm_90a CUDA kernels (`csrc/`). Entry points run on the
card unless the caller passes a CPU device.
"""
