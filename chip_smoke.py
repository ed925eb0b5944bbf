#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`onetrainer_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a: H100/H200) and nvcc; fails without them, and
never falls back to the CPU. Phases, each of which must pass:
  1. build the kernels from onetrainer_tpu_torch/csrc with nvcc, one
     process per source, into one library: K1 (flash-attention forward),
     K2 (dq), K3 (dk, dv) and its delta pre-pass, K4 (NF4 dequant), K5
     (stochastic-rounding update); the build's wall time and ptxas's
     registers and spills per kernel;
  2. K1 against its plain PyTorch version in bf16: the two SDXL shapes,
     SD 1.5's d=40 level at batch 4 (B4 S4096 H8 d40) and SD 2.1's 768
     level at batch 2 (B2 S9216 H5 d64), head dims 40/80/128, ragged
     Sq/Skv with a kv keep mask, zero q rows, and SD3-medium's joint
     attention at 1024x1024 batch 2 (B2 S4250 H24 d64: 154 text + 4096
     image rows, ragged last tiles); max |do| and |dlse| against stated
     bounds, K1 bitwise equal across two runs, median times of both and of PyTorch's flash SDPA
     forward at the model shapes, K1's share of its bound and its ratio to
     SDPA;
  3. K2 and K3, on the delta of their shared pre-pass, against their plain
     versions in bf16: the same model shapes (SD3's too), head dims 40/80/128, ragged
     Sq/Skv with the kv keep mask, and 8192 tokens at d=128 (the TPU's
     streaming dk/dv domain); max |ddq|, |ddk|, |ddv| and relative L2
     against stated bounds, the pre-pass against its plain version, K2 and
     K3 each bitwise equal across two runs; median times of K2 alone, K3
     alone, the pre-pass, the whole backward (pre-pass + K2 + K3), the
     plain versions and PyTorch's flash SDPA backward, K2's device time
     from the profiler, each kernel's share of its bound;
  4. one full-width SDXL UNet forward (128x128 latent, CFG batch 2) with
     K1 and with plain attention: relative L2 difference of the outputs;
  5. full-width SDXL text-to-image through the family registry
     (1024x1024, DDIM, 4 steps, CFG 7, seeded random weights): K1 must be
     launched exactly 70 times per step; the image must be uint8
     1024x1024x3 and not constant;
  6. full-width SDXL LoRA training through the family registry (rank 16,
     alpha 16, batch 2 at 1024x1024 from a seeded image and prompt through
     the port's latent and text-embedding caches, tx_only gradient
     checkpointing, AdamW, clip 1.0): one warm-up step, then timed steps
     with exact launch counts per step (K1 140, K2 70, K3 70, K3's
     pre-pass 70); finite loss
     and grad norm, lora_up non-zero after the first step, one step's
     LoRA gradients with K1-K3 against plain attention (relative L2), and
     a torch.profiler split of one more step's device time by kernel class;
  7. K4 against its plain version, bitwise, at a feed-forward projection
     (1280x10240), the largest conv weight (1280x2560x3x3) and a size that
     needs padding; times of the first two against the byte bound;
  8. K5 bit for bit against its plain version on the same Philox bits
     (fp32 and bf16 u) at 2^20 + 3, 1,000,003 and the step's largest
     adapter (368,640) elements; then the properties of stochastic
     rounding at the first two sizes: every output one of the two bf16
     neighbours of p + u, exact where p + u is representable, mean error
     within 5 sigma of 0 and up-rounding rate within 5 sigma of 1/4 for
     p = 1, u = 2^-9, one seed one output and another seed another;
     median times; then one launch over the QLoRA step's 1588 adapter
     tensors (bf16 p and u, out = p), bit for bit against the plain
     rounding of every leaf, its device time against its byte bound and
     the wrapper's host time per call;
  9. QLoRA: the training step of phase 6 on a UNet loaded in bf16 and
     quantized to NF4, with bf16 adapters and stochastic rounding: one
     warm-up and TRAIN_STEPS timed steps with exact K1-K5 (and pre-pass)
     launch counts per step (K5 once), its adapters of the shapes phase 8
     rounds, the LoRA gradients with K4 against the plain dequant, and a
     torch.profiler split of one more step;
 10. the same step on an fp8 (e4m3) base with fp32 adapters at batch 4
     (the reference's bench.py headline stage): TRAIN_STEPS timed steps, finite;
 11. SD 1.5 at its published widths (seeded weights, fp32 base, bf16
     compute) through get_family -> create_sd_model -> init_sd_weights ->
     create_setup: text-to-image at 512x512 (DDIM, 4 steps, CFG 7), K1
     exactly 5 times per UNet pass (the d=40 self-attentions at 4096
     tokens), the image uint8 512x512x3 and not constant; then the
     reference's bench.py SD 1.5 stage as a LoRA step (rank 16, alpha 16,
     batch 4 at 512x512 through the port's caches, no gradient
     checkpointing, AdamW 1e-4, clip 1.0): one warm-up step, timed steps
     with exactly K1, K2, K3 and the pre-pass 5 each per step, the LoRA
     gradients with K1-K3 against plain attention, and a torch.profiler
     split of one more step;
 12. SD 2.1 (768-v) at its published widths, v-prediction, the same LoRA
     step at batch 2 at 768x768: K1, K2, K3 and the pre-pass exactly 15
     each per step (5 of each at 9216 tokens, 5 at 2304, 5 at 576), the
     LoRA gradients against plain attention, a profiler split;
 13. sd15_cli, SD 1.5 from files through the entry points a user runs:
     a seeded full-width SD 1.5 written as one ldm-keyed fp16 single file,
     eight 512x512 PNGs with captions and a config (LoRA r16 a16, batch 4,
     AdamW 1e-4, no gradient checkpointing); the port's train CLI (`main`
     of onetrainer_tpu_torch/scripts/train.py, in this process) for epoch
     1 with a backup, again with continue_last_backup for epoch 2, then
     its sample CLI at 512x512 (DDIM, 4 steps). Exactly 5 each of K1, K2,
     K3 and the pre-pass per training step and none while caching, 20 K1
     over the sample; global step 2, then 4; 8 latents and 8 text states
     in the cache; the kohya LoRA file's 282 x 3 keys read back bitwise to
     the trained adapters and give a finite loss; a non-constant image;
     load, cache and step times beside sd15_train's step, one step's
     device-busy share, the peak memory;
 14. sdxl_ft, the SDXL full fine-tune: the UNet in bf16 (1680 tensors,
     2,567,463,684 elements), text encoders frozen and cached, batch 2 at
     1024x1024, tx_only checkpointing, Adafactor with the reference's
     defaults, lr 1e-5, clip 1.0, stochastic rounding, no EMA: one warm-up
     step (after which the UNet must have changed), TRAIN_STEPS timed steps with
     exact launches per step (K1 140, K2 70, K3 70, pre-pass 70, K5 once:
     one launch per update dtype over every UNet tensor), then one step
     whose K5 call is captured: K5 bit for bit against the plain rounding
     on the largest leaf (29,491,200 elements), a 1-D, a 2-D and a 4-D
     conv leaf,
     and on every leaf each output a bf16 neighbour of p + u and exact
     where p + u is a bf16 value; K5's device time over the whole update
     against its byte bound, the wrapper's host time, the updates that came
     in other strides (copied), the peak memory and a torch.profiler split;
 15. sd15_ft_cli, SD 1.5 full fine-tune from files through the train and
     sample commands, on phase 13's checkpoint and PNGs with grayscale
     masks: the UNet in fp32 with bf16 compute, text encoder frozen and
     cached, AdamW 1e-5, clip 1.0, batch 4, masked training, zero-terminal
     SNR (v-prediction), an EMA on the card, gradient accumulation 2;
     epoch 1 with a backup (the trained model as a single file, the
     optimizer state, the EMA), the resume for epoch 2 from the backup's
     model, the fp16 single-file output. Exactly 5 each of K1, K2, K3 and
     the pre-pass per micro-step, K5 0, none while caching; global steps,
     optimizer updates and EMA updates 2/1/1 then 4/2/2; the output read
     back bit for bit the EMA cast to fp16; the sample command on the
     output at 512x512 (4 DDIM steps), a non-constant image.
 16. sd3_sample: SD3-medium at its published widths with seeded weights
     (the MMDiT, 24 blocks of 24 d=64 heads; CLIP-L and CLIP-G, both
     projected; T5-XXL, 24 layers of d_model 4096; the 16-channel VAE;
     parameters counted on the card), bf16 compute, through get_family ->
     create_setup -> sample at 1024x1024, 4 flow Euler steps, CFG 7: K1
     exactly 24 times per transformer pass (the joint attention over 154 +
     4096 = 4250 tokens), a non-constant uint8 1024x1024x3 image;
 17. sd3_transformer: one forward of that transformer with K1 and with
     plain attention, relative L2, the peak memory;
 18. sd3_train: the reference's bench.py SD3 stage (_bench_sd3) as a LoRA
     step: r16 a16 on all 341 transformer dense and conv layers, a
     per-tensor e4m3 frozen base, batch 2 at 1024x1024 through the port's
     caches (one seeded image and prompt through the VAE and all three
     text encoders, which are then freed), the loader's dots_nb_attn
     checkpointing, AdamW 1e-4, clip 1.0: one warm-up and two timed
     steps with exactly K1, K2, K3 and the pre-pass 24 each per step (the
     attention stays outside the recomputed halves of each block, so K1
     runs once), the LoRA gradients against plain attention, a profiler
     split;
 19. sd3_cli: a seeded SD3-medium at full width cut to SD3_CLI_BLOCKS of
     its 24 joint blocks (the script's time limit) and T5-XXL to
     CUT_T5_LAYERS of its 24 layers (the script's disk writes), written as
     an fp16 diffusers directory in a temporary directory (removed after
     the phase), sd15_files' PNGs at 512x512: the train command (LoRA r16,
     batch 4, weights in bf16) for epoch 1 with a backup and the resume
     for epoch 2 (one each of K1-K3 and the pre-pass per block and step
     at 1178 tokens, none while caching), the LoRA file read back
     bitwise, the sample command (4 flow Euler steps, 4 K1 per block), a
     non-constant image;
 20. flux_model: FLUX.1-dev at its published widths with seeded weights (19
     double and 38 single blocks of 24 d=128 heads, hidden 3072, RoPE axes
     (16, 56, 56), the guidance embedding; CLIP-L; T5-XXL; the 16-channel
     VAE; parameters counted), the transformer built in bf16 and quantized
     to NF4 (504 layers) through the setup's policy, the peak memory;
     flux_sample: 1024x1024, 4 flow Euler steps, guidance 3.5: K1 exactly
     57 and K4 exactly 504 times per transformer pass (the joint attention
     over 77 + 4096 = 4173 tokens in the d=128 slot), a non-constant image;
 21. flux_transformer: its first double and single block at batch 2 with K1
     and with plain attention, relative L2;
 22. flux_train: LoRA r16 a16 on all 504 NF4 transformer layers, fp32
     adapters, AdamW 1e-4, clip 1.0, batch 2 at 1024x1024 through the
     port's caches (the text encoders freed after), "full" checkpointing:
     one warm-up and TRAIN_STEPS timed steps with exactly K1 114, K2, K3 and the
     pre-pass 57 each and K4 998 per step, the LoRA gradients against plain
     attention and the plain dequant, a profiler split;
 23. flux_cli: a seeded FLUX.1-dev at full width with its transformer cut to
     2 double and 4 single blocks and T5-XXL to CUT_T5_LAYERS layers,
     written in bf16 as a diffusers directory
     (transformer and T5 sharded behind their indices) in a temporary
     directory removed after the phase; sd15_files' PNGs at 512x512: the
     train command (LoRA r16, batch 4, NF4 transformer, "full"
     checkpointing) for epoch 1 with a backup and the resume for epoch 2
     (per step K1 12, K2, K3 and the pre-pass 6, K4 114; none while
     caching), the LoRA file read back bitwise, the sample command (4 flow
     Euler steps, guidance 3.5, 24 K1), a non-constant image.
 24. hunyuan_model: HunyuanVideo at its published widths with seeded weights
     (20 double and 40 single blocks of 24 d=128 heads, hidden 3072, two
     refiner layers, RoPE axes (16, 56, 56) theta 256, the guidance
     embedding; Llama-3-8B, 32 layers of 4096; CLIP-L with its 768
     projection; the causal VAE; parameters counted), the transformer built
     in bf16 and quantized to NF4 (548 layers), the peak memory;
     hunyuan_sample: 512x512, 33 frames (9 latent frames), 4 flow Euler
     steps, guidance 6: K1 exactly 60 and K4 exactly 548 times per
     transformer pass (the joint attention over 9216 + 77 = 9293 tokens
     with the text padding dropped by the keep mask: 29 of 77 text rows
     kept), the decoded clip finite, its uint8 frames not constant, the
     denoiser step time, the VAE decode time, the peak memory;
 25. hunyuan_transformer: one forward of that transformer at batch 1 with
     K1 and with plain attention (on chunks of heads), relative L2;
 26. hunyuan_train: LoRA r16 a16 on all 548 NF4 transformer layers, fp32
     adapters, AdamW 1e-4, clip 1.0, batch 1 at 512x512 with 9 latent
     frames from the cache's rows (seeded latents, Llama states with the
     keep mask, CLIP pooled; the encoders freed), "full" checkpointing: one
     warm-up and TRAIN_STEPS timed steps with exactly K1 120, K2, K3 and the
     pre-pass 60 each and K4 1068 per step, the LoRA gradients against plain
     attention and the plain dequant, a profiler split;
 27. hunyuan_cli: a seeded HunyuanVideo at full width with its transformer
     cut to 2 double and 4 single blocks and Llama to 4 layers, written in
     bf16 by the port's saver as a diffusers directory (Llama in two shards)
     in a temporary directory removed after the phase; sd15_files' PNGs at
     512x512 as 1-frame clips: the train command (LoRA r16, batch 4, NF4
     transformer, "full" checkpointing) for epoch 1 with a backup and the
     resume for epoch 2 (per step K1 12, K2, K3 and the pre-pass 6, K4 132;
     none while caching), the LoRA file read back bitwise, the sample
     command (4 flow Euler steps, guidance 6, 24 K1), a non-constant image.
 28. sdxl_inpaint: the SDXL inpainting UNet (9 input channels) at its
     published widths with seeded weights: inpainting at 1024x1024 (4 DDIM
     steps, CFG 7) from a seeded base image and mask written as PNGs at
     896x1152 and resized by the port's bilinear resize, K1 70 per step;
     then the LoRA step of phase 6 on a batch whose cache rows carry the
     conditioning latent and the latent mask: one warm-up and two timed
     steps with the launches of phase 6 per step, the UNet's input 9 wide;
 29. flux_fill_model: FLUX.1-Fill-dev at its published widths (FLUX.1-dev's
     with a 384-wide x_embedder), built and quantized as flux_model after
     the dev model is freed; flux_fill_sample: 1024x1024, 4 flow Euler
     steps, guidance 30, from a base image and mask at 896x1152: K1 57 and
     K4 504 per pass; flux_fill_train: flux_train's step on cache rows that
     carry the conditioning latent [2, 128, 128, 16] and the 64-channel
     mask [2, 128, 128, 64] (384 packed input channels): the same launches
     per step, the LoRA gradients against plain attention and the plain
     dequant, a profiler split;
 30. sd15_inpaint_cli: a seeded SD 1.5-inpainting written as an fp16
     single file, sd15_files' PNGs (600x560, not a bucket's size: the
     loader resizes them in numpy) with their masks and one -condlabel.png,
     unmasked probability 0.1: the train command (LoRA r16, batch 4 at 512)
     for epoch 1 with a backup and the resume for epoch 2 (K1, K2, K3 and
     the pre-pass 5 each per step, none while caching; the cache's rows
     carry the conditioning latent and the mask), the LoRA file read back
     bitwise, then the sample command with --sample-inpainting (4 DDIM
     steps, 20 K1), a non-constant image.
 31. sd3_ft (after sd3_transformer, on sd3_model's weights cast to bf16,
     the loader's cast of every part to the transformer's weight dtype):
     FINE_TUNE of the MMDiT and CLIP-L (2,208,601,408 bf16 elements, two
     groups), CLIP-G and T5-XXL frozen and run live in the step on the
     batch's tokens, Adafactor with the reference's defaults and stochastic
     rounding, lr 1e-5, clip 1.0, batch 2 at 1024x1024, dots_nb_attn: one
     warm-up step (the groups' largest tensors must move), two timed
     steps with exactly K1, K2, K3 and the pre-pass 24 each and K5 once per
     step (the text encoders' attention, at 77 tokens, stays on SDPA and
     the T5's plain path: no K1-K3), one step with K5's call captured (bit
     for bit against the plain rounding on the largest leaf, a 1-D, a 2-D
     and a 4-D conv leaf; every output a bf16 neighbour of p + u; device
     time over the update against its byte bound, the wrapper's host
     time), the gradients of every trained tensor with K1-K3 against
     plain attention, a profiler split; sd3_train then quantizes the
     transformer to fp8 as before;
 32. flux_ft: FLUX.1-dev built again in bf16 after the NF4 models are
     freed (19 + 38 blocks, 11,901,408,320 transformer parameters), the
     transformer fine-tuned with Adafactor and stochastic rounding, lr
     1e-5, clip 1.0, batch 1 at 1024x1024, "full" checkpointing, text
     cached, T5 and the VAE freed: the memory reckoning printed beside the
     peak; TRAIN_STEPS timed steps with exactly K1 114, K2, K3 and the pre-pass
     57 and K5 3 per step (the update made and rounded in chunks of at
     most 2^32 elements); K5 against the plain rounding on the largest, a
     1-D and a 2-D leaf (FLUX has no conv), every output a bf16 neighbour,
     each chunk's device time; the gradients of the first double block,
     the last single block, x_embedder and proj_out against plain
     attention; a profiler split;
 33. dit_single_file (after hunyuan_cli, on its directory): hunyuan_cli's
     transformer as a HunyuanVideo single file (the reference's layout);
     SD3-medium (SF_SD3_BLOCKS joint blocks, CLIP-G SF_CLIP_G_LAYERS layers)
     and FLUX.1-dev (SF_FLUX_BLOCKS) at full width, T5-XXL cut to
     CUT_T5_LAYERS layers, written by the families' savers as bundled bf16
     SAI and BFL single files; each read back on the card bit for bit;
     then the train command's FINE_TUNE of the transformer from the SD3 and
     the FLUX file (Adafactor, stochastic rounding, batch 4 at 512x512 over
     sd15_files' PNGs, text cached): epoch 1 with a backup (the model as
     an fp32 single file), the resume from it for epoch 2, the bf16
     single-file output read back bit for bit as the trained transformer,
     per step exactly K1-K3, the pre-pass and K5 once (SD3: K1 once per
     block; FLUX: twice) and none while caching; the sample command on
     each output at 512x512, a non-constant uint8 image; each family's
     files deleted once checked.
 34. sdxl_embedding (after the SDXL fine-tune): textual inversion of SDXL
     at its published widths, the UNet in bf16 under tx_only and both text
     encoders frozen, the text run in the step on the batch's tokens,
     `<emb>` of 4 tokens in CLIP-L and CLIP-G, AdamW, batch 2 at
     1024x1024: one warm-up and TRAIN_STEPS timed steps with exactly K1 140, K2,
     K3 and the pre-pass 70 per step (CLIP-G's pooled embedding reaches
     every self-attention through the time embedding), the UNet and text encoders bit for
     bit unchanged, the vectors' gradients against plain attention, a
     profiler split;
 35. sd15_vae_ft (after sd21_train): the SD 1.5 VAE fine-tuned in bf16
     through FINE_TUNE_VAE with stochastic rounding, batch 4 at 512x512:
     K5 once per step, no attention kernel, one step's K5 call held bit
     for bit to the plain rounding;
 36. the EMBEDDING runs of the CLI phases: in sd15_cli, an input and an
     output embedding through the train command with its resume (per step
     K1 5, K2, K3 and the pre-pass 4), the embedding file read back bit
     for bit, the sample command with --embedding-name on it, and LoRA
     beside an additional embedding (bundled in the LoRA file) with its
     resume; in sd3_cli, flux_cli and hunyuan_cli one EMBEDDING epoch each
     on their cut models with their LoRA runs' launches per step (FLUX's
     and HunyuanVideo's output embeddings over the NF4 base, K4 included).
 37. PixArt-Σ and Sana 1600M at their published widths (after hunyuan_ft):
     each built with seeded weights, the transformer in NF4 (287 and 227
     layers), the text encoder (T5-XXL, Gemma-2-2B) at 300 tokens;
     pixart_sample and sana_sample at 1024x1024 (DDIM and flow Euler, 4
     steps, CFG 4.5: K4 once per NF4 layer per pass, no K1-K3: PixArt's
     d=72 and Sana's cross-attention d=112 run SDPA, Sana's self-attention
     is linear); pixart_train and sana_train: LoRA r16 over the NF4
     transformer with bf16 adapters and stochastic rounding, batch 2 at
     1024x1024, text cached, "full" checkpointing, PixArt's VB loss at
     strength 1: exact K4 and K5 launches per step, K4 on every layer's
     codes and K5 over the adapter set bit for bit against their plain
     versions, the gradients against the plain dequant, a profiler split;
     pixart_sana_cli (before sd15_ft_cli): both families cut to 2 blocks
     (T5-XXL and Gemma-2-2B to 2 layers) written as bf16 diffusers
     directories by the port's savers, through the train command (LoRA on
     the NF4 transformer, epoch 1, backup, resume, the file read back bit
     for bit) and the sample command on sd15_files' PNGs at 512x512.
 38. sdxl_optimizers (after train, on its UNet): the train phase's LoRA
     step under ADAMW_8BIT, PRODIGY, DADAPT_ADAM (both at lr 1.0),
     SCHEDULE_FREE_ADAMW, CAME and LION: one warm-up and TRAIN_STEPS
     timed steps each with train's exact launches, the optimizer state's
     GiB, its int8 tensors, Prodigy's and D-Adapt's d; the warm-up's
     optimizer call watched (its gradients, norm and state copied): the
     updates of 16 named adapters against the same optimizer run on the
     host from them, over the whole group where it reduces over it (rel L2
     <= OPT_UPDATE_REL; schedule-free per element within 4 ulps of the
     tensor's largest |y|), the int8 codes of theirs equal on
     INT8_CODES_EQUAL of the elements and never more than one apart; under
     SCHEDULE_FREE_ADAMW the LoRA output written as the trainer writes it
     equals x bit for bit, differs from y, and y is put back;
 39. sd15_ft_8bit (after sd15_train, on its UNet): FINE_TUNE of the SD 1.5
     UNet's 0.86B fp32 parameters at batch 4 at 512x512 under ADAMW and
     ADAMW_8BIT, one warm-up and TRAIN_STEPS timed steps each (K1-K3 as
     sd15_train), both peaks, the int8-eligible tensors' moments at most
     INT8_STATE_RATIO of AdamW's bytes, 16 named tensors' updates (and
     codes) against the host's as in 38.
 40. Würstchen v2 and Stable Cascade (after sana_train; seeded, nothing
     downloaded; the priors' eps heads at a tenth, so b stays near 0):
     cascade_model, Stable Cascade's stage C at CascadePriorConfig's
     defaults (3.6e9 parameters, 32 d=64 heads, blocks (8, 24)) with its
     prior quantized to NF4 (711 layers), CLIP-G and EfficientNetV2-S;
     cascade_sample: 4 prior steps at 1024x1024 with CFG 4 and the pooled
     text, the stand-in decode, K1 64 and K4 711 per pass; cascade_train:
     LoRA r16 a16 on 647 layers with bf16 adapters, stochastic rounding,
     AdamW, batch 4 on cached 24x24x16 latents and CLIP-G's 77 states and
     pooled projection: per step K1, K2, K3 and the pre-pass 64 each, K4
     711, K5 1; the warm-up's update of 16 named adapters against the same
     AdamW on the host, K4 on every layer's codes, the gradients against
     plain attention and the plain dequant, K5 bit for bit, a profiler
     split; cascade_ft: the prior built again in bf16 and fine-tuned under
     Adafactor at batch 4 (K5 over its 3.6e9 elements in one launch per
     step); wuerstchen_sample: the v2 prior (c 1536, 32 triples of 24
     heads, c_cond 1280 from warp-ai/wuerstchen-prior's config), DiffNeXt
     and the Paella VQGAN at their defaults, 4 prior and 10 decoder steps
     at 1024x1024 (K1 32 per prior pass, 44 per DiffNeXt pass);
     wuerstchen_cli (after pixart_sana_cli): the v2 prior cut to 4 triples
     (CLIP-G, and the decoder's CLIP-H, to 2 layers; DiffNeXt to one block
     per level) written by the port's savers, through the train command
     (LoRA on the prior over sd15_files' PNGs at 1024x1024, the effnet's
     latent cache, backup, resume, the file read back) and the sample
     command with `--decoder-model-name`; then Stable Cascade's stage_c
     file cut to blocks (1, 2) written and read back bit for bit.
The k1/k23 phases also run FLUX's B2 and B1 S4173 H24 d128 and
HunyuanVideo's B1 S9293 H24 d128 with its keep mask (the plain versions on
chunks of heads; SDPA with the boolean mask on the first backend that takes
it, named), and k4 FLUX's 3072x18432 norm1.linear (HunyuanVideo's too),
15360x3072 proj_out and FLUX.1-fill's 384x3072 x_embedder, PixArt-Σ's
1152x6912 AdaLN and 4096x1152 caption projections and Sana's GLUMBConv
kernels (1x1 2240 -> 11200, 5600 -> 2240, the depthwise 3x3 x 11200) and
Stable Cascade's 2048 x 8192 MLP projection; k1 and k23 Stable Cascade's
B4 Sq576 Skv658 H32 d64 and Würstchen v2's B4 Sq576 Skv653 H24 d64 (no
mask, more keys than queries), k1 also their sampling pairs at B2 and
DiffNeXt's three levels (Sq 4096, 1024 and 256 over 77 more keys). The CLI phases
read sd15_files' PNGs at 600x560, which the loader resizes to their bucket.
Each model is freed before the next phase; every phase prints its peak
device memory. The last stdout line is one JSON object, {"ok": true, "device": {...}};
the line before it carries the kernel table as JSON.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import tempfile
import sys
import time
import traceback
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))

# bounds, bf16 operands on both sides (the plain versions compute in fp32
# from the same bf16 inputs):
# - o: both round o to bf16 (relative 2^-9) and K1 rounds P to bf16 before
#   P.V; 2e-2 absolute is the reference package's own flash-test bound
# - lse: fp32 on both sides, only summation order and exp differ
O_BOUND = 2e-2
LSE_BOUND = 1e-3
# dq, dk, dv, each against its own scale: at the SDXL shapes max|dq|,
# |dk|, |dv| are only 0.2-0.3 (a typical element ~0.03), so an absolute
# bound would not catch a wrong kernel. Both sides round dS and P to bf16
# before their products and the results to bf16 (relative 2^-9); the
# kernels sum S, dP and the products in another order (wgmma fp32
# accumulators vs one fp32 matmul), so an element can round across one bf16
# step: up to 0.40% of max|ref| measured. Most elements round alike on
# both sides, so the relative L2 difference is small: 1.3e-4 to 3.0e-4
# measured over these cases on an H100. Bounds: max error 2% of max|ref|,
# relative L2 2e-3 over the tensor
DGRAD_MAX_REL = 2e-2
DGRAD_REL_L2 = 2e-3
# K3's delta pre-pass: fp32 sums of the same bf16 products on both sides,
# only the order of at most 128 terms differs
DELTA_MAX_REL = 1e-4
# UNet output, K1 vs plain attention: 70 attention outputs that differ by
# bf16 roundings, carried through a bf16 network of random weights
UNET_REL_L2_BOUND = 5e-2
# LoRA gradients of one training step, K1-K3 vs plain attention: the same
# bf16 attention roundings as DGRAD_REL_L2, through the forward and the
# backward of the network (2.1e-3 measured at full width)
GRAD_REL_L2_BOUND = 1e-2
# LoRA gradients of one QLoRA step, K4 vs the plain dequant: K4 is
# bitwise equal to it (phase k4), so only the step's own run-to-run noise
# remains (cuDNN and cuBLAS pick their algorithms per call)
QLORA_GRAD_REL_L2_BOUND = 1e-3
# timed steps after one warm-up step: one, so that every phase fits the
# script's time limit
TRAIN_STEPS = 1
# the self-attentions K1 takes per UNet pass, {sequence length: count}:
# SDXL at a 128x128 latent; SD 1.5 at a 64x64 latent, the d=40 level (d=80
# at 1024 and d=160 at 256 tokens stay on SDPA); SD 2.1 at a 96x96 latent,
# d=64 throughout (the 144-token mid block stays on SDPA)
SDXL_SELF_ATTN = {4096: 10, 1024: 60}
SD15_SELF_ATTN = {4096: 5}
SD21_SELF_ATTN = {9216: 5, 2304: 5, 576: 5}
# SD3-medium: one joint attention per block, 24 blocks; 4250 tokens at
# 1024x1024 (154 + 4096), 1178 at 512x512 (154 + 1024)
SD3_BLOCKS = 24
# K4 cases: name, logical shape (the reference's kernel layout)
K4_CASES = [
    ("ff_1280x10240", (1280, 10240)),           # GEGLU projection of a 1280 block
    ("conv_3x3x2560x1280", (3, 3, 2560, 1280)),  # largest conv weight (29.5M)
    ("padded_1000x777", (1000, 777)),            # 777,000: both halves padded
    ("flux_norm1_3072x18432", (3072, 18432)),    # FLUX's largest kernel (56.6M)
    ("flux_proj_out_15360x3072", (15360, 3072)),  # a single block's proj_out
    ("flux_fill_x_embedder_384x3072", (384, 3072)),  # FLUX.1-fill's 384-wide input
    ("pixart_adaln_1152x6912", (1152, 6912)),    # PixArt-Σ's AdaLN-single projection
    ("pixart_caption_4096x1152", (4096, 1152)),  # its caption projection from T5
    ("sana_conv_inverted_1x1x2240x11200", (1, 1, 2240, 11200)),  # Sana's GLUMBConv 1x1
    ("sana_conv_point_1x1x5600x2240", (1, 1, 5600, 2240)),
    ("sana_conv_depth_3x3x1x11200", (3, 3, 1, 11200)),  # its depthwise 3x3
    ("cascade_channelwise_2048x8192", (2048, 8192)),  # Stable Cascade's MLP up
]
# the UNet's shapes, FLUX's, PixArt-Σ's and Sana's
K4_TIMED = ("ff_1280x10240", "conv_3x3x2560x1280", "flux_norm1_3072x18432",
            "flux_proj_out_15360x3072", "flux_fill_x_embedder_384x3072",
            "pixart_adaln_1152x6912", "sana_conv_inverted_1x1x2240x11200",
            "cascade_channelwise_2048x8192")
FLUX_K4, FLUX_FILL_K4 = "flux_norm1_3072x18432", "flux_fill_x_embedder_384x3072"
PIXART_K4, SANA_K4 = "pixart_adaln_1152x6912", "sana_conv_inverted_1x1x2240x11200"
CASCADE_K4 = "cascade_channelwise_2048x8192"
K5_SIZES = ((1 << 20) + 3, 1_000_003)
# the step's largest bf16 adapter tensor: lora_down of a 2560->1280 3x3 conv
K5_LARGEST_ADAPTER_SHAPE = (16, 2560, 3, 3)
K5_LARGEST_ADAPTER = 16 * 2560 * 3 * 3

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# name, batch, sq, skv, heads, head dim, keep mask, first zero q row
K1_CASES = [
    ("sdxl_b2_s4096_h10_d64", 2, 4096, 4096, 10, 64, False, None),
    ("sdxl_b2_s1024_h20_d64", 2, 1024, 1024, 20, 64, False, None),
    ("sd15_b4_s4096_h8_d40", 4, 4096, 4096, 8, 40, False, None),
    ("sd21_b2_s9216_h5_d64", 2, 9216, 9216, 5, 64, False, None),
    ("sd3_b2_s4250_h24_d64", 2, 4250, 4250, 24, 64, False, None),
    ("flux_b2_s4173_h24_d128", 2, 4173, 4173, 24, 128, False, None),
    ("flux_b1_s4173_h24_d128", 1, 4173, 4173, 24, 128, False, None),
    ("hunyuan_b1_s9293_h24_d128_keep", 1, 9293, 9293, 24, 128, "hunyuan", None),
    ("d40_b2_s1024_h8", 2, 1024, 1024, 8, 40, False, None),
    ("d80_b2_s1024_h8", 2, 1024, 1024, 8, 80, False, None),
    ("d128_b1_s2048_h8", 1, 2048, 2048, 8, 128, False, None),
    ("ragged_keep_b2_sq1000_skv777_h4_d64", 2, 1000, 777, 4, 64, True, None),
    ("zero_q_rows_b2_s300_h4_d64", 2, 300, 300, 4, 64, False, 250),
    ("cascade_b4_sq576_skv658_h32_d64", 4, 576, 658, 32, 64, False, None),
    ("cascade_b2_sq576_skv658_h32_d64", 2, 576, 658, 32, 64, False, None),
    ("wuerstchen_b4_sq576_skv653_h24_d64", 4, 576, 653, 24, 64, False, None),
    ("wuerstchen_b2_sq576_skv653_h24_d64", 2, 576, 653, 24, 64, False, None),
    ("diffnext_b1_sq4096_skv4173_h10_d64", 1, 4096, 4173, 10, 64, False, None),
    ("diffnext_b1_sq1024_skv1101_h20_d64", 1, 1024, 1101, 20, 64, False, None),
    ("diffnext_b1_sq256_skv333_h20_d64", 1, 256, 333, 20, 64, False, None),
]
# name, batch, sq, skv, heads, head dim, keep mask
K23_CASES = [
    ("sdxl_b2_s4096_h10_d64", 2, 4096, 4096, 10, 64, False),
    ("sdxl_b2_s1024_h20_d64", 2, 1024, 1024, 20, 64, False),
    ("sd15_b4_s4096_h8_d40", 4, 4096, 4096, 8, 40, False),
    ("sd21_b2_s9216_h5_d64", 2, 9216, 9216, 5, 64, False),
    ("sd3_b2_s4250_h24_d64", 2, 4250, 4250, 24, 64, False),
    ("flux_b2_s4173_h24_d128", 2, 4173, 4173, 24, 128, False),
    ("flux_b1_s4173_h24_d128", 1, 4173, 4173, 24, 128, False),
    ("hunyuan_b1_s9293_h24_d128_keep", 1, 9293, 9293, 24, 128, "hunyuan"),
    ("d40_b2_s1024_h8", 2, 1024, 1024, 8, 40, False),
    ("d80_b2_s1024_h8", 2, 1024, 1024, 8, 80, False),
    ("d128_b1_s2048_h8", 1, 2048, 2048, 8, 128, False),
    ("ragged_keep_b2_sq1000_skv777_h4_d64", 2, 1000, 777, 4, 64, True),
    ("stream_b1_s8192_h8_d128", 1, 8192, 8192, 8, 128, False),
    ("cascade_b4_sq576_skv658_h32_d64", 4, 576, 658, 32, 64, False),
    ("wuerstchen_b4_sq576_skv653_h24_d64", 4, 576, 653, 24, 64, False),
]
SDXL_SHAPES = ("sdxl_b2_s4096_h10_d64", "sdxl_b2_s1024_h20_d64")
SD15_SHAPE, SD21_SHAPE = "sd15_b4_s4096_h8_d40", "sd21_b2_s9216_h5_d64"
# SD3-medium's joint attention at 1024x1024, batch 2: 154 text + 4096 image
# rows, a length no tile divides
SD3_SHAPE = "sd3_b2_s4250_h24_d64"
# FLUX.1-dev's joint attention at 1024x1024: T5's 77 rows + 4096 image rows,
# 24 heads of d=128 (the 128 slot); batch 2 in training, 1 in sampling
FLUX_SHAPE, FLUX_SAMPLE_SHAPE = "flux_b2_s4173_h24_d128", "flux_b1_s4173_h24_d128"
# HunyuanVideo's joint attention at 512x512 with 9 latent frames (33 video
# frames): 9 x 32 x 32 = 9216 image rows, then Llama's 77 text rows of which
# HV_REAL_TEXT are kept and the rest dropped by the keep mask (K1-K3's
# -1e30 kv bias); 9293 = 72 x 128 + 77, so the padded keys all sit in the
# ragged last tile. Above the TPU's 6144-token switch to the streaming K3b.
HV_SHAPE = "hunyuan_b1_s9293_h24_d128_keep"
HV_IMAGE_TOKENS, HV_TEXT_TOKENS, HV_REAL_TEXT = 9216, 77, 29
# cases timed against SDPA: the model shapes, and for K2/K3 the streaming
# domain of the TPU's K3b
# Würstchen v2's and Stable Cascade's priors at 1024x1024: the 24x24 effnet
# latent's 576 rows attend over themselves and the conditioning tokens,
# Cascade's 4 pooled + 77 text + 1 image (658 keys, 32 heads), v2's 77 text
# (653 keys, 24 heads): batch 4 in training, the CFG pair in sampling; no
# mask, more keys than queries, both ragged in the last tile. DiffNeXt's
# three attention levels at 1024x1024 (4096, 1024 and 256 query rows over
# 77 more keys), batch 1
CASCADE_SHAPE, CASCADE_SAMPLE_SHAPE = ("cascade_b4_sq576_skv658_h32_d64",
                                       "cascade_b2_sq576_skv658_h32_d64")
V2_SHAPE, V2_SAMPLE_SHAPE = ("wuerstchen_b4_sq576_skv653_h24_d64",
                             "wuerstchen_b2_sq576_skv653_h24_d64")
DIFFNEXT_SHAPES = ("diffnext_b1_sq4096_skv4173_h10_d64", "diffnext_b1_sq1024_skv1101_h20_d64",
                   "diffnext_b1_sq256_skv333_h20_d64")
MODEL_SHAPES = SDXL_SHAPES + (SD15_SHAPE, SD21_SHAPE, SD3_SHAPE, FLUX_SHAPE,
                              FLUX_SAMPLE_SHAPE, HV_SHAPE, CASCADE_SHAPE, CASCADE_SAMPLE_SHAPE,
                              V2_SHAPE, V2_SAMPLE_SHAPE) + DIFFNEXT_SHAPES
SDPA_BWD_CASES = MODEL_SHAPES + ("stream_b1_s8192_h8_d128",)


def _median_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _once_ms(torch, fn) -> float:
    """One call of `fn` timed by CUDA events, for a plain version whose call
    takes seconds (Philox in int64 ops, tensor by tensor)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _device_ms(torch, fn, kernel: str, reps: int = 20, min_seen: float = 1.0) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    `kernel`, from torch.profiler over `reps` calls of `fn`, each after a
    write of 64 MB that evicts the 50 MB L2 cache (the step finds a
    layer's codes cold). Left out: the wrapper's host time, which an event
    pair around one short call would count. The profiler has returned no
    events for a session of 2.5 us kernels on an H100 now and then, and
    dropped some launches of 0.1-8 ms K5 calls from sessions after the
    earlier phases', so a session that sees fewer launches than `min_seen`
    x `reps` (all, by default), or more, is run again, up to three times
    in all; the time is the mean over the launches seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and kernel in evt.key:
                total += getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
                count += evt.count
        if min_seen * reps <= count <= reps and count:
            if count < reps:
                print(f"[profile] saw {count} of {reps} launches of {kernel}: the mean "
                      f"over those")
            return total / count / 1e3
        print(f"[profile] session {attempt + 1} saw {count} launches of {kernel}, "
              f"expected {reps}")
    raise AssertionError(f"profiler saw {count} launches of {kernel}, expected {reps}")


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: FLOPs at the bf16 tensor-core
    peak or bytes at the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _attn_bounds(b, sq, skv, h, d) -> dict:
    """bound_ms of K1, K2, K3 at one shape: FLOPs 4/6/8 * B*H*Sq*Skv*d
    (the TPU kernels' cost estimates); bytes: each bf16 [B, S, H*d] input
    read once and output written once, lse and delta fp32 [B, H, Sq]. K1
    reads q, k, v and writes o, lse; K2 reads q, dO, k, v, lse, delta and
    writes dq; K3 reads q, dO, k, v, lse, delta and writes dk, dv. The
    pre-pass reads o and dO and writes delta (2 FLOPs per lane). The whole
    backward reads q, k, v, o, dO, lse and writes dq, dk, dv."""
    q_bytes, kv_bytes, lse_bytes = 2 * b * sq * h * d, 2 * b * skv * h * d, 4 * b * h * sq
    work = b * h * sq * skv * d
    return {
        "K1": _bound_ms(4 * work, 2 * q_bytes + 2 * kv_bytes + lse_bytes),
        "K2": _bound_ms(6 * work, 3 * q_bytes + 2 * kv_bytes + 2 * lse_bytes),
        "K3": _bound_ms(8 * work, 2 * q_bytes + 4 * kv_bytes + 2 * lse_bytes),
        "delta": _bound_ms(2 * b * sq * h * d, 2 * q_bytes + lse_bytes),
        "bwd": _bound_ms(14 * work + 2 * b * sq * h * d,
                         4 * q_bytes + 4 * kv_bytes + lse_bytes),
    }


def _heads4(t, h):
    """[B, S, H*d] -> a [B, H, S, d] view (what SDPA takes)."""
    b, s, inner = t.shape
    return t.view(b, s, h, inner // h).transpose(1, 2)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_build():
    from onetrainer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] K1-K5 library {os.path.relpath(path, REPO)} ready in "
          f"{time.perf_counter() - t0:.2f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                print(f"[build] {line.strip()}")


def hunyuan_keep(torch, b: int, s_img: int):
    """HunyuanVideo's kv keep mask [B, s_img + 77]: every image row, the
    first HV_REAL_TEXT text rows, not the text padding after them."""
    keep = torch.ones((b, s_img + HV_TEXT_TOKENS), dtype=torch.bool, device="cuda")
    keep[:, s_img + HV_REAL_TEXT:] = False
    return keep


# the plain versions run on chunks of heads where one [B, H, Sq, Skv] fp32
# score tensor would exceed this (HunyuanVideo's is 8.3 GB at 9293 tokens)
PLAIN_SCORES_BYTES = 4 << 30


def _head_chunks(b, sq, skv, h) -> list:
    """[(h0, h1)]: all heads at once, or chunks whose fp32 scores fit
    PLAIN_SCORES_BYTES."""
    per = max(1, min(h, PLAIN_SCORES_BYTES // (4 * b * sq * skv)))
    return [(h0, min(h0 + per, h)) for h0 in range(0, h, per)]


def _plain_by_heads(torch, fn, h, packed: tuple, stats: tuple, out_kinds: str, **kw):
    """`fn(*packed, *stats, num_heads, **kw)` (a plain version) over chunks
    of heads: the packed [B, S, H*d] operands sliced by columns, the
    [B, H, Sq] statistics by rows; outputs ("p" packed, "s" statistics)
    joined back."""
    b, sq, inner = packed[0].shape
    d = inner // h
    skv = packed[1].shape[1] if len(packed) > 1 else sq
    chunks = _head_chunks(b, sq, skv, h)
    if len(chunks) == 1:
        return fn(*packed, *stats, h, **kw)
    outs = []
    for h0, h1 in chunks:
        out = fn(*(t[..., h0 * d:h1 * d].contiguous() for t in packed),
                 *(t[:, h0:h1].contiguous() for t in stats), h1 - h0, **kw)
        outs.append(out if isinstance(out, tuple) else (out,))
    joined = tuple(torch.cat(parts, dim=-1 if kind == "p" else 1)
                   for kind, parts in zip(out_kinds, zip(*outs)))
    return joined if len(joined) > 1 else joined[0]


def _sdpa_masked(torch, q4, k4, v4, scale, keep):
    """scaled_dot_product_attention with the boolean kv mask, on the first
    backend of efficient, cuDNN and math that takes it (the flash backend
    takes no mask): (a call, the backend's name)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mask = keep[:, None, None, :]
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                      scale=scale)
        try:
            call()
            return call, backend.name
        except RuntimeError:
            continue
    raise AssertionError("no SDPA backend takes the keep mask")


def _rand_case(torch, gen, b, sq, skv, h, d, with_keep):
    def rand(s):
        return torch.randn((b, s, h * d), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)
    q, k, v = rand(sq), rand(skv), rand(skv)
    keep = None
    if with_keep == "hunyuan":
        keep = hunyuan_keep(torch, b, skv - HV_TEXT_TOKENS)
    elif with_keep:
        keep = torch.ones((b, skv), dtype=torch.bool, device="cuda")
        keep[:, 700:] = False      # text-padding style tail
        keep[0, :64] = False       # a fully masked leading kv tile
        keep[1, 300:340] = False   # a hole
    return q, k, v, keep


def phase_k1_cases(torch) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    from onetrainer_tpu_torch.ops import flash_folded as ff
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for name, b, sq, skv, h, d, with_keep, zero_from in K1_CASES:
        q, k, v, keep = _rand_case(torch, gen, b, sq, skv, h, d, with_keep)
        if zero_from is not None:
            q[:, zero_from:] = 0
        scale = 1.0 / d ** 0.5
        o, lse = ff.flash_attention_folded_fwd(q, k, v, h, sm_scale=scale, kv_keep=keep)
        o2, lse2 = ff.flash_attention_folded_fwd(q, k, v, h, sm_scale=scale, kv_keep=keep)
        def plain():
            return _plain_by_heads(torch, ff.flash_attention_folded_reference, h, (q, k, v),
                                   (), "ps", sm_scale=scale, kv_keep=keep)
        o_ref, lse_ref = plain()
        torch.cuda.synchronize()
        k1_same = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
        del o2, lse2
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        ms = _median_ms(torch, lambda: ff.flash_attention_folded_fwd(
            q, k, v, h, sm_scale=scale, kv_keep=keep))
        plain_ms = _median_ms(torch, plain, reps=5 if keep is not None else 20)
        library_ms, backend = None, "FLASH_ATTENTION"
        if name in MODEL_SHAPES:
            q4, k4, v4 = (_heads4(t, h) for t in (q, k, v))

            def sdpa():
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            if keep is not None:
                sdpa, backend = _sdpa_masked(torch, q4, k4, v4, scale, keep)
            library_ms = _median_ms(torch, sdpa)
        ok = finite and err_o <= O_BOUND and err_lse <= LSE_BOUND and k1_same
        bound_ms, bound_by = _attn_bounds(b, sq, skv, h, d)["K1"]
        results[name] = dict(err_o=err_o, err_lse=err_lse, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             library_backend=backend if library_ms is not None else None)
        lib = "" if library_ms is None else \
            f" SDPA {backend} fwd {library_ms:.4f} ms (K1 / SDPA {ms / library_ms:.3f})"
        print(f"[k1] {name}: max|do|={err_o:.3e} (bound {O_BOUND:g}) "
              f"max|dlse|={err_lse:.3e} (bound {LSE_BOUND:g}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{lib} "
              f"(least time {bound_ms:.4f} ms, {bound_by}; {100 * bound_ms / ms:.1f}% "
              f"of it), bitwise equal across two runs {k1_same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 case {name} disagrees with the plain version")
    return results


def phase_k23_cases(torch) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    from onetrainer_tpu_torch.ops import flash_folded as ff
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {}
    for name, b, sq, skv, h, d, with_keep in K23_CASES:
        q, k, v, keep = _rand_case(torch, gen, b, sq, skv, h, d, with_keep)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        scale = 1.0 / d ** 0.5
        o, lse = ff.flash_attention_folded_fwd(q, k, v, h, sm_scale=scale, kv_keep=keep)
        args = (q, k, v, o, lse, do, h)
        kw = dict(sm_scale=scale, kv_keep=keep)
        # K2 and K3 on the pre-pass's delta, as the autograd backward runs them
        delta = ff.flash_attention_folded_delta(o, do, h)
        dkw = dict(kw, delta=delta)
        dq = ff.flash_attention_folded_dq(*args, **dkw)
        dq2 = ff.flash_attention_folded_dq(*args, **dkw)
        dk, dv = ff.flash_attention_folded_dkv(*args, **dkw)
        dk2, dv2 = ff.flash_attention_folded_dkv(*args, **dkw)
        # the plain versions over chunks of heads: q, k, v, o and dO by
        # columns, lse by rows
        packed, stats = (q, k, v, o, do), (lse,)

        def plain_dq():
            return _plain_by_heads(
                torch, lambda q_, k_, v_, o_, do_, lse_, h_, **k_w:
                ff.flash_attention_folded_dq_reference(q_, k_, v_, o_, lse_, do_, h_, **k_w),
                h, packed, stats, "p", **kw)

        def plain_dkv():
            return _plain_by_heads(
                torch, lambda q_, k_, v_, o_, do_, lse_, h_, **k_w:
                ff.flash_attention_folded_dkv_reference(q_, k_, v_, o_, lse_, do_, h_, **k_w),
                h, packed, stats, "pp", **kw)

        def plain_delta():
            return _plain_by_heads(torch, ff.flash_attention_folded_delta_reference, h,
                                   (o, do), (), "s")
        dq_ref = plain_dq()
        dk_ref, dv_ref = plain_dkv()
        delta_ref = plain_delta()
        torch.cuda.synchronize()
        k2_same = bool(torch.equal(dq, dq2))
        k3_same = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
        err_delta = (delta - delta_ref).abs().max().item()
        delta_scale = delta_ref.abs().max().item()
        del dq2, dk2, dv2
        errs, scales, rels = {}, {}, {}
        for n, a, r in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            diff = a.float() - r.float()
            errs[n] = diff.abs().max().item()
            scales[n] = r.float().abs().max().item()
            rels[n] = (diff.norm() / r.float().norm()).item()
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv))
        del dq_ref, dk_ref, dv_ref

        def backward():
            dl = ff.flash_attention_folded_delta(o, do, h)
            ff.flash_attention_folded_dq(*args, **kw, delta=dl)
            ff.flash_attention_folded_dkv(*args, **kw, delta=dl)
        k2_ms = _median_ms(torch, lambda: ff.flash_attention_folded_dq(*args, **dkw))
        k3_ms = _median_ms(torch, lambda: ff.flash_attention_folded_dkv(*args, **dkw))
        delta_ms = _median_ms(torch, lambda: ff.flash_attention_folded_delta(o, do, h))
        bwd_ms = _median_ms(torch, backward)
        k2_device_ms = _device_ms(torch, lambda: ff.flash_attention_folded_dq(*args, **dkw),
                                  "flash_bwd_dq_kernel")
        plain_delta_ms = _median_ms(torch, plain_delta, reps=5)
        plain_dq_ms = _median_ms(torch, plain_dq, reps=5)
        plain_dkv_ms = _median_ms(torch, plain_dkv, reps=5)
        library_ms, backend = None, "FLASH_ATTENTION"
        if name in SDPA_BWD_CASES:
            q4, k4, v4 = (_heads4(t, h).detach().requires_grad_() for t in (q, k, v))
            if keep is not None:
                sdpa, backend = _sdpa_masked(torch, q4, k4, v4, scale, keep)
                out4 = sdpa()
            else:
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            do4 = _heads4(do, h)
            library_ms = _median_ms(torch, lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True))
        ok = finite and all(errs[n] <= DGRAD_MAX_REL * scales[n]
                            and rels[n] <= DGRAD_REL_L2 for n in errs)
        ok = ok and k2_same and k3_same and err_delta <= DELTA_MAX_REL * delta_scale
        results[name] = dict(errs=errs, k2_ms=k2_ms, k3_ms=k3_ms, bwd_ms=bwd_ms,
                             k2_device_ms=k2_device_ms,
                             plain_dq_ms=plain_dq_ms, plain_dkv_ms=plain_dkv_ms,
                             library_ms=library_ms, err_delta=err_delta,
                             library_backend=backend if library_ms is not None else None,
                             delta_ms=delta_ms, plain_delta_ms=plain_delta_ms)
        bounds = _attn_bounds(b, sq, skv, h, d)

        def share(tag, ms):
            return (f"least time {bounds[tag][0]:.4f} ms, {bounds[tag][1]}; "
                    f"{100 * bounds[tag][0] / ms:.1f}% of it")
        lib = "" if library_ms is None else \
            f"; SDPA {backend} bwd (dq+dk+dv) {library_ms:.4f} ms (whole backward / SDPA " \
            f"{bwd_ms / library_ms:.3f})"
        print(f"[k23] {name}: " + " ".join(
                  f"max|d{n}|={errs[n]:.3e} (bound {DGRAD_MAX_REL:g} x max|{n}| "
                  f"{scales[n]:.3e}) rel L2 {rels[n]:.3e} (bound {DGRAD_REL_L2:g})"
                  for n in errs) + "; "
              f"K2 {k2_ms:.4f} ms, device {k2_device_ms:.4f} ms (plain {plain_dq_ms:.4f} ms, "
              f"{share('K2', k2_ms)}); K3 {k3_ms:.4f} ms (plain {plain_dkv_ms:.4f} ms, "
              f"{share('K3', k3_ms)}); pre-pass max|ddelta|={err_delta:.3e} (bound "
              f"{DELTA_MAX_REL:g} x max|delta| {delta_scale:.3e}) {delta_ms:.4f} ms (plain "
              f"{plain_delta_ms:.4f} ms, {share('delta', delta_ms)}); whole backward "
              f"{bwd_ms:.4f} ms ({share('bwd', bwd_ms)}){lib}; bitwise equal across two "
              f"runs K2 {k2_same} K3 {k3_same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2/K3 case {name} disagrees with the plain versions")
    return results


def _k4_bound(n_half: int, out_bytes: int) -> tuple[float, str]:
    """K4 moves n_half code bytes, n_half / 32 fp32 scales and 2 * n_half
    outputs; one multiply per output."""
    return _bound_ms(0.0, n_half + 4 * (n_half // 32) + out_bytes * 2 * n_half)


def phase_k4(torch) -> dict:
    from onetrainer_tpu_torch.ops import nf4
    from onetrainer_tpu_torch.ops.quant import quantize_nf4
    gen = torch.Generator(device="cuda").manual_seed(44)
    results = {}
    for name, shape in K4_CASES:
        w = torch.randn(shape, generator=gen, device="cuda") * 0.02
        q = quantize_nf4(w)
        n_half = q.q.numel()
        ok, err = True, 0.0
        for dtype in (torch.bfloat16, torch.float32):
            out = nf4.nf4_dequant_flat(q.q, q.scales, dtype)
            ref = nf4.nf4_dequant_reference(q.q, q.scales, dtype)
            torch.cuda.synchronize()
            int_view = torch.int16 if dtype == torch.bfloat16 else torch.int32
            same = bool(torch.equal(out.view(int_view), ref.view(int_view)))
            ok = ok and same
            err = max(err, (out.float() - ref.float()).abs().max().item())
            print(f"[k4] {name} {tuple(shape)} -> {dtype}: bitwise equal {same}")
        if not ok:
            raise AssertionError(f"K4 case {name} differs from the plain version")
        if name not in K4_TIMED:
            results[name] = dict(n=w.numel(), max_abs_err=err)
            continue
        ms = _device_ms(torch, lambda: nf4.nf4_dequant_flat(q.q, q.scales, torch.bfloat16),
                        "nf4_dequant_kernel")
        call_ms = _median_ms(torch, lambda: nf4.nf4_dequant_flat(q.q, q.scales, torch.bfloat16))
        plain_ms = _median_ms(torch, lambda: nf4.nf4_dequant_reference(
            q.q, q.scales, torch.bfloat16), reps=5)
        bound_ms, bound_by = _k4_bound(n_half, 2)
        results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, n=w.numel(), max_abs_err=err)
        print(f"[k4] {name}: {w.numel()} elements, kernel {ms:.4f} ms of device time "
              f"({call_ms:.4f} ms per call with the wrapper, events), plain "
              f"{plain_ms:.4f} ms, least time {bound_ms:.4f} ms ({bound_by}, "
              f"{n_half * 2.5625 / 1e6:.1f} MB), no single PyTorch call ok")
    return results


def _bf16_neighbours(torch, s):
    """(lower, upper) bf16 neighbours of fp32 s by magnitude, as int32 bit
    patterns of fp32: s truncated to bf16, and one bf16 step beyond."""
    bits = s.view(torch.int32)
    low = bits & ~0xFFFF
    return low, low + 0x10000


def _qlora_adapter_shapes(torch) -> list:
    """The shapes of the SDXL QLoRA step's adapter tensors (LoRA rank 16 on
    every UNet dense and conv layer), from a UNet built on "meta"."""
    from onetrainer_tpu_torch.models.unet import UNet2DCondition, sdxl_unet_config
    from onetrainer_tpu_torch.peft.lora import PeftConfig, adapter_shapes
    with torch.device("meta"):
        unet = UNet2DCondition(sdxl_unet_config())
    return [shape for entry in adapter_shapes(unet, PeftConfig(rank=16)).values()
            for shape in entry.values()]


def phase_k5(torch) -> dict:
    from onetrainer_tpu_torch.ops.sr_update import sr_update, sr_update_leaves
    from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16
    gen = torch.Generator(device="cuda").manual_seed(55)
    # a seed with both 32-bit halves set and the sign bit: the key layout
    seed_a = torch.tensor([-0x123456789ABCDEF], dtype=torch.int64, device="cuda")
    seed_b = torch.tensor([1235], dtype=torch.int64, device="cuda")

    def plain(p, u, seed):
        return stochastic_round_to_bf16(
            p.float() + u.float(), philox_bits(seed, p.numel(), p.device).view(p.shape))

    ok, max_err = True, 0.0
    # bit for bit against the plain rounding on the kernel's Philox bits,
    # fp32 and bf16 u, at the stated sizes and the step's largest adapter
    for n in K5_SIZES + (K5_LARGEST_ADAPTER,):
        p = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
        u32 = torch.randn(n, generator=gen, device="cuda") * 1e-3
        for u in (u32, u32.to(torch.bfloat16)):
            out, ref = sr_update(p, u, seed_a), plain(p, u, seed_a)
            torch.cuda.synchronize()
            same = bool(torch.equal(out.view(torch.int16), ref.view(torch.int16)))
            max_err = max(max_err, (out.float() - ref.float()).abs().max().item())
            ok = ok and same
            print(f"[k5] n={n}, {u.dtype} u: bitwise equal to the plain rounding on "
                  f"Philox bits {same}")
    for n in K5_SIZES:
        p = (torch.randn(n, generator=gen, device="cuda")).to(torch.bfloat16)
        u = torch.randn(n, generator=gen, device="cuda") * 1e-3
        u[: n // 4] = 0.0          # p + u representable: exact
        s = p.float() + u
        out = sr_update(p, u, seed_a)
        low, high = _bf16_neighbours(torch, s)
        got = out.float().view(torch.int32)
        neighbour = bool(((got == low) | (got == high)).all())
        exact = bool(torch.equal(out[: n // 4], p[: n // 4]))
        same = bool(torch.equal(sr_update(p, u, seed_a), out))
        other = not bool(torch.equal(sr_update(p, u, seed_b), out))
        # p = 1, u = 2^-9: one bf16 step is 2^-7, so up with probability 1/4
        ones = torch.ones(n, dtype=torch.bfloat16, device="cuda")
        quarter = torch.full((n,), 2.0 ** -9, device="cuda")
        r = sr_update(ones, quarter, seed_a).float()
        err = r - (1.0 + 2.0 ** -9)
        mean, sigma = err.mean().item(), (3.0 ** 0.5) * 2.0 ** -9 / n ** 0.5
        up = (r > 1.0).float().mean().item()
        up_sigma = (0.25 * 0.75 / n) ** 0.5
        unbiased = abs(mean) <= 5 * sigma and abs(up - 0.25) <= 5 * up_sigma
        torch.cuda.synchronize()
        case_ok = neighbour and exact and same and other and unbiased
        ok = ok and case_ok
        print(f"[k5] n={n}: neighbours {neighbour}, exact where representable "
              f"{exact}, same seed same output {same}, other seed other output "
              f"{other}; p=1 u=2^-9: mean error {mean:.3e} (5 sigma {5 * sigma:.3e}), "
              f"up rate {up:.5f} (1/4 +- {5 * up_sigma:.5f}) {'ok' if case_ok else 'FAIL'}")
    n = K5_SIZES[0]
    p = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    u32 = torch.randn(n, generator=gen, device="cuda") * 1e-3
    ms_fp32_u = _device_ms(torch, lambda: sr_update(p, u32, seed_a), "sr_update_kernel")
    bound_fp32_u = _bound_ms(0.0, 8 * n)
    plain_fp32_u = _median_ms(torch, lambda: plain(p, u32, 1234), reps=5)
    print(f"[k5] n={n}, fp32 u: kernel {ms_fp32_u:.4f} ms of device time, plain "
          f"{plain_fp32_u:.4f} ms, "
          f"least time {bound_fp32_u[0]:.4f} ms (bytes, 8 per element)")
    shape = K5_LARGEST_ADAPTER_SHAPE
    p = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    u = (torch.randn(shape, generator=gen, device="cuda") * 1e-4).to(torch.bfloat16)
    ms = _device_ms(torch, lambda: sr_update(p, u, seed_a, out=p), "sr_update_kernel")
    call_ms = _median_ms(torch, lambda: sr_update(p, u, seed_a, out=p))
    plain_ms = _median_ms(torch, lambda: p.copy_(plain(p, u, 1234)), reps=5)
    bound_ms, bound_by = _bound_ms(0.0, 6 * p.numel())
    print(f"[k5] step's largest adapter {shape} ({p.numel()} elements), bf16 u: "
          f"kernel {ms:.4f} ms of device time ({call_ms:.4f} ms per call with the "
          f"wrapper, events), plain {plain_ms:.4f} ms, least time {bound_ms:.4f} ms "
          f"({bound_by}, 6 bytes per element), no single PyTorch call "
          f"{'ok' if ok else 'FAIL'}")

    # one launch over the QLoRA step's adapter set, as the step runs it:
    # bf16 p and u, out = p, a seed per leaf
    shapes = _qlora_adapter_shapes(torch)
    ps = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]
    us = [(torch.randn(s, generator=gen, device="cuda") * 1e-4).to(torch.bfloat16)
          for s in shapes]
    seeds = torch.empty(len(shapes), dtype=torch.int64, device="cuda")
    seeds.random_(generator=gen)
    n_el = sum(p.numel() for p in ps)
    before = sr_update_leaves.launches
    outs = sr_update_leaves(ps, us, seeds)
    launches = sr_update_leaves.launches - before
    same = True
    for i, (p, u, out) in enumerate(zip(ps, us, outs)):
        ref = plain(p, u, seeds[i:i + 1])
        same = same and bool(torch.equal(out.view(torch.int16), ref.view(torch.int16)))
        max_err = max(max_err, (out.float() - ref.float()).abs().max().item())
    del outs
    list_ok = same and launches == 1
    ok = ok and list_ok
    list_ms = _device_ms(torch, lambda: sr_update_leaves(ps, us, seeds, outs=ps),
                         "sr_update_kernel")
    list_call_ms = _median_ms(torch, lambda: sr_update_leaves(ps, us, seeds, outs=ps))
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        sr_update_leaves(ps, us, seeds, outs=ps)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    list_host_ms = statistics.median(host)
    list_plain_ms = _once_ms(torch, lambda: [
        p.copy_(plain(p, u, seeds[i:i + 1])) for i, (p, u) in enumerate(zip(ps, us))])
    list_bound = _bound_ms(0.0, 6 * n_el)
    print(f"[k5] QLoRA adapter set: {len(shapes)} bf16 tensors, {n_el} elements, bf16 u, "
          f"out = p: {launches} launch, bitwise equal to the plain rounding of every leaf "
          f"{same}; kernel {list_ms:.4f} ms of device time ({list_call_ms:.4f} ms per call "
          f"with the wrapper, events; wrapper host time {list_host_ms:.4f} ms per call), "
          f"plain {list_plain_ms:.4f} ms, least time {list_bound[0]:.4f} ms ({list_bound[1]}, "
          f"6 bytes per element; {100 * list_bound[0] / list_ms:.1f}% of it) "
          f"{'ok' if list_ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K5 differs from the plain rounding or fails a property "
                             "of stochastic rounding")
    print(f"[k5] max |K5 - plain| {max_err:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max_err, shape=shape, ms_fp32_u=ms_fp32_u, plain_fp32_u=plain_fp32_u,
                bound_fp32_u=bound_fp32_u[0], list_ms=list_ms, list_call_ms=list_call_ms,
                list_host_ms=list_host_ms, list_plain_ms=list_plain_ms,
                list_bound_ms=list_bound[0], list_bound_by=list_bound[1],
                n_leaves=len(shapes), n_elements=n_el)


def _plain_attention(ff):
    """The plain version in place of `flash_attention_folded`. Under autograd
    it is recomputed in the backward (torch.utils.checkpoint) rather than
    keeping its [B, H, Sq, Skv] fp32 scores and probabilities, 3.4 GB each
    per attention at SD 2.1's 9216 tokens; above PLAIN_SCORES_BYTES it runs
    on chunks of heads, each recomputed alone (8.3 GB at HunyuanVideo's
    9293 tokens)."""
    import torch
    from torch.utils.checkpoint import checkpoint

    def reference(q, k, v, num_heads, sm_scale, kv_keep):
        return ff.flash_attention_folded_reference(
            q, k, v, num_heads, sm_scale=sm_scale, kv_keep=kv_keep)[0]

    def one(q, k, v, num_heads, sm_scale, kv_keep):
        if torch.is_grad_enabled():
            return checkpoint(reference, q, k, v, num_heads, sm_scale, kv_keep,
                              use_reentrant=False)
        return reference(q, k, v, num_heads, sm_scale, kv_keep)

    def plain(q, k, v, num_heads, *, sm_scale, kv_keep=None):
        b, sq, inner = q.shape
        d = inner // num_heads
        return torch.cat([
            one(*(t[..., h0 * d:h1 * d] for t in (q, k, v)), h1 - h0, sm_scale, kv_keep)
            for h0, h1 in _head_chunks(b, sq, k.shape[1], num_heads)], dim=-1)
    return plain


def _k1_and_plain(torch, forward) -> dict:
    """`forward()` (an inference pass that synchronises) with the kernels,
    then with plain attention, each after a warm-up: both outputs, their
    host times, the kernel run's launches and peak memory, and the relative
    L2 distance of the outputs."""
    from onetrainer_tpu_torch.ops import flash_folded as ff
    forward()   # warm-up (cuDNN/cuBLAS handles, allocator)
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    out = forward()
    k1_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    kernel_fn = ff.flash_attention_folded
    ff.flash_attention_folded = _plain_attention(ff)
    try:
        forward()
        t0 = time.perf_counter()
        out_plain = forward()
        plain_s = time.perf_counter() - t0
    finally:
        ff.flash_attention_folded = kernel_fn
    finite = bool(torch.isfinite(out).all() and torch.isfinite(out_plain).all())
    return dict(out=out, k1_s=k1_s, plain_s=plain_s, launches=launches, peak_gib=peak_gib,
                rel=_rel_l2(out, out_plain), finite=finite)


def build_model(torch, unet_weight_dtype=None, model_type=None):
    """A model at its published widths with seeded weights on the card,
    compute bf16, the UNet's parameters in `unet_weight_dtype` (fp32 by
    default), the rest fp32. SDXL (the default) is built with tx_only
    gradient checkpointing, which acts only where autograd records: the
    inference phases run the plain forward, the training phases recompute.
    SD 1.5/2.x is built without it, as the reference's bench.py SD 1.5
    stage trains."""
    from onetrainer_tpu_torch.io.weights import init_sd_weights
    from onetrainer_tpu_torch.models.sd import create_sd_model
    from onetrainer_tpu_torch.models.sdxl import create_sdxl_model
    from onetrainer_tpu_torch.util.enums import ModelType
    model_type = model_type or ModelType.STABLE_DIFFUSION_XL_10_BASE
    unet_weight_dtype = unet_weight_dtype or torch.float32
    t0 = time.perf_counter()
    if model_type.is_stable_diffusion_xl():
        model = create_sdxl_model(model_type, dtype=torch.bfloat16,
                                  gradient_checkpointing=True, remat_policy="tx_only",
                                  device="meta", unet_weight_dtype=unet_weight_dtype)
    else:
        model = create_sd_model(model_type, dtype=torch.bfloat16, device="meta",
                                unet_weight_dtype=unet_weight_dtype)
    init_sd_weights(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    counts = ", ".join(f"{name} {sum(p.numel() for p in m.parameters())}"
                       for name, m in model.modules().items())
    print(f"[model] {model_type.value}: params {counts} (UNet {unet_weight_dtype}, "
          f"the rest fp32, compute bf16), seeded weights on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return model


def phase_unet(torch, model):
    gen = torch.Generator(device="cuda").manual_seed(7)
    sample = torch.randn((2, 128, 128, 4), generator=gen, device="cuda")
    context = torch.randn((2, 77, 2048), generator=gen, device="cuda")
    pooled = torch.randn((2, 1280), generator=gen, device="cuda")
    ts = torch.full((2,), 500, dtype=torch.int32, device="cuda")
    time_ids = torch.tensor([[1024, 1024, 0, 0, 1024, 1024]] * 2,
                            dtype=torch.float32, device="cuda")

    def forward():
        with torch.inference_mode():
            out = model.unet(sample, ts, context, pooled, time_ids)
        torch.cuda.synchronize()
        return out

    run = _k1_and_plain(torch, forward)
    launches = run["launches"]["K1"]
    ok = (run["finite"] and run["rel"] <= UNET_REL_L2_BOUND
          and launches == sum(SDXL_SELF_ATTN.values())
          and tuple(run["out"].shape) == (2, 128, 128, 4))
    print(f"[unet] full-width SDXL UNet forward, latent 2x128x128x4: "
          f"K1 {run['k1_s'] * 1e3:.2f} ms ({launches} K1 launches), plain attention "
          f"{run['plain_s'] * 1e3:.2f} ms, rel L2 {run['rel']:.3e} (bound "
          f"{UNET_REL_L2_BOUND:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("UNet with K1 disagrees with plain attention")


def _kernel_wrappers() -> dict:
    from onetrainer_tpu_torch.ops import flash_folded as ff
    from onetrainer_tpu_torch.ops.nf4 import nf4_dequant_flat
    from onetrainer_tpu_torch.ops.sr_update import sr_update_leaves
    return {"K1": ff.flash_attention_folded_fwd, "K2": ff.flash_attention_folded_dq,
            "K3": ff.flash_attention_folded_dkv, "K3pre": ff.flash_attention_folded_delta,
            "K4": nf4_dequant_flat, "K5": sr_update_leaves}


def _reset_launch_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _launch_counts() -> dict:
    return {tag: fn.launches for tag, fn in _kernel_wrappers().items()}


def phase_sample(torch, model, size: int, self_attn: dict, tag: str, cfg_scale: float = 7.0,
                 k4_per_pass: int = 0, frames: int = 1, inpaint: tuple | None = None) -> dict:
    """Text-to-image through the family registry at size x size, 4 steps
    (DDIM; SD3's, FLUX's and HunyuanVideo's flow Euler), CFG `cfg_scale`
    (FLUX and HunyuanVideo: the guidance embedding): K1 exactly once per
    self-attention of `self_attn` per denoiser pass, K4 `k4_per_pass` times
    per pass (an NF4 denoiser's layers) and nothing else launched; a uint8
    image that is not constant. With `frames` > 1 (text-to-video), the
    decoded clip finite, its uint8 stack frames x size x size x 3 and not
    constant, the image its first frame. With `inpaint` (base image and mask
    PNG paths), an inpainting model fills the mask's region of the base
    image (sample_inpainting)."""
    from onetrainer_tpu_torch.config.sample_config import SampleConfig
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import NoiseScheduler, TrainingMethod

    config = TrainConfig.default_values()
    config.model_type = model.model_type
    config.training_method = TrainingMethod.FINE_TUNE
    # no part trains: a sampling-only setup
    config.unet.train = config.prior.train = False
    config.text_encoder.train = config.text_encoder_2.train = False
    family = get_family(config.model_type)
    setup = family.create_setup(model, config, 1)

    sc = SampleConfig.default_values()
    sc.prompt = "a photograph of an astronaut riding a horse"
    sc.negative_prompt = ""
    sc.height = sc.width = size
    sc.diffusion_steps = 4
    sc.cfg_scale = cfg_scale
    sc.seed = 42
    sc.noise_scheduler = NoiseScheduler.DDIM
    sc.frames = frames
    if inpaint is not None:
        sc.sample_inpainting = True
        sc.base_image_path, sc.mask_image_path = inpaint

    stamps, decoded = [], []
    if frames > 1:
        decode = model.vae.decode

        def recorded_decode(z):
            out = decode(z)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            decoded.append((tuple(out.shape), bool(torch.isfinite(out).all())))
            return out
        model.vae.decode = recorded_decode

    def on_progress(step, total):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = family.sample(setup, sc, on_progress)
    finally:
        model.vae.__dict__.pop("decode", None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    decode_ms = (stamps.pop() - stamps[-1]) * 1e3 if decoded else None
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    expected = sum(self_attn.values()) * sc.diffusion_steps
    image = out.image
    # NaN latents would decode to a constant image, so it must vary
    expected_k4 = k4_per_pass * sc.diffusion_steps
    ok = (launches == {"K1": expected, "K2": 0, "K3": 0, "K3pre": 0, "K4": expected_k4,
                       "K5": 0}
          and image.dtype.name == "uint8"
          and image.shape == (size, size, 3) and image.std() > 0)
    video = ""
    if frames > 1:
        clip = out.video
        ok = (ok and decoded == [((1, frames, size, size, 3), True)]
              and clip.shape == (frames, size, size, 3) and clip.dtype.name == "uint8"
              and clip.std() > 0 and (clip[0] == image).all())
        video = (f", video {clip.shape} {clip.dtype} mean {clip.mean():.2f} std "
                 f"{clip.std():.2f}, decoded finite {decoded}, VAE decode {decode_ms:.1f} ms")
    sampler = "DDIM" if model.model_type.is_stable_diffusion() \
        or model.model_type.is_stable_diffusion_xl() or model.model_type.is_pixart() \
        else "flow Euler"
    fill = (f", inpainting {os.path.basename(sc.base_image_path)} under "
            f"{os.path.basename(sc.mask_image_path)}" if inpaint is not None else "")
    print(f"[{tag}] {model.model_type.value} {size}x{size} {sampler} {sc.diffusion_steps} steps "
          f"CFG {sc.cfg_scale:g}{fill}: total {total_s:.3f} s, denoiser step median "
          f"{statistics.median(step_ms):.2f} ms (steps 2..{sc.diffusion_steps}: "
          f"{', '.join(f'{t:.2f}' for t in step_ms)} ms), peak "
          f"max_memory_allocated {peak_gib:.2f} GiB, K1 launches {launches['K1']} "
          f"(expected {expected}), K4 launches {launches['K4']} (expected {expected_k4}), "
          f"image {image.shape} {image.dtype} "
          f"mean {image.mean():.2f} std {image.std():.2f}{video} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("text-to-image run failed its checks")
    return launches


def _train_batch(torch, family, setup, batch_size: int, size: int,
                 prompt: str = "a photograph of an astronaut riding a horse") -> dict:
    """A size x size batch through the port's caches: a seeded image
    through the VAE encoder and `prompt` through the text encoder(s),
    tiled; SDXL's also carries TE2's states and the crop metadata, SD3's
    the assembled context and pooled embeddings of its three encoders; a
    step that trains a text encoder or embeddings gets the prompt's tokens
    instead; a VAE fine-tune's, the image itself ("image")."""
    encode_images, encode_text = family.make_encode_fns(setup)
    gen = torch.Generator(device="cuda").manual_seed(11)
    image = torch.rand((1, size, size, 3), generator=gen, device="cuda") * 2 - 1
    latents = encode_images(image)
    text = encode_text(prompt)

    def tile(t):
        return t.expand(batch_size, *t.shape[1:]).contiguous()
    batch = {
        "latent_image": tile(latents["latent_image"]),
        "latent_logvar": tile(latents["latent_logvar"]),
        "loss_weight": torch.ones((batch_size,), device="cuda"),
    }
    for name, value in text.items():
        if isinstance(value, torch.Tensor):   # the cached states (tokens are numpy)
            batch[name] = tile(value[None])
        elif setup.step_cfg.train_text_encoder:   # the step runs the text encoders
            batch[name] = tile(torch.as_tensor(value, device="cuda")[None])
    if setup.config.training_method.name == "FINE_TUNE_VAE":
        batch["image"] = tile(image)
    if setup.config.model_type.is_stable_diffusion_xl():
        batch["original_resolution"] = torch.full((batch_size, 2), size, device="cuda")
        batch["crop_offset"] = torch.zeros((batch_size, 2), device="cuda")
        batch["crop_resolution"] = torch.full((batch_size, 2), size, device="cuda")
    return batch


def inpaint_inputs(torch, root: str, height: int, width: int) -> tuple[str, str]:
    """A seeded base image and a gray mask (a bright rectangle over dim
    noise) written by the port's PNG codec at height x width, a size the
    samplers resize (bilinear, in numpy) -> their paths."""
    from onetrainer_tpu_torch.io.png import write_png
    gen = torch.Generator(device="cuda").manual_seed(17)
    base = (torch.rand((height, width, 3), generator=gen, device="cuda") * 255).byte()
    mask = (torch.rand((height, width), generator=gen, device="cuda") * 48).byte()
    mask[height // 4:height * 2 // 3, width // 5:width * 3 // 5] = 255
    paths = (os.path.join(root, "base.png"), os.path.join(root, "mask.png"))
    write_png(paths[0], base.cpu().numpy())
    write_png(paths[1], mask.cpu().numpy())
    return paths


def _inpaint_batch(torch, family, setup, batch_size: int, size: int) -> dict:
    """`_train_batch` with an inpainting model's cache rows beside it: the
    VAE latent of a seeded image with a rectangle blanked, and the mask at
    the latent's size (FLUX.1-fill: its 8x8 pixel patches as 64 channels
    per latent cell), tiled."""
    import numpy as np

    from onetrainer_tpu_torch.sampling.inpaint import downsample_mask, flux_fill_mask_channels
    batch = _train_batch(torch, family, setup, batch_size, size)
    encode_images, _ = family.make_encode_fns(setup)
    gen = torch.Generator(device="cuda").manual_seed(12)
    image = torch.rand((1, size, size, 3), generator=gen, device="cuda") * 2 - 1
    mask = np.zeros((size, size, 1), np.float32)
    mask[size // 4:size * 3 // 4, size // 8:size // 2] = 1.0
    cond = image * (1 - torch.from_numpy(mask).to("cuda"))
    fill = setup.config.model_type.is_flux()
    latent_mask = flux_fill_mask_channels(mask) if fill else downsample_mask(mask, 8)

    def tile(t):
        return t.expand(batch_size, *t.shape[1:]).contiguous()
    batch["latent_conditioning_image"] = tile(encode_images(cond)["latent_image"])
    batch["latent_mask"] = tile(torch.from_numpy(latent_mask)[None].to("cuda"))
    return batch


def _lora_grads(torch, setup, batch, timestep, noise, latent_noise):
    """The LoRA gradients of one step's loss at fixed randomness, without
    the update (the step's own forward and backward)."""
    from onetrainer_tpu_torch.train.train_state import param_groups
    flat = [t for g in param_groups(setup.state.params).values() for t in g]
    draws = {} if latent_noise is None else {"latent_noise": latent_noise}
    loss = setup.train_step.loss(batch, None, timestep=timestep, noise=noise, **draws)
    return torch.cat([g.flatten() for g in torch.autograd.grad(loss, flat)])


def _lora_config(batch_size: int, model_type=None):
    """bench.py's SDXL and SD 1.5 stages as a training config: LoRA r16 a16
    on the UNet, AdamW lr 1e-4, clip 1.0, text encoders frozen (cached
    text); SDXL unless `model_type` names another."""
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.util.enums import ModelType, TrainingMethod
    config = TrainConfig.default_values()
    config.model_type = model_type or ModelType.STABLE_DIFFUSION_XL_10_BASE
    config.training_method = TrainingMethod.LORA
    config.lora_rank = 16
    config.lora_alpha = 16.0
    config.batch_size = batch_size
    config.learning_rate = 1e-4
    config.learning_rate_warmup_steps = 0.0
    config.clip_grad_norm = 1.0
    config.text_encoder.train = False
    config.text_encoder_2.train = False
    return config


def _finite(values) -> bool:
    return all(x == x and abs(x) != float("inf") for x in values)


def _setup_and_steps(torch, model, config, tag: str, size: int = 1024,
                     after_batch=None, make_batch=None, steps: int = TRAIN_STEPS) -> dict:
    """Setup through the family registry, the cached batch at size x size
    (`make_batch(setup)` when given), then `after_batch(setup)`, when given,
    one warm-up step, then `steps` timed steps with every launch count
    zeroed just before them and read just after."""
    from onetrainer_tpu_torch.setup.families import get_family
    family = get_family(config.model_type)
    t0 = time.perf_counter()
    setup = family.create_setup(model, config, 100)
    batch = make_batch(setup) if make_batch is not None else \
        _train_batch(torch, family, setup, config.batch_size, size)
    if after_batch is not None:
        after_batch(setup)
    torch.cuda.synchronize()
    group = next(g for g in setup.state.params if g.endswith("_lora"))
    adapters = setup.state.params[group]
    n_lora = sum(t.numel() for e in adapters.values() for t in e.values())
    dtype = next(iter(next(iter(adapters.values())).values())).dtype
    kind = {"LOHA": "LoHa"}.get(config.peft_type.name, "DoRA" if config.lora_decompose
                                else "LoRA")
    print(f"[{tag}] {kind} r{config.lora_rank} a{config.lora_alpha:g} ({dtype}) on "
          f"{len(adapters)} {group[:-5]} layers ({n_lora} params), batch {config.batch_size} "
          f"at {size}x{size} cached through the VAE encoder and the text encoders, "
          f"{setup.model.prediction_type}, set up in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    metrics = setup.train_step(setup.state, batch, gen)
    first = [metrics["loss"].item(), metrics["grad_norm"].item()]
    warm_s = time.perf_counter() - t0
    # the zero-initialised factor (LoRA's and DoRA's up, LoHa's w2a) moved
    up = "hada_w2_a" if kind == "LoHa" else "lora_up"
    up_max = max(e[up].abs().max().item() for e in adapters.values())
    print(f"[{tag}] warm-up step {warm_s:.3f} s: loss {first[0]:.6f} grad_norm "
          f"{first[1]:.6f}, max |{up}| after it {up_max:.3e}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    step_s, losses, norms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = setup.train_step(setup.state, batch, gen)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        step_s.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(step_s)
    print(f"[{tag}] {steps} timed steps: sec/step median {med:.4f} "
          f"(min {min(step_s):.4f}, max {max(step_s):.4f}; "
          f"{', '.join(f'{x:.4f}' for x in step_s)}), images/s "
          f"{config.batch_size / med:.3f}, peak max_memory_allocated {peak_gib:.2f} GiB, "
          f"losses {', '.join(f'{x:.6f}' for x in losses)}, grad_norms "
          f"{', '.join(f'{x:.6f}' for x in norms)}, launches {launches}")
    return dict(setup=setup, batch=batch, gen=gen, launches=launches, sec_per_step=med,
                peak_gib=peak_gib, finite=_finite(first + losses + norms), up_max=up_max)


def _continuous(model_type) -> bool:
    """Whether the model's step draws continuous timesteps in [0, 1]."""
    return model_type.is_flux() or model_type.is_wuerstchen()


def _fixed_draws(torch, batch, continuous: bool = False):
    """Timesteps 250 and 750 (as t = 0.25 and 0.75 for FLUX's and
    Würstchen's continuous timesteps), noise and latent-sampling noise from
    a fixed seed."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    b = batch["latent_image"].shape[0]
    timestep = torch.tensor(([250, 750] * b)[:b], dtype=torch.int32, device="cuda")
    if continuous:
        timestep = timestep.float() / 1000
    noise = torch.randn(batch["latent_image"].shape, generator=gen, device="cuda")
    latent_noise = torch.randn(batch["latent_image"].shape, generator=gen, device="cuda")
    return timestep, noise, latent_noise


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _grads_against_plain(torch, setup, batch, tag: str, plain_dequant: bool = False) -> dict:
    """One step's LoRA gradients with K1-K3 against plain attention (and,
    with `plain_dequant`, K4 against the plain NF4 dequant), at fixed
    timesteps and noise; the sequence length of each K1 launch of the
    kernel run."""
    from onetrainer_tpu_torch.ops import flash_folded as ff
    from onetrainer_tpu_torch.ops import quant
    from onetrainer_tpu_torch.ops.nf4 import nf4_dequant_reference
    draws = _fixed_draws(torch, batch, _continuous(setup.config.model_type))
    if "latent_logvar" not in batch:   # deterministic latents (Sana's DC-AE, effnet)
        draws = draws[:2] + (None,)
    seqs = []
    kernel_fn = ff.flash_attention_folded

    def recorded(q, *args, **kwargs):
        seqs.append(q.shape[1])
        return kernel_fn(q, *args, **kwargs)
    ff.flash_attention_folded = recorded
    try:
        g_kernel = _lora_grads(torch, setup, batch, *draws)
    finally:
        ff.flash_attention_folded = kernel_fn
    ff.flash_attention_folded = _plain_attention(ff)
    dequant_fn = quant.nf4_dequant_flat
    if plain_dequant:
        quant.nf4_dequant_flat = nf4_dequant_reference
    try:
        g_plain = _lora_grads(torch, setup, batch, *draws)
    finally:
        ff.flash_attention_folded = kernel_fn
        quant.nf4_dequant_flat = dequant_fn
    rel = _rel_l2(g_kernel, g_plain)
    finite = bool(torch.isfinite(g_kernel).all() and torch.isfinite(g_plain).all())
    by_seq = {n: seqs.count(n) for n in sorted(set(seqs), reverse=True)}
    plain = "plain attention and the plain dequant" if plain_dequant else "plain attention"
    print(f"[{tag}] trained tensors' gradients, kernels vs {plain}: rel L2 {rel:.3e} "
          f"(bound {GRAD_REL_L2_BOUND:g}) over {g_kernel.numel()} values; K1 launches "
          f"of one forward by sequence length {by_seq}")
    return {"rel": rel, "finite": finite, "by_seq": by_seq}


def phase_train(torch, model, config, size: int, self_attn: dict, tag: str) -> dict:
    """The LoRA step at size x size: exact K1, K2, K3 and pre-pass launches
    per step (one of each per self-attention of `self_attn`, {sequence
    length: count per UNet pass}; K1 twice where gradient checkpointing
    recomputes the transformer blocks), K1 at those sequence lengths, the
    gradients against plain attention, a profiler split."""
    recompute = 2 if model.unet_config.gradient_checkpointing else 1
    run = _setup_and_steps(torch, model, config, tag, size)
    n = TRAIN_STEPS * sum(self_attn.values())
    expected = {"K1": recompute * n, "K2": n, "K3": n, "K3pre": n, "K4": 0, "K5": 0}
    setup, batch = run["setup"], run["batch"]
    grads = _grads_against_plain(torch, setup, batch, tag)
    prediction = "v_prediction" if config.force_v_prediction else "epsilon"
    ok = (run["finite"] and grads["finite"] and run["up_max"] > 0
          and run["launches"] == expected
          and grads["by_seq"] == {s: recompute * c for s, c in self_attn.items()}
          and grads["rel"] <= GRAD_REL_L2_BOUND
          and setup.model.prediction_type == prediction)
    print(f"[{tag}] launches {run['launches']} (expected {expected}; per UNet pass by "
          f"sequence length {self_attn}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} training run failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], tag)
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"], "batch": batch}


def _quantized_layers(torch, unet) -> tuple[int, int]:
    """(quantized layers of the UNet, those inside a transformer block,
    which tx_only checkpointing runs a second time in the backward)."""
    from onetrainer_tpu_torch.models.unet import BasicTransformerBlock
    from onetrainer_tpu_torch.ops.quant import is_quantized

    def count(module):
        return sum(is_quantized(getattr(m, "weight", None)) for m in module.modules())
    in_blocks = sum(count(m) for m in unet.modules() if isinstance(m, BasicTransformerBlock))
    return count(unet), in_blocks


def phase_qlora(torch) -> dict:
    from onetrainer_tpu_torch.ops import quant
    from onetrainer_tpu_torch.ops.nf4 import nf4_dequant_reference
    from onetrainer_tpu_torch.util.enums import DataType
    config = _lora_config(2)
    config.unet.weight_dtype = DataType.NFLOAT_4
    config.lora_weight_dtype = DataType.BFLOAT_16
    config.optimizer.stochastic_rounding = True
    model = build_model(torch, config.weight_dtypes().unet.to_load_dtype())
    run = _setup_and_steps(torch, model, config, "qlora")
    setup, batch = run["setup"], run["batch"]
    n_quant, n_in_blocks = _quantized_layers(torch, model.unet)
    shapes = [tuple(t.shape) for e in setup.state.params["unet_lora"].values()
              for t in e.values()]
    k5_shapes = _qlora_adapter_shapes(torch)
    n_tensors = len(shapes)
    nf4_bytes = sum(w.q.numel() + 4 * w.scales.numel() for m in model.unet.modules()
                    if quant.is_quantized(w := getattr(m, "weight", None)))
    per_pass = sum(SDXL_SELF_ATTN.values())
    n = TRAIN_STEPS * per_pass
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n,
                "K4": TRAIN_STEPS * (n_quant + n_in_blocks), "K5": TRAIN_STEPS}
    print(f"[qlora] UNet NF4: {n_quant} quantized layers ({n_in_blocks} inside "
          f"transformer blocks), {nf4_bytes / 2 ** 30:.3f} GiB of codes and scales; "
          f"{n_tensors} bf16 adapter tensors; per step K1 {2 * per_pass}, "
          f"K2 {per_pass}, K3 {per_pass}, K3's pre-pass {per_pass}, "
          f"K4 {n_quant + n_in_blocks}, K5 1 launches expected; adapter shapes those "
          f"phase k5 rounds {shapes == k5_shapes}")

    # one step's LoRA gradients with K4 against the plain dequant
    draws = _fixed_draws(torch, batch)
    g_kernel = _lora_grads(torch, setup, batch, *draws)
    g_again = _lora_grads(torch, setup, batch, *draws)
    kernel_fn = quant.nf4_dequant_flat
    quant.nf4_dequant_flat = nf4_dequant_reference
    try:
        g_plain = _lora_grads(torch, setup, batch, *draws)
    finally:
        quant.nf4_dequant_flat = kernel_fn
    rel, noise = _rel_l2(g_kernel, g_plain), _rel_l2(g_again, g_kernel)
    grads_finite = bool(torch.isfinite(g_kernel.float()).all())
    print(f"[qlora] LoRA gradients, K4 vs plain dequant: rel L2 {rel:.3e} (bound "
          f"{QLORA_GRAD_REL_L2_BOUND:g}; K4 against itself {noise:.3e}) over "
          f"{g_kernel.numel()} values")
    ok = (run["finite"] and grads_finite and run["up_max"] > 0 and shapes == k5_shapes
          and run["launches"] == expected and rel <= QLORA_GRAD_REL_L2_BOUND)
    print(f"[qlora] launches {run['launches']} (expected {expected}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("QLoRA training run failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], "qlora")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"], "model": model}


def phase_fp8(torch) -> dict:
    from onetrainer_tpu_torch.util.enums import DataType
    config = _lora_config(4)
    config.unet.weight_dtype = DataType.FLOAT_8
    model = build_model(torch, config.weight_dtypes().unet.to_load_dtype())
    run = _setup_and_steps(torch, model, config, "fp8")
    ok = run["finite"] and run["up_max"] > 0 and run["launches"]["K4"] == 0
    print(f"[fp8] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fp8-base training run failed its checks")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"], "model": model}


# the PEFT phases' adapter sets at rank 16 on the SDXL UNet's 794 layers
DORA_DROPOUT = 0.1
# a UNet forward with the adapters merged into the base against the
# adapters in the layers. Every merged weight equals the bf16 weight its
# layer computes with in-layer, bit for bit (checked); conv_out computes
# in fp32, and sees DoRA's W' in fp32 in the layer but rounded to bf16 in
# the merged base (the reference's `_merged_kernel` gives bf16 over
# a quantized base): that rounding is the whole gap (CPU:
# tests/test_torch_port_peft.py::test_dora_merge_into_nf4_equals_in_layer).
# lora_up first gets seeded values of a trained adapter's size (after the
# steps at lr 1e-4 it moves the output about as little as the rounding),
# and the adapters must move the output MERGE_EFFECT_RATIO times more than
# the merge's gap
MERGED_REL_L2_BOUND = 1e-2
MERGE_UP_STD = 0.02
MERGE_EFFECT_RATIO = 10.0


def _peft_config(batch_size: int, **fields):
    """The SDXL LoRA config (`_lora_config`) with bf16 adapters under
    stochastic rounding and `fields` set (the PEFT type, DoRA, dropout)."""
    from onetrainer_tpu_torch.util.enums import DataType
    config = _lora_config(batch_size)
    config.lora_weight_dtype = DataType.BFLOAT_16
    config.optimizer.stochastic_rounding = True
    for name, value in fields.items():
        setattr(config, name, value)
    return config


def _k5_over_the_adapters(torch, setup, batch, gen, tag: str) -> dict:
    """One PEFT step's K5 call captured: every adapter tensor in one
    launch, bitwise against the plain rounding on the named leaves and a
    bf16 neighbour of p + u on all; its device time, bound and wrapper
    host time."""
    with _K5Capture(torch, time_reps=10) as capture:
        setup.train_step(setup.state, batch, gen)["loss"].item()
    k5 = _k5_on_the_update(torch, capture)
    n = sum(1 for g in setup.state.params.values() for e in g.values() for _ in e)
    bound = _bound_ms(0.0, (8 if torch.float32 in k5["u_dtypes"] else 6) * k5["elements"])
    ok = (k5["launches"] == 1 and k5["leaves"] == n and all(k5["bitwise"].values())
          and k5["neighbours"] and k5["exact"])
    print(f"[{tag}] K5 over the adapter set on {gpu_line()}: {k5['leaves']} tensors, "
          f"{k5['elements']} elements in {k5['launches']} launch, u "
          f"{sorted(str(d) for d in k5['u_dtypes'])}; bitwise to the plain rounding on "
          f"{k5['bitwise']}, neighbours {k5['neighbours']}, exact {k5['exact']}; device "
          f"{k5['device_ms']:.4f} ms ({capture.calls[0]['timed_by']}), least time "
          f"{bound[0]:.4f} ms ({bound[1]}; {100 * bound[0] / k5['device_ms']:.1f}% of it), "
          f"wrapper host time {k5['wrapper_host_ms']:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: K5 over the adapter set failed its checks")
    return dict(ms=k5["device_ms"], bound_ms=bound[0], bound_by=bound[1],
                max_abs_err=k5["max_err"], host_ms=k5["wrapper_host_ms"],
                leaves=k5["leaves"], elements=k5["elements"])


def phase_sdxl_dora(torch, model) -> dict:
    """sdxl_dora: DoRA r16 a16 on the qlora phase's NF4 UNet (its 794
    layers), bf16 adapters and magnitudes, rank dropout DORA_DROPOUT,
    AdamW 1e-4 with stochastic rounding, clip 1.0, batch 2 at 1024,
    tx_only: the setup (each magnitude the norm of its K4-decoded weight:
    one K4 per NF4 layer), one warm-up and TRAIN_STEPS timed steps with
    exact launches (K1 140, K2, K3 and the pre-pass 70, K4 once per NF4
    layer and again per layer in the recomputed blocks, K5 1), one step's
    K5 call over the adapter set captured, a profiler split; then the kohya
    file written and read back bitwise, and the adapters merged into the
    NF4 base (K4 once per layer, bf16 weights) after lora_up is given
    seeded values of MERGE_UP_STD: each merged weight against its
    layer's in-layer bf16 weight bitwise, one UNet forward merged against
    in-layer, against the adapters' own effect on it (in-layer against
    the bare base)."""
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors, save_safetensors
    from onetrainer_tpu_torch.models.layers import weight_in
    from onetrainer_tpu_torch.peft.layers import adapter_of
    from onetrainer_tpu_torch.peft.lora import (
        attach_peft, kohya_state_dict_to_peft, merge_peft_into_base, peft_module_keys,
        peft_to_kohya_state_dict,
    )
    from onetrainer_tpu_torch.util.enums import DataType
    config = _peft_config(2, lora_decompose=True, dropout_probability=DORA_DROPOUT)
    config.unet.weight_dtype = DataType.NFLOAT_4
    # the qlora phase left the base in NF4: each magnitude is a K4 decode
    quantized_before, _ = _quantized_layers(torch, model.unet)
    init = {}
    _reset_launch_counts()
    run = _setup_and_steps(torch, model, config, "sdxl_dora",
                           after_batch=lambda setup: init.update(_launch_counts()))
    setup, batch, gen = run["setup"], run["batch"], run["gen"]
    n_quant, n_in_blocks = _quantized_layers(torch, model.unet)
    rank_dropout = setup.train_step.rank_dropout
    adapters = setup.state.params["unet_lora"]
    per_pass = sum(SDXL_SELF_ATTN.values())
    n = TRAIN_STEPS * per_pass
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n,
                "K4": TRAIN_STEPS * (n_quant + n_in_blocks), "K5": TRAIN_STEPS}
    leaves = {name for e in adapters.values() for name in e}
    k5 = _k5_over_the_adapters(torch, setup, batch, gen, "sdxl_dora")
    profile_train_step(torch, setup, batch, gen, "sdxl_dora")

    # the kohya file out and in
    path = os.path.join(tempfile.mkdtemp(prefix="sdxl_dora_"), "dora.safetensors")
    save_safetensors(path, {k: v.cpu() for k, v in peft_to_kohya_state_dict(
        adapters, setup.peft_cfg, "lora_unet").items()})
    read, alpha = kohya_state_dict_to_peft(load_safetensors(path), "lora_unet",
                                           peft_module_keys(model.unet, setup.peft_cfg))
    kohya_bitwise = alpha == config.lora_alpha and set(read) == set(adapters) and all(
        set(read[k]) == set(e) and all(torch.equal(read[k][n].cuda(), t) for n, t in e.items())
        for k, e in adapters.items())
    os.remove(path)
    os.rmdir(os.path.dirname(path))

    # lora_up at a trained adapter's size; one UNet forward through the
    # layers, through the bare base, then through the merged base
    # (phase_unet's inputs)
    gen_up = torch.Generator(device="cuda").manual_seed(11)
    with torch.no_grad():
        for entry in adapters.values():
            up = entry["lora_up"]
            up.copy_(MERGE_UP_STD * torch.randn(up.shape, generator=gen_up, device="cuda"))
    gen_in = torch.Generator(device="cuda").manual_seed(7)
    args = (torch.randn((2, 128, 128, 4), generator=gen_in, device="cuda"),
            torch.full((2,), 500, dtype=torch.int32, device="cuda"),
            torch.randn((2, 77, 2048), generator=gen_in, device="cuda"),
            torch.randn((2, 1280), generator=gen_in, device="cuda"),
            torch.tensor([[1024, 1024, 0, 0, 1024, 1024]] * 2, dtype=torch.float32,
                         device="cuda"))
    with torch.inference_mode():
        in_layer = model.unet(*args)
        in_layer_weights = {name: weight_in(layer, torch.bfloat16)
                            for name, layer in model.unet.named_modules()
                            if adapter_of(layer) is not None}
    attach_peft(model.unet, None, None)
    with torch.inference_mode():
        effect = _rel_l2(in_layer, model.unet(*args))
    _reset_launch_counts()
    detached = {k: {n: t.detach() for n, t in e.items()} for k, e in adapters.items()}
    merge_peft_into_base(model.unet, detached, setup.peft_cfg)
    merge_launches = _launch_counts()
    layers = dict(model.unet.named_modules())
    weights_bitwise = len(in_layer_weights) == len(adapters) and all(
        torch.equal(w, layers[name].weight) for name, w in in_layer_weights.items())
    del in_layer_weights
    with torch.inference_mode():
        merged = model.unet(*args)
    rel = _rel_l2(merged, in_layer)
    bf16_base = all(p.dtype == torch.bfloat16 for p in model.unet.parameters())
    checks = {
        "finite": run["finite"] and bool(torch.isfinite(merged).all()),
        "up moved": run["up_max"] > 0,
        "DoRA leaves": leaves == {"lora_down", "lora_up", "dora_scale"},
        "rank dropout in the step": rank_dropout is not None and rank_dropout.p == DORA_DROPOUT,
        "K4 once per NF4 layer at init": init["K4"] == quantized_before == n_quant,
        "launches per step": run["launches"] == expected,
        "kohya round trip bitwise": kohya_bitwise,
        "merge decodes each NF4 layer once": merge_launches["K4"] == n_quant,
        "merged base bf16": bf16_base,
        "merged weights equal the in-layer bf16 weights": weights_bitwise,
        "merged forward against in-layer": rel <= MERGED_REL_L2_BOUND,
        "adapters move the output far more": effect >= MERGE_EFFECT_RATIO * rel,
    }
    print(f"[sdxl_dora] {len(adapters)} DoRA layers over {n_quant} NF4 layers ({n_in_blocks} in "
          f"the recomputed blocks); K4 at init {init['K4']}, per step "
          f"{run['launches']['K4'] // TRAIN_STEPS} (QLoRA's {n_quant + n_in_blocks}), at the "
          f"merge {merge_launches['K4']}; launches {run['launches']} (expected {expected}); "
          f"merged forward against in-layer rel L2 {rel:.3e} (bound "
          f"{MERGED_REL_L2_BOUND:g}), in-layer against the bare base {effect:.3e} (lora_up "
          f"std {MERGE_UP_STD:g}; at least {MERGE_EFFECT_RATIO:g}x the gap); checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sdxl_dora failed: {[k for k, ok in checks.items() if not ok]}")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"], "k5": k5, "k4_init": init["K4"],
            "k4_merge": merge_launches["K4"]}


def phase_sdxl_loha(torch, model) -> dict:
    """sdxl_loha: LoHa r16 a16 on the fp8 phase's UNet (794 layers, the
    3x3 convs' deltas full 3x3 kernels), bf16 factors, AdamW 1e-4 with
    stochastic rounding, clip 1.0, batch 2 at 1024, tx_only: one warm-up
    and TRAIN_STEPS timed steps with exact launches (K1 140, K2, K3 and
    the pre-pass 70, K4 0, K5 1), one step's K5 call over the factor set
    captured, a profiler split; peak memory and seconds per step."""
    from onetrainer_tpu_torch.util.enums import PeftType
    config = _peft_config(2, peft_type=PeftType.LOHA)
    run = _setup_and_steps(torch, model, config, "sdxl_loha")
    setup, batch, gen = run["setup"], run["batch"], run["gen"]
    adapters = setup.state.params["unet_lora"]
    n = TRAIN_STEPS * sum(SDXL_SELF_ATTN.values())
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n, "K4": 0, "K5": TRAIN_STEPS}
    k5 = _k5_over_the_adapters(torch, setup, batch, gen, "sdxl_loha")
    profile_train_step(torch, setup, batch, gen, "sdxl_loha")
    convs = sum(e["hada_w1_b"].dim() == 4 for e in adapters.values())
    checks = {"finite": run["finite"], "w2a moved": run["up_max"] > 0,
              "launches per step": run["launches"] == expected,
              "LoHa on 3x3 convs": convs > 0 and len(adapters) == 794}
    print(f"[sdxl_loha] {len(adapters)} LoHa layers ({convs} convs); sec/step "
          f"{run['sec_per_step']:.4f}, peak {run['peak_gib']:.2f} GiB; launches "
          f"{run['launches']} (expected {expected}); checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sdxl_loha failed: {[k for k, ok in checks.items() if not ok]}")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"], "k5": k5}


def phase_sdxl_inpaint(torch, root: str) -> dict:
    """The SDXL inpainting UNet (9 input channels) at its published widths,
    fp32 with bf16 compute: the LoRA step of phase 6 on a batch with the
    conditioning latent and the mask beside the latents (TRAIN_STEPS timed steps,
    the same launches per step as phase 6), then inpainting at 1024x1024
    (4 DDIM steps, CFG 7) from a seeded base image and mask at 896x1152:
    K1 70 per step, the UNet's input 9 channels wide."""
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import ModelType
    config = _lora_config(2, ModelType.STABLE_DIFFUSION_XL_10_BASE_INPAINTING)
    model = build_model(torch, None, config.model_type)
    family = get_family(config.model_type)
    widths = []
    hook = model.unet.register_forward_pre_hook(
        lambda module, args: widths.append(args[0].shape[-1]))
    try:
        inputs = inpaint_inputs(torch, root, 896, 1152)
        launches = phase_sample(torch, model, 1024, SDXL_SELF_ATTN, "sdxl_inpaint_sample",
                                inpaint=inputs)
        run = _setup_and_steps(
            torch, model, config, "sdxl_inpaint", 1024,
            make_batch=lambda setup: _inpaint_batch(torch, family, setup, 2, 1024))
    finally:
        hook.remove()
    n = TRAIN_STEPS * sum(SDXL_SELF_ATTN.values())
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n, "K4": 0, "K5": 0}
    ok = (run["finite"] and run["up_max"] > 0 and run["launches"] == expected
          and set(widths) == {9} and model.unet.conv_in.weight.shape[1] == 9)
    print(f"[sdxl_inpaint] UNet input widths {sorted(set(widths))}; launches "
          f"{run['launches']} (expected {expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sdxl_inpaint failed its checks")
    return {"launches": run["launches"], "sample_launches": launches,
            "sec_per_step": run["sec_per_step"], "peak_gib": run["peak_gib"]}


# the port's kernels live in an anonymous namespace: PyTorch's own flash
# kernels (pytorch_flash::flash_fwd_kernel) must not count as K1
_PORT = "(anonymous namespace)::"
_PROFILE_CLASSES = (
    ("K1 flash_fwd", (_PORT + "flash_fwd_kernel",)),
    ("K2 flash_bwd_dq", (_PORT + "flash_bwd_dq_kernel",)),
    ("K3 flash_bwd_dkv", (_PORT + "flash_bwd_dkv_kernel",)),
    ("K3 flash_bwd_dkv pre-pass (delta)", (_PORT + "flash_bwd_delta_kernel",)),
    ("K4 nf4_dequant", (_PORT + "nf4_dequant_kernel",)),
    ("K5 sr_update", (_PORT + "sr_update_kernel",)),
    # scaled_dot_product_attention (cross-attention, short sequences): its
    # cuDNN, flash and memory-efficient backends
    ("SDPA (library attention)", ("_sdpa_", "pytorch_flash::", "fmha")),
    ("cuBLAS GEMMs", ("gemm", "Gemm", "nvjet", "sm90_xmma", "cutlass", "ampere_",
                      "sm80_")),
    ("cuDNN convolutions", ("conv", "Conv", "cudnn", "nchwToNhwc", "nhwcToNchw",
                            "implicit_", "dgrad", "wgrad")),
    ("norms", ("norm", "Norm", "welford", "Welford")),
    # "copy" only: "cast" would also match gpu_kernel_impl_nocast, the
    # launcher of every plain elementwise kernel
    ("dtype copies/casts", ("copy", "Copy")),
    ("optimizer (foreach)", ("multi_tensor", "foreach", "Foreach")),
    ("reductions", ("reduce", "Reduce")),
)


def _classify(name: str) -> str:
    for label, keys in _PROFILE_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other elementwise"


def _kernel_times(prof) -> tuple[dict, dict, list]:
    """({class: device ms}, {class: launches}, [(ms, launches, class, name)])
    over the CUDA kernels a finished torch.profiler run recorded."""
    from torch.autograd import DeviceType
    sums: dict = {}
    counts: dict = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue   # kernels only: an op's row repeats its kernels' time
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if not dev_us:
            continue
        label = _classify(evt.key)
        sums[label] = sums.get(label, 0.0) + dev_us / 1e3
        counts[label] = counts.get(label, 0) + evt.count
        kernels.append((dev_us / 1e3, evt.count, label, evt.key))
    return sums, counts, kernels


def profile_train_step(torch, setup, batch, gen, tag: str):
    """torch.profiler over one training step (after the timed ones): the
    device time per kernel class and the device's busy share of the step's
    host time. It records the device's activity only: the host's op events
    add nothing the split reads, and on an SDXL step (29,198 kernels)
    gathering them took 28.9 s against 7.4 s."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        setup.train_step(setup.state, batch, gen)["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sums, counts, kernels = _kernel_times(prof)
    total = sum(sums.values())
    print(f"[profile] one {tag} step under torch.profiler: host {wall_ms:.3f} ms, "
          f"device time {total:.3f} ms in {sum(counts.values())} launches "
          f"({100 * total / wall_ms:.1f}% busy)")
    for label, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: {ms:.3f} ms in {counts[label]} launches "
              f"({100 * ms / total:.1f}%)")
    for ms, count, label, key in sorted(kernels, reverse=True)[:15]:
        print(f"[profile] kernel {ms:.3f} ms in {count} launches [{label}]: {key[:110]}")
    if total == 0:
        raise AssertionError("the profiler saw no device time")


# SD 1.5 LoRA through the CLI (phase sd15_cli): its UNet's adapted layers,
# the images of its dataset, the captions' template
SD15_LORA_LAYERS = 282
CLI_IMAGES = 8
CLI_SIZE = 512
# the PNGs' size (h, w): not a bucket's, so the loader resizes every image
CLI_PNG_SIZE = (600, 560)
CLI_CAPTION = "a photograph of an astronaut riding a horse, number {}"


def _cli_config(root: str, ckpt: str, dataset: str):
    """The sd15_cli phase's config: bench.py's SD 1.5 stage (LoRA r16 a16,
    batch 4 at 512x512, AdamW 1e-4, clip 1.0, text encoder frozen and its
    states cached) read from files, one epoch with a backup before the
    final save, no gradient checkpointing (one K1 per self-attention)."""
    from onetrainer_tpu_torch.config.concept_config import ConceptConfig
    from onetrainer_tpu_torch.util.enums import (
        GradientCheckpointingMethod, ModelType, TimeUnit,
    )
    config = _lora_config(4, ModelType.STABLE_DIFFUSION_15)
    config.base_model_name = ckpt
    config.resolution = str(CLI_SIZE)
    config.epochs = 1
    config.workspace_dir = os.path.join(root, "workspace")
    config.cache_dir = os.path.join(root, "cache")
    config.output_model_destination = os.path.join(root, "lora.safetensors")
    config.gradient_checkpointing = GradientCheckpointingMethod.OFF
    config.aspect_ratio_bucketing = False
    config.latent_caching = True
    config.tensorboard = False
    config.backup_before_save = True
    config.backup_after_unit = TimeUnit.NEVER
    config.save_every_unit = TimeUnit.NEVER
    config.sample_after_unit = TimeUnit.NEVER
    concept = ConceptConfig.default_values()
    concept.path = dataset
    config.concepts = [concept]
    config.samples = []
    return config


def _cli_run(torch, config_path: str, events: list, profiled_step=None):
    """The train CLI in this process, recording (kind, what, launch counts,
    time) at each status and after each step (synchronized); with
    `profiled_step`, torch.profiler records that step alone."""
    from torch.profiler import ProfilerActivity, profile

    from onetrainer_tpu_torch.scripts import train
    from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled_step is not None else None

    def on_status(status):
        events.append(("status", status, _launch_counts(), time.perf_counter()))

    def on_progress(progress, max_sample, max_epoch):
        torch.cuda.synchronize()
        if prof is not None and progress.global_step == profiled_step - 1:
            prof.__enter__()   # before the stamp: the step's time leaves it out
        events.append(("step", progress.global_step, _launch_counts(), time.perf_counter()))
        if prof is not None and progress.global_step == profiled_step:
            prof.__exit__(None, None, None)

    trainer = train.main(["--config-path", config_path],
                         TrainCallbacks(on_update_status=on_status,
                                        on_update_train_progress=on_progress))
    return trainer, prof


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _cli_timeline(*runs) -> tuple[list, list, dict]:
    """From `_cli_run`'s events of each run: [(global step, launches, s)]
    per step, the launches while each epoch cached, and {"load_s",
    "cache_s"} per run."""
    steps, cache_launches, times = [], [], {}
    for events in runs:
        marks = {what: (counts, t) for kind, what, counts, t in events if kind == "status"}
        for kind, what, counts, t in events:
            if kind == "status" and what.endswith(": caching"):
                epoch = what.split()[1].rstrip(":")
                done = marks[f"training epoch {epoch}"]
                cache_launches.append(_delta(done[0], counts))
                times.setdefault("cache_s", []).append(done[1] - t)
        load = marks["loading the model"][1]
        times.setdefault("load_s", []).append(marks["creating the data loader"][1] - load)
        prev = None
        for kind, what, counts, t in events:
            if kind == "status" and what.startswith("training epoch"):
                prev = (counts, t)
            elif kind == "step":
                steps.append((what, _delta(counts, prev[0]), t - prev[1]))
                prev = (counts, t)
    return steps, cache_launches, times


def sd15_files(torch, root: str) -> dict:
    """The files the CLI phases read, in `root`: a seeded full-width SD 1.5
    written as one ldm-keyed fp16 single file, and CLI_IMAGES PNGs at
    CLI_PNG_SIZE (the loader scales them to the bucket's scale, bilinear in
    numpy, and crops) with captions, grayscale `-masklabel.png` masks and,
    for the first image, a `-condlabel.png` conditioning image (read only
    where the config asks for custom conditioning images)."""
    from onetrainer_tpu_torch.io.png import write_png
    from onetrainer_tpu_torch.io.sd_checkpoints import save_sd_single_file, state_dict_of
    from onetrainer_tpu_torch.util.enums import ModelType

    model = build_model(torch, None, ModelType.STABLE_DIFFUSION_15)
    ckpt = os.path.join(root, "sd15.safetensors")
    t0 = time.perf_counter()
    save_sd_single_file(ckpt, model, *(state_dict_of(m) for m in
                                       (model.unet, model.vae, model.text_encoder)),
                        save_dtype=torch.float16)
    write_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dataset = os.path.join(root, "dataset")
    os.makedirs(dataset)
    gen = torch.Generator(device="cuda").manual_seed(13)
    h, w = CLI_PNG_SIZE
    for i in range(CLI_IMAGES):
        pixels = (torch.rand((h, w, 3), generator=gen, device="cuda") * 255).byte()
        write_png(os.path.join(dataset, f"{i:02d}.png"), pixels.cpu().numpy())
        # a bright square of the subject over a dim, noisy surround
        mask = (torch.rand((h, w), generator=gen, device="cuda") * 64).byte()
        lo, hi = h // 8 * (1 + i % 3), h // 8 * (5 + i % 3)
        mask[lo:hi, lo:hi] = 255
        write_png(os.path.join(dataset, f"{i:02d}-masklabel.png"), mask.cpu().numpy())
        if i == 0:
            cond = (torch.rand((h, w, 3), generator=gen, device="cuda") * 255).byte()
            write_png(os.path.join(dataset, f"{i:02d}-condlabel.png"), cond.cpu().numpy())
        with open(os.path.join(dataset, f"{i:02d}.txt"), "w") as f:
            f.write(CLI_CAPTION.format(i))
    print(f"[sd15_files] wrote {ckpt} ({os.path.getsize(ckpt) / 2 ** 30:.3f} GiB, fp16, "
          f"ldm keys) in {write_s:.2f} s, {CLI_IMAGES} PNGs {h}x{w} with their captions "
          f"and grayscale masks, one conditioning image")
    return {"ckpt": ckpt, "dataset": dataset}


def phase_sd15_cli(torch, bare_step_s, files: dict) -> dict:
    """Phase 13 (see the module docstring). `bare_step_s`: the sd15_train
    phase's median seconds per step in this run, or None; `files`: the
    checkpoint and dataset of `sd15_files`."""
    from onetrainer_tpu_torch.io.png import read_png
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    from onetrainer_tpu_torch.peft.lora import kohya_state_dict_to_peft, peft_module_keys
    from onetrainer_tpu_torch.scripts import sample

    root = os.path.join(os.path.dirname(files["ckpt"]), "lora")
    os.makedirs(root)
    ckpt = files["ckpt"]
    config = _cli_config(root, ckpt, files["dataset"])
    config_path = os.path.join(root, "epoch1.json")
    with open(config_path, "w") as f:
        json.dump(config.to_dict(), f)
    config.epochs = 2
    config.continue_last_backup = True
    resume_path = os.path.join(root, "epoch2.json")
    with open(resume_path, "w") as f:
        json.dump(config.to_dict(), f)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    events1, events2 = [], []
    first, _ = _cli_run(torch, config_path, events1)
    step_after_first = first.train_progress.global_step
    loss_first = first._loss_ema
    del first
    gc.collect()
    torch.cuda.empty_cache()
    resumed, prof = _cli_run(torch, resume_path, events2, profiled_step=4)
    before_sample = _launch_counts()
    image_path = os.path.join(root, "sample.png")
    t0 = time.perf_counter()
    out = sample.main(["--model-type", "STABLE_DIFFUSION_15", "--base-model-name", ckpt,
                       "--prompt", "a photograph of an astronaut riding a horse",
                       "--destination", image_path, "--steps", "4", "--cfg", "7",
                       "--width", str(CLI_SIZE), "--height", str(CLI_SIZE),
                       "--scheduler", "DDIM"])
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # launches: none while caching, exactly one per self-attention per step
    per_step = {"K1": 5, "K2": 5, "K3": 5, "K3pre": 5, "K4": 0, "K5": 0}
    none = {k: 0 for k in per_step}
    steps, cache_launches, times = _cli_timeline(events1, events2)
    sample_launches = _delta(launches, before_sample)
    step_s = [s for global_step, _, s in steps if global_step != 4]   # 4: profiled
    sums, _, _ = _kernel_times(prof)
    device_ms = sum(sums.values())
    profiled_ms = steps[-1][2] * 1e3

    # the cache: a latent and a text state per image
    cache_files = [os.path.join(config.cache_dir, f) for f in os.listdir(config.cache_dir)]
    rows = [load_safetensors(f) for f in cache_files]
    cached = (len(rows) == CLI_IMAGES
              and all({"latent_image", "text_encoder_hidden_state"} <= set(r) for r in rows)
              and all(r["latent_image"].shape == (CLI_SIZE // 8, CLI_SIZE // 8, 4)
                      and r["text_encoder_hidden_state"].shape == (77, 768) for r in rows))

    # the LoRA file reads back to the trained adapters bit for bit
    lora = load_safetensors(config.output_model_destination)
    adapters = resumed.setup.state.params["unet_lora"]
    keys = peft_module_keys(resumed.model.unet, resumed.setup.peft_cfg)
    read, alpha = kohya_state_dict_to_peft(lora, "lora_unet", keys)
    bitwise = (set(read) == set(adapters) and alpha == resumed.setup.peft_cfg.alpha
               and all(torch.equal(read[k][n], t.detach().cpu())
                       for k, e in adapters.items() for n, t in e.items()))
    with torch.no_grad():
        for key, entry in adapters.items():
            for name, t in entry.items():
                t.copy_(read[key][name])
        loader = resumed.data_loader
        batch = loader.materialize_batch(loader.batches_for_epoch(0)[0])
        gen = torch.Generator(device="cuda").manual_seed(3)
        reload_loss = resumed.setup.train_step.loss(batch, gen).item()
    image = read_png(image_path)

    checks = {
        "launches per step": all(d == per_step for _, d, _ in steps) and len(steps) == 4,
        "none while caching": all(c == none for c in cache_launches)
        and len(cache_launches) == 2,
        "K1 over the sample": sample_launches == {**none, "K1": 20},
        "main-path launches": launches == {
            k: 4 * v + sample_launches[k] for k, v in per_step.items()},
        "global steps": (step_after_first, resumed.train_progress.global_step) == (2, 4),
        "cache": cached,
        "LoRA keys": len(adapters) == SD15_LORA_LAYERS
        and len(lora) == 3 * SD15_LORA_LAYERS,
        "LoRA read back bitwise": bitwise,
        "finite losses": _finite([loss_first, resumed._loss_ema, reload_loss]),
        "image": image.shape == (CLI_SIZE, CLI_SIZE, 3) and image.std() > 0
        and bool((image == out.image).all()),
    }
    bare = f"{bare_step_s:.4f} s" if bare_step_s is not None else "not measured"
    card = gpu_line()
    print(f"[sd15_cli] statuses {[w for k, w, _, _ in events1 if k == 'status']} then "
          f"{[w for k, w, _, _ in events2 if k == 'status']}")
    print(f"[sd15_cli] on {card}: load {', '.join(f'{x:.2f}' for x in times['load_s'])} s "
          f"(single file to the card, run 1 and the resume); caching "
          f"{times['cache_s'][0]:.3f} s for {CLI_IMAGES} images "
          f"({times['cache_s'][0] / CLI_IMAGES:.4f} s per image; the resume "
          f"{times['cache_s'][1]:.3f} s, all cached)")
    print(f"[sd15_cli] on {card}: steps (global step, s): "
          f"{', '.join(f'{g}: {s:.4f}' for g, _, s in steps)}; CLI step median "
          f"{statistics.median(step_s):.4f} s over the unprofiled steps "
          f"(the first includes the warm-up) beside sd15_train's median {bare}; "
          f"step 4 under torch.profiler: host {profiled_ms:.3f} ms, device "
          f"{device_ms:.3f} ms ({100 * device_ms / profiled_ms:.1f}% busy)")
    print(f"[sd15_cli] on {card}: sample (load + 4 DDIM steps + decode + PNG) "
          f"{sample_s:.2f} s; "
          f"peak max_memory_allocated {peak_gib:.2f} GiB; launches {launches} "
          f"(sample {sample_launches}); LoRA file {len(lora)} keys, reload loss "
          f"{reload_loss:.6f}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sd15_cli failed: "
                             f"{[name for name, ok in checks.items() if not ok]}")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    dora = _sd15_dora_cli(torch, files)
    from onetrainer_tpu_torch.util.enums import ModelType
    # EMBEDDING: the first self-attention's q, k and v do not depend on the text
    embedding = _embedding_cli(
        torch, "sd15_cli", ckpt, files["dataset"], ModelType.STABLE_DIFFUSION_15, CLI_SIZE,
        {"K1": 5, "K2": 4, "K3": 4, "K3pre": 4, "K4": 0, "K5": 0},
        {"emp_params", "output_emp_params"}, resume=True,
        sample_argv=["--cfg", "7", "--scheduler", "DDIM"], sample_k1=20)
    additional = _sd15_additional_embedding_cli(torch, files)
    return {"launches": {k: launches[k] + dora[k] for k in launches},
            "embedding_launches": embedding, "additional_embedding_launches": additional,
            "step_s": statistics.median(step_s), "peak_gib": peak_gib}


def _sd15_dora_cli(torch, files: dict) -> dict:
    """DoRA r16 a16 through the train command on sd15_cli's files (one
    epoch, its kohya file with `dora_scale`), then a second run continuing
    from that file (`lora_model_name`): after its start the adapters equal
    the file's bit for bit (fp32 here), it trains one epoch with exactly
    sd15_cli's launches per step and writes its own file. -> the launches
    of both runs."""
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    from onetrainer_tpu_torch.peft.lora import kohya_state_dict_to_peft, peft_module_keys
    from onetrainer_tpu_torch.util.create import create_trainer
    root = os.path.join(os.path.dirname(files["ckpt"]), "dora")
    os.makedirs(root)
    config = _cli_config(root, files["ckpt"], files["dataset"])
    config.lora_decompose = True
    config.backup_before_save = False
    config.output_model_destination = os.path.join(root, "dora.safetensors")
    path = os.path.join(root, "dora.json")
    with open(path, "w") as f:
        json.dump(config.to_dict(), f)
    _reset_launch_counts()
    events = []
    t0 = time.perf_counter()
    first, _ = _cli_run(torch, path, events)
    first_s = time.perf_counter() - t0
    del first
    gc.collect()
    torch.cuda.empty_cache()
    written = load_safetensors(config.output_model_destination)

    config.lora_model_name = config.output_model_destination
    config.output_model_destination = os.path.join(root, "dora_continued.safetensors")
    config.workspace_dir = os.path.join(root, "workspace_continued")
    config.lora_rank, config.lora_alpha = 4, 1.0     # the file's r16 a16 are adopted
    trainer = create_trainer(config, device="cuda")
    t0 = time.perf_counter()
    trainer.start()
    cfg = trainer.setup.peft_cfg
    adapters = trainer.setup.state.params["unet_lora"]
    read, alpha = kohya_state_dict_to_peft(written, "lora_unet",
                                           peft_module_keys(trainer.model.unet, cfg))
    loaded_bitwise = (set(read) == set(adapters) and alpha == 16.0
                      and (cfg.rank, cfg.alpha) == (16, 16.0) and all(
                          set(read[k]) == set(e) == {"lora_down", "lora_up", "dora_scale"}
                          and all(t.dtype == torch.float32
                                  and torch.equal(read[k][n].to("cuda", t.dtype), t)
                                  for n, t in e.items())
                          for k, e in adapters.items()))
    trainer.train()
    trainer.end()
    second_s = time.perf_counter() - t0
    launches = _launch_counts()
    continued = load_safetensors(config.output_model_destination)
    del trainer, adapters
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {"K1": 5, "K2": 5, "K3": 5, "K3pre": 5, "K4": 0, "K5": 0}
    checks = {
        "DoRA file": sum(k.endswith(".dora_scale") for k in written) == SD15_LORA_LAYERS
        and len(written) == 4 * SD15_LORA_LAYERS,
        "loaded bitwise at the file's rank and alpha": loaded_bitwise,
        "continued file": set(continued) == set(written)
        and any(not torch.equal(continued[k], written[k]) for k in written),
        "launches": launches == {k: 4 * v for k, v in per_step.items()},
    }
    print(f"[sd15_cli] DoRA through the train command: {first_s:.2f} s, its file "
          f"{len(written)} keys; continued from it (lora_model_name) {second_s:.2f} s; "
          f"launches of both runs {launches}; checks {checks}")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    if not all(checks.values()):
        raise AssertionError(f"sd15_cli DoRA failed: {[k for k, ok in checks.items() if not ok]}")
    return launches


# the SDXL fine-tune (phase sdxl_ft): the UNet's tensors and elements (a
# bf16 UNet built on "meta" counts them), the named leaves K5 is held to
# bit for bit, and the plain rounding's bound of a leaf
SDXL_UNET_TENSORS = 1680
SDXL_UNET_ELEMENTS = 2_567_463_684
SDXL_LARGEST_LEAF = 29_491_200         # a 1280 -> 2560 3x3 conv of the up blocks


def _fine_tune_config(model_type, batch_size: int):
    """FINE_TUNE of the UNet, text encoders frozen (their states cached)."""
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.util.enums import TrainingMethod
    config = TrainConfig.default_values()
    config.model_type = model_type
    config.training_method = TrainingMethod.FINE_TUNE
    config.batch_size = batch_size
    config.learning_rate = 1e-5
    config.learning_rate_warmup_steps = 0.0
    config.clip_grad_norm = 1.0
    config.text_encoder.train = False
    config.text_encoder_2.train = False
    return config


def _queued_ms(torch, fn, reps: int) -> float:
    """Device time per call of `fn` from CUDA events around `reps` calls
    queued behind a first one: each call's host work runs while the one
    before it runs on the card, so the events span only device time when a
    call's kernel outlasts its wrapper's host time (K5 over a chunk of an
    update: milliseconds each)."""
    fn()
    torch.cuda.synchronize()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _k5_device_ms(torch, fn, reps: int, bound_ms: float) -> tuple[float, str]:
    """(K5's device time per launch of `fn`, its source): the profiler's,
    or queued CUDA events' when the profiler's sessions see no launch of K5
    or give a time below `bound_ms`, the least time the launch can take
    (late in the whole script they have dropped every K5 record, and once
    gave 6.32 ms for a launch whose bytes need 7.69)."""
    try:
        ms = _device_ms(torch, fn, "sr_update_kernel", reps=reps, min_seen=0.1)
        if ms >= bound_ms:
            return ms, "profiler"
        print(f"[profile] {ms:.4f} ms from the profiler, below the least time "
              f"{bound_ms:.4f} ms: CUDA events around {reps} queued calls instead")
    except AssertionError as e:
        print(f"[profile] {e}: CUDA events around {reps} queued calls instead")
    return _queued_ms(torch, fn, reps), "events"


class _K5Capture:
    """Wraps the stochastic-rounding update of one step, K5 call by K5 call
    (one per chunk of the update): counts the updates that came in other
    strides than their parameter's (the layout copies
    apply_updates_stochastic makes); for each call its leaves, elements, u
    dtypes and host time, every output checked at once against the two
    bf16 neighbours of p + u (and p + u itself where it is a bf16 value);
    the named leaves' inputs and outputs kept (the largest, the first 1-D,
    2-D and 4-D ones); with `time_reps`, the call run again on a copy of
    its inputs: its device time per launch from the profiler and the
    wrapper's host time per call. Only one chunk's copies exist at a time
    (FLUX's whole update is 22 GiB of bf16)."""

    def __init__(self, torch, time_reps: int = 0):
        from onetrainer_tpu_torch.ops import sr_update
        from onetrainer_tpu_torch.train import sd_train_step
        self.torch, self.sr_update, self.step_module = torch, sr_update, sd_train_step
        self.real_apply = sd_train_step.apply_updates_stochastic
        self.real_leaves = sr_update.sr_update_leaves
        self.time_reps = time_reps
        self.layout_copies, self.calls, self.named = 0, [], {}
        self.neighbours = self.exact = True

    def apply(self, params, updates, *args, **kwargs):
        self.layout_copies += sum(not u.is_contiguous() for u in updates)
        return self.real_apply(params, updates, *args, **kwargs)

    def _keep(self, name, p, u, out, seed) -> None:
        self.named[name] = dict(before=p.clone(), u=u.clone(), out=out.clone(),
                                seed=seed.clone())

    def leaves(self, ps, us, seeds, *, seed_index=None, outs=None):
        torch = self.torch
        before = [p.detach().clone() for p in ps]
        t0 = time.perf_counter()
        result = self.real_leaves(ps, us, seeds, seed_index=seed_index, outs=outs)
        host_ms = (time.perf_counter() - t0) * 1e3
        for i, (p, u, out) in enumerate(zip(before, us, result)):
            s = p.float() + u.float()
            low, high = _bf16_neighbours(torch, s)
            got = out.float().view(torch.int32)
            self.neighbours = self.neighbours and bool(((got == low) | (got == high)).all())
            representable = (s.view(torch.int32) & 0xFFFF) == 0
            self.exact = self.exact and bool((got[representable] == low[representable]).all())
            seed = seeds[seed_index[i]:seed_index[i] + 1]
            largest = self.named.get("largest")
            if largest is None or p.numel() > largest["before"].numel():
                self._keep("largest", p, u, out, seed)
            name = {1: "1-D", 2: "2-D", 4: "4-D conv"}.get(p.dim())
            if name and name not in self.named:
                self._keep(name, p, u, out, seed)
        call = dict(leaves=len(ps), elements=sum(p.numel() for p in ps),
                    u_dtypes={u.dtype for u in us}, host_ms=host_ms)
        if self.time_reps:
            def again():
                self.real_leaves(before, us, seeds, seed_index=seed_index, outs=before)
            nbytes = sum((8 if u.dtype == torch.float32 else 6) * u.numel() for u in us)
            call["device_ms"], call["timed_by"] = _k5_device_ms(
                torch, again, self.time_reps, _bound_ms(0.0, nbytes)[0])
            host = []
            for _ in range(self.time_reps):
                t0 = time.perf_counter()
                again()
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            call["wrapper_host_ms"] = statistics.median(host)
        del before
        self.calls.append(call)
        return result

    def __enter__(self):
        def leaves(*args, **kwargs):
            return self.leaves(*args, **kwargs)
        # the wrapper counts the launches made under its name meanwhile
        leaves.launches = self.real_leaves.launches
        self.step_module.apply_updates_stochastic = self.apply
        self.sr_update.sr_update_leaves = leaves
        return self

    def __exit__(self, *exc):
        self.real_leaves.launches = self.sr_update.sr_update_leaves.launches
        self.step_module.apply_updates_stochastic = self.real_apply
        self.sr_update.sr_update_leaves = self.real_leaves


def _k5_on_the_update(torch, capture: _K5Capture) -> dict:
    """K5's outputs of one fine-tune update against the plain rounding: bit
    for bit on the Philox bits of the named leaves (the largest, the first
    1-D and 2-D ones and, in a model that has them, a 4-D conv leaf); on
    every leaf, each output one of the two bf16 neighbours of the fp32 sum
    p + u, and p + u itself where it is a bf16 value (checked as each K5
    call ran). -> the checks, the largest leaf's size and the update's
    totals over its calls."""
    from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16
    bitwise, max_err = {}, 0.0
    for name, leaf in capture.named.items():
        p, u, out = leaf["before"], leaf["u"], leaf["out"]
        bits = philox_bits(leaf["seed"], p.numel(), p.device).view(p.shape)
        ref = stochastic_round_to_bf16(p.float() + u.float(), bits)
        bitwise[f"{name} {tuple(p.shape)}"] = bool(
            torch.equal(out.view(torch.int16), ref.view(torch.int16)))
        max_err = max(max_err, (out.float() - ref.float()).abs().max().item())
        del bits, ref
    calls = capture.calls
    return dict(bitwise=bitwise, neighbours=capture.neighbours, exact=capture.exact,
                max_err=max_err, largest_numel=capture.named["largest"]["before"].numel(),
                launches=len(calls), leaves=sum(c["leaves"] for c in calls),
                elements=sum(c["elements"] for c in calls),
                u_dtypes=set().union(*(c["u_dtypes"] for c in calls)),
                host_ms=sum(c["host_ms"] for c in calls),
                device_ms=sum(c.get("device_ms", 0.0) for c in calls),
                wrapper_host_ms=sum(c.get("wrapper_host_ms", 0.0) for c in calls))


def _k5_largest_leaf(torch, capture: _K5Capture) -> dict:
    """K5 over the update's largest leaf alone, in place on its copy: device
    time per launch (profiler), time per call with the wrapper (events), the
    plain rounding's time, the byte bound."""
    from onetrainer_tpu_torch.ops.sr_update import sr_update_leaves
    from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16
    leaf = capture.named["largest"]
    p, u, seed = leaf["before"], leaf["u"], leaf["seed"]
    # the mean over the launches the profiler records (it has dropped some
    # of K5's here); CUDA events around one call beside it (the wrapper's
    # host time included)
    bound = _bound_ms(0.0, (8 if u.dtype == torch.float32 else 6) * p.numel())
    ms, _ = _k5_device_ms(torch, lambda: sr_update_leaves([p], [u], seed, outs=[p]), 40,
                          bound[0])
    event_ms = _median_ms(torch, lambda: sr_update_leaves([p], [u], seed, outs=[p]))
    plain_ms = _median_ms(torch, lambda: p.copy_(stochastic_round_to_bf16(
        p.float() + u.float(), philox_bits(seed, p.numel(), p.device).view(p.shape))), reps=3)
    return dict(ms=ms, ms_with_wrapper=event_ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], shape=tuple(p.shape))


def phase_sdxl_ft(torch) -> dict:
    """Phase 14 (see the module docstring)."""
    from onetrainer_tpu_torch.ops.sr_update import sr_update_leaves
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import DataType, ModelType, Optimizer
    config = _fine_tune_config(ModelType.STABLE_DIFFUSION_XL_10_BASE, 2)
    config.unet.weight_dtype = DataType.BFLOAT_16
    config.optimizer.optimizer = Optimizer.ADAFACTOR
    config.optimizer.stochastic_rounding = True
    model = build_model(torch, config.weight_dtypes().unet.to_load_dtype())
    family = get_family(config.model_type)
    t0 = time.perf_counter()
    setup = family.create_setup(model, config, 100)
    batch = _train_batch(torch, family, setup, config.batch_size, 1024)
    torch.cuda.synchronize()
    params = setup.state.params["unet"]
    n_tensors, n_elements = len(params), sum(t.numel() for t in params.values())
    dtypes = {t.dtype for t in params.values()}
    print(f"[sdxl_ft] FINE_TUNE of the SDXL UNet: {n_tensors} tensors, {n_elements} "
          f"elements, {dtypes}; Adafactor (the reference's defaults), lr 1e-5, clip 1.0, "
          f"stochastic rounding, text encoders frozen and cached, batch 2 at 1024x1024, "
          f"set up in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(5)
    start = [t.detach().clone() for t in params.values()]
    t0 = time.perf_counter()
    metrics = setup.train_step(setup.state, batch, gen)
    first = [metrics["loss"].item(), metrics["grad_norm"].item()]
    warm_s = time.perf_counter() - t0
    changed = sum(not torch.equal(a, t) for a, t in zip(start, params.values()))
    del start
    print(f"[sdxl_ft] warm-up step {warm_s:.3f} s: loss {first[0]:.6f} grad_norm "
          f"{first[1]:.6f}; {changed} of {n_tensors} UNet tensors changed")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    step_s, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = setup.train_step(setup.state, batch, gen)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        step_s.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(step_s)
    n = TRAIN_STEPS * sum(SDXL_SELF_ATTN.values())
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n, "K4": 0, "K5": TRAIN_STEPS}
    print(f"[sdxl_ft] {TRAIN_STEPS} timed steps: sec/step median {med:.4f} "
          f"({', '.join(f'{x:.4f}' for x in step_s)}), images/s {2 / med:.3f}, peak "
          f"max_memory_allocated {peak_gib:.2f} GiB, losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}, grad_norms "
          f"{', '.join(f'{x:.6f}' for x in norms)}, launches {launches} (expected {expected})")

    # one more step with K5's inputs captured: K5 against the plain rounding
    with _K5Capture(torch, time_reps=10) as capture:
        setup.train_step(setup.state, batch, gen)["loss"].item()
    k5 = _k5_on_the_update(torch, capture)
    u_dtypes, n_el = k5["u_dtypes"], k5["elements"]
    set_bound = _bound_ms(0.0, (8 if torch.float32 in u_dtypes else 6) * n_el)
    set_ms, set_host_ms = k5["device_ms"], k5["wrapper_host_ms"]
    leaf = _k5_largest_leaf(torch, capture)
    leaf_ms, leaf_event_ms, leaf_plain_ms = leaf["ms"], leaf["ms_with_wrapper"], \
        leaf["plain_ms"]
    leaf_bound = (leaf["bound_ms"], leaf["bound_by"])
    card = gpu_line()
    print(f"[sdxl_ft] K5 over the update on {card}: {k5['leaves']} leaves, {n_el} elements, "
          f"{k5['launches']} launch(es), u {sorted(str(d) for d in u_dtypes)}, "
          f"{capture.layout_copies} updates in other "
          f"strides than their parameter (copied); bitwise equal to the plain rounding on "
          f"{k5['bitwise']}; every output a bf16 neighbour of p + u {k5['neighbours']}, "
          f"exact where representable {k5['exact']}; device {set_ms:.4f} ms per launch, "
          f"least time {set_bound[0]:.4f} ms ({set_bound[1]}; "
          f"{100 * set_bound[0] / set_ms:.1f}% of it), wrapper host time "
          f"{set_host_ms:.4f} ms per call ({k5['host_ms']:.4f} ms in the step); the "
          f"largest leaf ({k5['largest_numel']} elements) alone {leaf_ms:.4f} ms per launch "
          f"on the device ({leaf_event_ms:.4f} ms per call with the wrapper, events), "
          f"plain {leaf_plain_ms:.4f} ms, least time {leaf_bound[0]:.4f} ms")
    del capture
    gc.collect()
    profile_train_step(torch, setup, batch, gen, "sdxl_ft")
    checks = {
        "UNet size": (n_tensors, n_elements) == (SDXL_UNET_TENSORS, SDXL_UNET_ELEMENTS)
        and dtypes == {torch.bfloat16},
        "finite": _finite(first + losses + norms),
        "UNet changed after the first step": changed > n_tensors // 2,
        "launches per step": launches == expected,
        "K5 one launch per update dtype": len(u_dtypes) == 1 and k5["launches"] == 1,
        "K5 bitwise on the named leaves": all(k5["bitwise"].values()),
        "K5 neighbours on every leaf": k5["neighbours"] and k5["exact"],
        "largest leaf": k5["largest_numel"] == SDXL_LARGEST_LEAF,
    }
    print(f"[sdxl_ft] checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sdxl_ft failed: {[k for k, ok in checks.items() if not ok]}")
    return {"launches": launches, "sec_per_step": med, "peak_gib": peak_gib,
            "k5": dict(ms=leaf_ms, ms_with_wrapper=leaf_event_ms, plain_ms=leaf_plain_ms,
                       bound_ms=leaf_bound[0],
                       bound_by=leaf_bound[1], max_abs_err=k5["max_err"],
                       set_ms=set_ms, set_bound_ms=set_bound[0], set_host_ms=set_host_ms,
                       leaves=k5["leaves"], elements=n_el,
                       u_dtype=sorted(str(d) for d in u_dtypes),
                       shape=f"largest leaf of the SDXL fine-tune update, "
                             f"{k5['largest_numel']} elements")}


# -- the optimizers (phases sdxl_optimizers, sd15_ft_8bit) ------------------------------
# one warm-up and TRAIN_STEPS timed steps each, on the `train` phase's SDXL UNet
SDXL_OPTIMIZERS = ("ADAMW_8BIT", "PRODIGY", "DADAPT_ADAM", "SCHEDULE_FREE_ADAMW", "CAME", "LION")
# the update of this many named tensors against the same optimizer on the CPU
OPT_CHECK_LEAVES = 16
OPT_UPDATE_REL = 1e-5
# int8 codes: the share equal to the CPU's, and never more than one code apart
INT8_CODES_EQUAL = 0.9999
# ADAMW_8BIT's moments of the int8-eligible tensors against ADAMW's, in bytes
INT8_STATE_RATIO = 0.26


def _opt_state_bytes(opt_state) -> int:
    from onetrainer_tpu_torch.train.optimizers import opt_state_tensors
    return sum(t.numel() * t.element_size() for t in opt_state_tensors(opt_state)[0].values())


def _q8s(state) -> list:
    """Every int8 state tensor of an optimizer state, by (name, index)."""
    from onetrainer_tpu_torch.ops.quant_opt import Q8
    leaves = getattr(state, "leaves", {})
    return [((name, i), t) for name, values in leaves.items() for i, t in enumerate(values)
            if isinstance(t, Q8)]


def _checked_indices(tensors: list, n: int) -> list[int]:
    """n indices spread over `tensors`, half among those the int8 state
    takes (at least 16384 elements), half among the rest."""
    from onetrainer_tpu_torch.ops.quant_opt import MIN_SIZE
    big = [i for i, t in enumerate(tensors) if t.numel() >= MIN_SIZE]
    small = [i for i, t in enumerate(tensors) if t.numel() < MIN_SIZE]
    pick = []
    for pool, k in ((big, n // 2), (small, n - n // 2)):
        k = min(k, len(pool))
        pick += [pool[round(j * (len(pool) - 1) / max(k - 1, 1))] for j in range(k)]
    return sorted(set(pick))


def _watch_next_update(torch, setup, group: str, indices: list) -> dict:
    """Watch the optimizer call of the setup's next step (the warm-up
    step, untimed): the state and parameters just before it (the whole
    group for an optimizer that reduces over it, else the `indices`
    tensors), the pre-clip gradients and the global norm, the updates of
    `indices`, and their int8 codes after it, all copied to the host into
    the dict returned, which the step fills. Later steps run unwatched."""
    from onetrainer_tpu_torch.train.optimizers import LeafLocal, opt_state_tensors
    from onetrainer_tpu_torch.train.train_state import param_groups
    tx, state = setup.tx, setup.state
    params = param_groups(state.params)[group]
    opt = state.opt_state[group]
    whole = not isinstance(tx.groups[group], LeafLocal)
    keep = range(len(params)) if whole else indices
    seen = {"whole": whole, "updates": {},
            "params": {i: params[i].detach().cpu().clone() for i in keep}}
    if whole:
        tensors, counts = opt_state_tensors(state.opt_state)
        seen["state"] = ({k: t.detach().cpu().clone() for k, t in tensors.items()}, counts)
    else:
        seen["state"] = {(name, i): _host_copy(values[i]) for name, values in opt.leaves.items()
                         for i in indices}
        seen["count"] = opt.count
    inner = tx.leaf_updates

    def watched(groups, grads, opt_state, norm=None):
        del tx.leaf_updates   # one step only
        seen["grads"] = {i: grads[group][i].detach().cpu().clone() for i in keep}
        seen["norm"] = norm.detach().cpu().clone()
        for i, u in enumerate(inner(groups, grads, opt_state, norm)):
            if i in indices:
                seen["updates"][i] = u.detach().cpu().clone()
            yield u
        seen["codes_after"] = {key: q.codes.cpu().clone() for key, q in _q8s(opt)
                               if key[1] in indices}
    tx.leaf_updates = watched
    return seen


def _host_copy(t):
    from onetrainer_tpu_torch.ops.quant_opt import Q8
    if isinstance(t, Q8):
        return Q8(t.codes.cpu().clone(), t.scales.cpu().clone(), t.shape)
    return None if t is None else t.detach().cpu().clone()


def _against_the_cpu(torch, setup, seen: dict, group: str, indices: list, names: list) -> dict:
    """The same optimizer on the host from the watched state, parameters,
    gradients and norm: over the whole group for an optimizer that reduces
    over it, else over the `indices` tensors alone, behind the same clip. -> the worst rel L2 of the updates of `indices`, the int8
    codes of theirs: the share equal and the largest difference."""
    from onetrainer_tpu_torch.ops.quant_opt import Q8
    from onetrainer_tpu_torch.train.optimizers import (
        clip_by_global_norm_, create_group_optimizer, create_optimizer, opt_state_tensors,
        set_opt_state_counts,
    )
    cfg, tx = setup.config.optimizer, setup.tx
    schedule = tx.groups[group].schedule
    if seen["whole"]:
        twin = create_group_optimizer({group: schedule}, cfg.optimizer, cfg, tx.clip_grad_norm)
        params = {group: [seen["params"][i] for i in range(len(seen["params"]))]}
        state = twin.init(params)
        tensors, counts = seen["state"]
        for key, t in opt_state_tensors(state)[0].items():
            t.copy_(tensors[key])
        set_opt_state_counts(state, counts)
        grads = {group: [seen["grads"][i] for i in range(len(seen["grads"]))]}
        ups = twin.updates(params, grads, state, seen["norm"])[group]
        cpu_state = state[group]
        got = {i: ups[i] for i in indices}
        cpu_codes = {key: q.codes for key, q in _q8s(cpu_state) if key[1] in indices}
    else:
        opt = create_optimizer(cfg.optimizer, cfg, schedule)
        params = [seen["params"][i] for i in indices]
        state = opt.init(params)
        for (name, i), t in seen["state"].items():
            j = indices.index(i)
            if isinstance(t, Q8):
                state.leaves[name][j].codes.copy_(t.codes)
                state.leaves[name][j].scales.copy_(t.scales)
            elif t is not None:
                state.leaves[name][j].copy_(t)
        state.count = seen["count"]
        grads = [seen["grads"][i] for i in indices]
        if tx.clip_grad_norm:
            clip_by_global_norm_(grads, tx.clip_grad_norm, seen["norm"])
        ups = opt.updates(params, grads, state)
        got = {i: u for i, u in zip(indices, ups)}
        cpu_codes = {(name, indices[j]): q.codes for (name, j), q in _q8s(state)}
    rel = {names[i]: 0.0 if torch.equal(seen["updates"][i], got[i])
           else _rel_l2(seen["updates"][i], got[i]) for i in indices}
    # schedule-free's update is y' - y, far smaller than y: one rounding of
    # y' (ulp(y)) is up to ulp(y) / |u| of it, so it is held per element to
    # 4 ulps of the tensor's largest |y| plus OPT_UPDATE_REL of its largest |u|
    ulps = {}
    for i in indices:
        y = seen["params"][i].float().abs().max()
        ulp = (torch.nextafter(y, torch.tensor(float("inf"))) - y).item()
        err = (seen["updates"][i] - got[i]).abs().max().item()
        ulps[names[i]] = max(0.0, err - OPT_UPDATE_REL * got[i].abs().max().item()) / ulp
    equal, apart, n_codes = 0, 0, 0
    for key, codes in seen["codes_after"].items():
        diff = (codes.int() - cpu_codes[key].int()).abs()
        equal += int((diff == 0).sum())
        apart = max(apart, int(diff.max()))
        n_codes += diff.numel()
    return {"rel": rel, "worst": max(rel.values()), "worst_ulps": max(ulps.values()),
            "subset": not seen["whole"],
            "codes": n_codes,
            "codes_equal": equal / n_codes if n_codes else 1.0, "codes_apart": apart}


def _write_eval_lora(torch, setup, family, root: str) -> dict:
    """Schedule-free: the LoRA output written as the trainer writes it (x
    swapped in, fp32), read back, against x and y per tensor."""
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    from onetrainer_tpu_torch.peft.lora import peft_to_kohya_state_dict
    from onetrainer_tpu_torch.setup.families import save_lora_output
    from onetrainer_tpu_torch.train.optimizers import (
        schedule_free_eval, schedule_free_eval_params,
    )
    from onetrainer_tpu_torch.train.train_state import param_groups, param_names
    state = setup.state
    y = {g: [t.detach().clone() for t in ts] for g, ts in param_groups(state.params).items()}
    x = schedule_free_eval_params(state.opt_state, param_groups(state.params))
    with schedule_free_eval(state.opt_state, param_groups(state.params)):
        path = save_lora_output(setup, os.path.join(root, "sf_lora"), family.lora_prefixes,
                                save_dtype=torch.float32)
    restored = all(torch.equal(a, b) for g, ts in param_groups(state.params).items()
                   for a, b in zip(ts, y[g]))
    out = load_safetensors(path)
    os.remove(path)
    names = param_names(state.params)
    equal, differs, n = 0, 0, 0
    for group, prefix in family.lora_prefixes.items():
        if group not in x:
            continue
        for values, counts in ((x, "x"), (y, "y")):
            tree = {}
            for name, t in zip(names[group], values[group]):
                key, leaf = name.rsplit("/", 1)
                tree.setdefault(key, {})[leaf] = t
            kohya = peft_to_kohya_state_dict(tree, setup.peft_cfg, prefix)
            for k, t in kohya.items():
                if k.endswith(".alpha"):
                    continue
                same = torch.equal(out[k], t.cpu())
                if counts == "x":
                    n += 1
                    equal += same
                else:
                    differs += not same
    return {"tensors": n, "equal_x": equal, "differ_from_y": differs, "y_restored": restored}


def phase_sdxl_optimizers(torch, model, batch=None) -> dict:
    """Phase 38 (see the module docstring); `batch`, the train phase's."""
    from onetrainer_tpu_torch.ops.quant_opt import MIN_SIZE
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.train.train_state import param_groups, param_names
    from onetrainer_tpu_torch.util.enums import ModelType, Optimizer
    recompute = 2 if model.unet_config.gradient_checkpointing else 1
    n = TRAIN_STEPS * sum(SDXL_SELF_ATTN.values())
    expected = {"K1": recompute * n, "K2": n, "K3": n, "K3pre": n, "K4": 0, "K5": 0}
    family = get_family(ModelType.STABLE_DIFFUSION_XL_10_BASE)
    results, launches = {}, {k: 0 for k in expected}
    root = tempfile.mkdtemp(prefix="sdxl_optimizers_")
    card = gpu_line()
    try:
        for name in SDXL_OPTIMIZERS:
            t0 = time.perf_counter()
            config = _lora_config(2)
            config.optimizer.optimizer = Optimizer[name]
            if config.optimizer.optimizer.is_adaptive():
                config.learning_rate = 1.0   # d-adaptive: the lr scales the estimate
            tag = f"sdxl_optimizers/{name}"
            watch = {}

            def watch_warmup(setup, watch=watch):
                groups = param_groups(setup.state.params)["unet_lora"]
                watch["indices"] = _checked_indices(groups, OPT_CHECK_LEAVES)
                watch["seen"] = _watch_next_update(torch, setup, "unet_lora", watch["indices"])
            run = _setup_and_steps(torch, model, config, tag, 1024, after_batch=watch_warmup,
                                   make_batch=None if batch is None else (lambda s: batch))
            batch, setup = run["batch"], run["setup"]
            for k, v in run["launches"].items():
                launches[k] += v
            opt_state = setup.state.opt_state
            state_gib = _opt_state_bytes(opt_state) / 2 ** 30
            group_state = opt_state["unet_lora"]
            int8 = len(_q8s(group_state))
            params = param_groups(setup.state.params)["unet_lora"]
            names = param_names(setup.state.params)["unet_lora"]
            indices = watch["indices"]
            cpu = _against_the_cpu(torch, setup, watch.pop("seen"), "unet_lora", indices, names)
            # Prodigy's and D-Adapt's step size after the warm-up and timed steps
            d = float(group_state.estim_lr) if name in ("PRODIGY", "DADAPT_ADAM") else None
            written = _write_eval_lora(torch, setup, family, root) \
                if name == "SCHEDULE_FREE_ADAMW" else None
            eligible = sum(t.numel() >= MIN_SIZE for t in params)
            schedule_free = config.optimizer.optimizer.is_schedule_free()
            checks = {
                "finite": run["finite"],
                "launches per step": run["launches"] == expected,
                "updates against the CPU": cpu["worst_ulps"] <= 4 if schedule_free
                else cpu["worst"] <= OPT_UPDATE_REL,
                "int8 codes against the CPU": cpu["codes_equal"] >= INT8_CODES_EQUAL
                and cpu["codes_apart"] <= 1,
                "int8 state": (int8 > 0) == name.endswith("_8BIT")
                and (not name.endswith("_8BIT") or int8 == 2 * eligible),
            }
            if d is not None:
                checks["d finite, at least d0"] = torch.tensor(1e-6).item() <= d < float("inf")
            if written is not None:
                checks["output holds x"] = written["equal_x"] == written["tensors"] > 0 \
                    and written["differ_from_y"] > 0 and written["y_restored"]
            print(f"[{tag}] on {card}: sec/step {run['sec_per_step']:.4f}, optimizer state "
                  f"{state_gib:.4f} GiB ({int8} int8 tensors of {len(params)} adapters, "
                  f"{eligible} of them >= {MIN_SIZE} elements), peak {run['peak_gib']:.2f} "
                  f"GiB" + (f", d after {TRAIN_STEPS + 1} steps {d:.6e}" if d else "")
                  + f"; the warm-up's update of {len(indices)} named adapters against the "
                  f"host's{' (whole group)' if not cpu['subset'] else ''}: worst rel L2 "
                  f"{cpu['worst']:.3e} (bound {OPT_UPDATE_REL:g}"
                  + (f"; schedule-free: per element within {cpu['worst_ulps']:.2f} ulps of "
                     f"the tensor's largest |y| past {OPT_UPDATE_REL:g} of its largest "
                     f"update, bound 4" if schedule_free else "") + "; "
                  f"{', '.join(f'{k} {v:.2e}' for k, v in list(cpu['rel'].items())[:4])}, ...)"
                  + (f", int8 codes {cpu['codes']} equal {100 * cpu['codes_equal']:.4f}%, "
                     f"at most {cpu['codes_apart']} apart" if cpu["codes"] else "")
                  + (f"; LoRA output {written}" if written else "")
                  + f"; phase part {time.perf_counter() - t0:.1f} s; checks {checks}")
            results[name] = dict(sec_per_step=run["sec_per_step"], state_gib=state_gib,
                                 int8=int8, d=d, peak_gib=run["peak_gib"],
                                 worst_rel=cpu["worst"], codes_equal=cpu["codes_equal"])
            if not all(checks.values()):
                raise AssertionError(f"{tag} failed: "
                                     f"{[k for k, ok in checks.items() if not ok]}")
            del run, setup, opt_state, group_state, params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "optimizers": results}


def phase_sd15_ft_8bit(torch, model, batch=None) -> dict:
    """Phase 39 (see the module docstring); `batch`, sd15_train's."""
    from onetrainer_tpu_torch.ops.quant_opt import MIN_SIZE
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.train.train_state import param_groups, param_names
    from onetrainer_tpu_torch.util.enums import ModelType, Optimizer
    recompute = 2 if model.unet_config.gradient_checkpointing else 1
    n = TRAIN_STEPS * sum(SD15_SELF_ATTN.values())
    expected = {"K1": recompute * n, "K2": n, "K3": n, "K3pre": n, "K4": 0, "K5": 0}
    family = get_family(ModelType.STABLE_DIFFUSION_15)
    card = gpu_line()
    out, launches = {}, {k: 0 for k in expected}
    for name in ("ADAMW", "ADAMW_8BIT"):
        t0 = time.perf_counter()
        tag = f"sd15_ft_8bit/{name}"
        config = _fine_tune_config(ModelType.STABLE_DIFFUSION_15, 4)
        config.optimizer.optimizer = Optimizer[name]
        setup = family.create_setup(model, config, 100)
        if batch is None:
            batch = _train_batch(torch, family, setup, config.batch_size, 512)
        params = param_groups(setup.state.params)["unet"]
        names = param_names(setup.state.params)["unet"]
        n_el = sum(t.numel() for t in params)
        gen = torch.Generator(device="cuda").manual_seed(5)
        indices = _checked_indices(params, OPT_CHECK_LEAVES)
        seen = _watch_next_update(torch, setup, "unet", indices)
        timed = _timed_steps(torch, setup, batch, gen, tag)
        for k, v in timed["launches"].items():
            launches[k] += v
        opt = setup.state.opt_state["unet"]
        eligible = [i for i, t in enumerate(params) if t.numel() >= MIN_SIZE
                    and t.dtype == torch.float32]
        if name == "ADAMW":
            state_bytes = sum(opt.leaves[k][i].numel() * 4 for k in ("mu", "nu")
                              for i in eligible)
        else:
            state_bytes = sum(opt.leaves[k][i].nbytes() for k in ("mu", "nu")
                              for i in eligible)
        total_gib = _opt_state_bytes(setup.state.opt_state) / 2 ** 30
        cpu = _against_the_cpu(torch, setup, seen, "unet", indices, names)
        del seen
        out[name] = dict(sec_per_step=timed["sec_per_step"], peak_gib=timed["peak_gib"],
                         state_gib=total_gib, eligible_state_gib=state_bytes / 2 ** 30,
                         int8=len(_q8s(opt)), worst_rel=cpu["worst"],
                         codes_equal=cpu["codes_equal"], codes_apart=cpu["codes_apart"],
                         finite=timed["finite"],
                         launches_ok=timed["launches"] == expected)
        print(f"[{tag}] on {card}: FINE_TUNE of the SD 1.5 UNet ({len(params)} tensors, "
              f"{n_el} fp32 elements), batch 4 at 512x512, {name}: sec/step "
              f"{timed['sec_per_step']:.4f}, peak {timed['peak_gib']:.2f} GiB, optimizer state "
              f"{total_gib:.4f} GiB ({len(eligible)} int8-eligible tensors' moments "
              f"{state_bytes / 2 ** 30:.4f} GiB, {out[name]['int8']} int8 tensors); "
              f"the warm-up's update of {len(indices)} named tensors against the host's: "
              f"worst rel L2 "
              f"{cpu['worst']:.3e}" + (f", int8 codes {cpu['codes']} equal "
                                       f"{100 * cpu['codes_equal']:.4f}%, at most "
                                       f"{cpu['codes_apart']} apart" if cpu["codes"] else "")
              + f"; launches {timed['launches']} (expected {expected}); phase part "
              f"{time.perf_counter() - t0:.1f} s")
        del setup, opt, params
        gc.collect()
        torch.cuda.empty_cache()
    adamw, q8 = out["ADAMW"], out["ADAMW_8BIT"]
    ratio = q8["eligible_state_gib"] / adamw["eligible_state_gib"]
    checks = {
        "finite": adamw["finite"] and q8["finite"],
        "launches per step": adamw["launches_ok"] and q8["launches_ok"],
        "updates against the CPU": max(adamw["worst_rel"], q8["worst_rel"]) <= OPT_UPDATE_REL,
        "int8 codes against the CPU": q8["codes_equal"] >= INT8_CODES_EQUAL
        and q8["codes_apart"] <= 1 and adamw["int8"] == 0 and q8["int8"] > 0,
        f"int8 state at most {INT8_STATE_RATIO}x": ratio <= INT8_STATE_RATIO,
    }
    print(f"[sd15_ft_8bit] ADAMW_8BIT's eligible moments {q8['eligible_state_gib']:.4f} GiB "
          f"against ADAMW's {adamw['eligible_state_gib']:.4f} GiB ({ratio:.4f}x); peaks "
          f"ADAMW {adamw['peak_gib']:.2f} GiB, ADAMW_8BIT {q8['peak_gib']:.2f} GiB; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sd15_ft_8bit failed: {[k for k, ok in checks.items() if not ok]}")
    return {"launches": launches, "optimizers": out, "ratio": ratio}


# -- embeddings and the VAE fine-tune (phases sdxl_embedding, sd15_vae_ft;
# the EMBEDDING runs of the CLI phases) --------------------------------------------------
# the SDXL embedding: 4 tokens in CLIP-L and CLIP-G
EMBEDDING_TOKENS = 4
EMBEDDING_PROMPT = "a photograph of <emb> riding a horse"


def _crc32_words(tokenizer):
    """`tokenizer` (the port's no-file CLIP wrapper: the card has no
    tokenizer files) with crc32 word ids in place of its fallback's Python
    `hash`, which is salted per process: every run feeds the same ids."""
    n = tokenizer.vocab_size - 2
    tokenizer._tokenizer = lambda text, add_special_tokens=False: {
        "input_ids": [zlib.crc32(w.encode()) % n + 1 for w in text.lower().split()]}
    return tokenizer


def _embedding_config(model_type, batch_size: int):
    """EMBEDDING of EMBEDDING_TOKENS tokens, `<emb>`, started from "a
    photograph": AdamW lr 1e-3, clip 1.0; the text encoders run in the
    step."""
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.util.enums import TrainingMethod
    config = TrainConfig.default_values()
    config.model_type = model_type
    config.training_method = TrainingMethod.EMBEDDING
    config.batch_size = batch_size
    config.learning_rate = 1e-3
    config.learning_rate_warmup_steps = 0.0
    config.clip_grad_norm = 1.0
    config.embedding.placeholder = "<emb>"
    config.embedding.token_count = EMBEDDING_TOKENS
    config.embedding.initial_embedding_text = "a photograph"
    return config


def _timed_steps(torch, setup, batch, gen, tag: str) -> dict:
    """One warm-up step, then TRAIN_STEPS timed ones with every launch
    count zeroed just before them and read just after."""
    t0 = time.perf_counter()
    metrics = setup.train_step(setup.state, batch, gen)
    first = [metrics["loss"].item(), metrics["grad_norm"].item()]
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    step_s, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = setup.train_step(setup.state, batch, gen)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        step_s.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(step_s)
    print(f"[{tag}] warm-up step {warm_s:.3f} s: loss {first[0]:.6f} grad_norm "
          f"{first[1]:.6f}; {TRAIN_STEPS} timed steps: sec/step median {med:.4f} "
          f"({', '.join(f'{x:.4f}' for x in step_s)}), peak max_memory_allocated "
          f"{peak_gib:.2f} GiB, losses {', '.join(f'{x:.6f}' for x in losses)}, grad_norms "
          f"{', '.join(f'{x:.6f}' for x in norms)}, launches {launches}")
    return dict(launches=launches, sec_per_step=med, peak_gib=peak_gib,
                finite=_finite(first + losses + norms))


def phase_sdxl_embedding(torch) -> dict:
    """Textual inversion of SDXL at full width: the UNet in bf16 under
    tx_only and both text encoders frozen, the text run in the step on the
    batch's tokens, batch 2 at 1024x1024, `<emb>` of 4 tokens in CLIP-L
    (768 wide) and CLIP-G (1280), AdamW: one warm-up and TRAIN_STEPS timed steps
    with exactly K1 140, K2, K3 and the pre-pass 70 per step (CLIP-G's
    pooled embedding enters the time embedding, so every resnet, and every
    self-attention after it, depends on the text: even the first block's
    self-attention, before any cross-attention, takes the backward); the
    UNet and both text encoders bit
    for bit unchanged (copies on the host), only the 4x768 and 4x1280
    vectors moved; one step's vector gradients with K1-K3 against plain
    attention; a profiler split."""
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import ModelType
    config = _embedding_config(ModelType.STABLE_DIFFUSION_XL_10_BASE, 2)
    model = build_model(torch, torch.bfloat16)
    family = get_family(config.model_type)
    t0 = time.perf_counter()
    from onetrainer_tpu_torch.setup.sd_setup import wrap_tokenizer
    model.tokenizer = _crc32_words(wrap_tokenizer(model.tokenizer, model.te_config))
    model.tokenizer_2 = _crc32_words(wrap_tokenizer(model.tokenizer_2, model.te2_config))
    setup = family.create_setup(model, config, 100)
    batch = _train_batch(torch, family, setup, 2, 1024, EMBEDDING_PROMPT)
    torch.cuda.synchronize()
    vectors = setup.state.params
    shapes = {k: tuple(v.shape) for k, v in vectors.items()}
    start = {k: v.detach().clone() for k, v in vectors.items()}
    frozen = {name: [p.detach().to("cpu", copy=True) for p in m.parameters()]
              for name, m in model.modules().items() if name != "vae"}
    print(f"[sdxl_embedding] EMBEDDING {shapes}, UNet {next(model.unet.parameters()).dtype} "
          f"under tx_only, text encoders fp32 and live, batch 2 at 1024x1024, tokens "
          f"{batch['tokens'][0, :12].tolist()}, set up in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(5)
    run = _timed_steps(torch, setup, batch, gen, "sdxl_embedding")
    t0 = time.perf_counter()
    unchanged = {name: all(torch.equal(p.detach().cpu(), c) for p, c in
                           zip(model.modules()[name].parameters(), copies))
                 for name, copies in frozen.items()}
    del frozen
    moved = {k: not torch.equal(v, start[k]) for k, v in vectors.items()}
    print(f"[sdxl_embedding] bit for bit unchanged {unchanged}, vectors moved {moved} "
          f"(checked in {time.perf_counter() - t0:.2f} s)")
    grads = _grads_against_plain(torch, setup, batch, "sdxl_embedding")
    per_step = sum(SDXL_SELF_ATTN.values())
    expected = {"K1": TRAIN_STEPS * 2 * sum(SDXL_SELF_ATTN.values()),
                "K2": TRAIN_STEPS * per_step, "K3": TRAIN_STEPS * per_step,
                "K3pre": TRAIN_STEPS * per_step, "K4": 0, "K5": 0}
    checks = {
        "vectors": shapes == {"embeddings": (EMBEDDING_TOKENS, 768),
                              "embeddings_2": (EMBEDDING_TOKENS, 1280)},
        "finite": run["finite"] and grads["finite"],
        "launches per step": run["launches"] == expected,
        "K1 by sequence length": grads["by_seq"] == {
            s: 2 * c for s, c in SDXL_SELF_ATTN.items()},
        "gradients against plain attention": grads["rel"] <= GRAD_REL_L2_BOUND,
        "frozen parts bit for bit": all(unchanged.values()),
        "vectors moved": all(moved.values()),
    }
    print(f"[sdxl_embedding] launches {run['launches']} (expected {expected}) checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sdxl_embedding failed: "
                             f"{[k for k, ok in checks.items() if not ok]}")
    profile_train_step(torch, setup, batch, gen, "sdxl_embedding")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"]}


def phase_sd15_vae_ft(torch) -> dict:
    """The SD 1.5 VAE fine-tune at full width: the VAE in bf16 through the
    setup's FINE_TUNE_VAE (the UNet and text encoder frozen), AdamW lr
    1e-5, clip 1.0, stochastic rounding, batch 4 at 512x512, the cached
    latent decoded against the image: one warm-up and TRAIN_STEPS timed steps with
    exactly K5 once per step and no attention kernel (the VAE's one
    attention is 512 wide: SDPA); one step with K5's call captured, bit for
    bit against the plain rounding on the Philox bits of the largest, a
    1-D, a 2-D and a 4-D leaf and a bf16 neighbour of p + u on every leaf;
    the largest leaf's time against its bound; a profiler split."""
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import ModelType, TrainingMethod
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_15
    config.training_method = TrainingMethod.FINE_TUNE_VAE
    config.batch_size = 4
    config.learning_rate = 1e-5
    config.learning_rate_warmup_steps = 0.0
    config.clip_grad_norm = 1.0
    config.optimizer.stochastic_rounding = True
    model = build_model(torch, None, config.model_type)
    model.vae.to(torch.bfloat16)
    family = get_family(config.model_type)
    setup = family.create_setup(model, config, 100)
    batch = _train_batch(torch, family, setup, 4, 512)
    params = setup.state.params["vae"]
    n_tensors, n_elements = len(params), sum(t.numel() for t in params.values())
    start = [t.detach().clone() for t in params.values()]
    print(f"[sd15_vae_ft] FINE_TUNE_VAE: {n_tensors} VAE tensors, {n_elements} elements, "
          f"{ {t.dtype for t in params.values()} }, batch 4 at 512x512, image "
          f"{tuple(batch['image'].shape)}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    run = _timed_steps(torch, setup, batch, gen, "sd15_vae_ft")
    # the decode trains the decoder; the encoder's tensors take no gradient
    decoder = [i for i, name in enumerate(params) if not name.startswith(("encoder.",
                                                                           "quant_conv."))]
    values = list(params.values())
    changed = sum(not torch.equal(start[i], values[i]) for i in decoder)
    del start
    with _K5Capture(torch, time_reps=10) as capture:
        setup.train_step(setup.state, batch, gen)["loss"].item()
    k5 = _k5_on_the_update(torch, capture)
    u_dtypes, n_el = k5["u_dtypes"], k5["elements"]
    set_bound = _bound_ms(0.0, (8 if torch.float32 in u_dtypes else 6) * n_el)
    leaf = _k5_largest_leaf(torch, capture)
    print(f"[sd15_vae_ft] K5 over the update on {gpu_line()}: {k5['leaves']} leaves, {n_el} "
          f"elements, {k5['launches']} launch(es), u {sorted(str(d) for d in u_dtypes)}; "
          f"bitwise {k5['bitwise']}; neighbours {k5['neighbours']}, exact {k5['exact']}; "
          f"device {k5['device_ms']:.4f} ms, least time {set_bound[0]:.4f} ms, wrapper host "
          f"{k5['wrapper_host_ms']:.4f} ms; largest leaf {leaf['shape']} {leaf['ms']:.4f} ms "
          f"(with the wrapper {leaf['ms_with_wrapper']:.4f}), plain {leaf['plain_ms']:.4f}, "
          f"bound {leaf['bound_ms']:.4f} ms")
    del capture
    profile_train_step(torch, setup, batch, gen, "sd15_vae_ft")
    expected = {"K1": 0, "K2": 0, "K3": 0, "K3pre": 0, "K4": 0, "K5": TRAIN_STEPS}
    checks = {
        "bf16 VAE": all(t.dtype == torch.bfloat16 for t in params.values()),
        "finite": run["finite"],
        "decoder changed": changed > len(decoder) // 2,
        "frozen parts": not any(p.requires_grad for name, m in model.modules().items()
                                if name != "vae" for p in m.parameters()),
        "launches per step": run["launches"] == expected,
        "K5 one launch": k5["launches"] == 1 and k5["leaves"] == n_tensors,
        "K5 bitwise on the named leaves": all(k5["bitwise"].values()),
        "K5 neighbours on every leaf": k5["neighbours"] and k5["exact"],
    }
    print(f"[sd15_vae_ft] {changed} of the decoder's {len(decoder)} tensors changed; launches "
          f"{run['launches']} (expected {expected}) checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sd15_vae_ft failed: {[k for k, ok in checks.items() if not ok]}")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"],
            "k5": dict(ms=leaf["ms"], ms_with_wrapper=leaf["ms_with_wrapper"],
                       plain_ms=leaf["plain_ms"], bound_ms=leaf["bound_ms"],
                       bound_by=leaf["bound_by"], max_abs_err=k5["max_err"],
                       set_ms=k5["device_ms"], set_bound_ms=set_bound[0],
                       set_host_ms=k5["wrapper_host_ms"], leaves=k5["leaves"], elements=n_el,
                       u_dtype=sorted(str(d) for d in u_dtypes),
                       shape=f"largest leaf of the SD 1.5 VAE fine-tune update, "
                             f"{k5['largest_numel']} elements")}


# the CLI EMBEDDING runs: "astronaut", in every caption, an input embedding
# of 2 tokens; "horse" an output embedding of 1 token
def _embedding_cli(torch, tag: str, ckpt: str, dataset: str, model_type, size: int,
                   per_step: dict, keys: set, configure=None, resume: bool = False,
                   sample_argv: list | None = None, sample_k1: int = 0) -> dict:
    """EMBEDDING through the train command on sd15_files' PNGs at size x
    size, batch 4: "astronaut" (in every caption) an input embedding of 2
    tokens started from "a photograph", "horse" an output embedding of one;
    `configure(config)` sets the family's weights and checkpointing. Epoch
    1 (with a backup when `resume`, then the resume for epoch 2): exactly
    `per_step` launches per step and none while caching, the cache's rows
    carry the tokens (the text runs in the step), the embedding file holds
    `keys`, each the trained vectors bit for bit (fp32); with `sample_argv`
    the sample command with --embedding-name on that file (`sample_k1` K1)."""
    from onetrainer_tpu_torch.config.train_config import TrainEmbeddingConfig
    from onetrainer_tpu_torch.io.png import read_png
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    from onetrainer_tpu_torch.scripts import sample
    from onetrainer_tpu_torch.setup.families import embedding_file_keys
    from onetrainer_tpu_torch.util.enums import TrainingMethod

    root = os.path.join(os.path.dirname(ckpt), "embedding")
    os.makedirs(root)
    config = _cli_config(root, ckpt, dataset)
    config.model_type = model_type
    config.resolution = str(size)
    config.training_method = TrainingMethod.EMBEDDING
    config.learning_rate = 1e-3
    config.embedding.placeholder = "astronaut"
    config.embedding.token_count = 2
    config.embedding.initial_embedding_text = "a photograph"
    out = TrainEmbeddingConfig.default_values()
    out.placeholder, out.token_count, out.initial_embedding_text = "horse", 1, "horse"
    out.is_output_embedding = True
    config.additional_embeddings = [out]
    config.backup_before_save = resume
    config.output_model_destination = os.path.join(root, "embedding.safetensors")
    if configure is not None:
        configure(config)
    paths = [os.path.join(root, "epoch1.json")]
    with open(paths[0], "w") as f:
        json.dump(config.to_dict(), f)
    if resume:
        config.epochs = 2
        config.continue_last_backup = True
        paths.append(os.path.join(root, "epoch2.json"))
        with open(paths[1], "w") as f:
            json.dump(config.to_dict(), f)
    torch.cuda.synchronize()
    _reset_launch_counts()
    runs, trainer = [], None
    t0 = time.perf_counter()
    for path in paths:
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        events = []
        trainer, _ = _cli_run(torch, path, events)
        runs.append(events)
    train_s = time.perf_counter() - t0
    launches = _launch_counts()
    steps, cache_launches, _ = _cli_timeline(*runs)
    vectors = {k: v.detach().cpu() for k, v in trainer.setup.state.params.items()}
    written = load_safetensors(config.output_model_destination)
    save_keys = embedding_file_keys(trainer.setup)
    bitwise = set(written) == keys == set(save_keys.values()) and all(
        torch.equal(written[name], vectors[group]) for group, name in save_keys.items())
    cache_files = [os.path.join(config.cache_dir, f) for f in os.listdir(config.cache_dir)]
    rows = [load_safetensors(f) for f in cache_files]
    live = len(rows) == CLI_IMAGES and all(
        not any(k.endswith(("hidden_state", "pooled_state", "context", "pooled"))
                for k in r) for r in rows)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    none = {k: 0 for k in per_step}
    n_steps = 2 * len(paths)
    checks = {
        "launches per step": len(steps) == n_steps and all(d == per_step for _, d, _ in steps),
        "none while caching": all(c == none for c in cache_launches),
        "embedding file": bitwise,
        "text live": live,
        "vectors": {k: tuple(v.shape)[0] for k, v in vectors.items()}
        == {k: (2 if k.startswith("embeddings") else 1) for k in vectors},
    }
    sample_launches, sample_s = None, None
    if sample_argv is not None:
        before = _launch_counts()
        image_path = os.path.join(root, "sample.png")
        t0 = time.perf_counter()
        result = sample.main(["--model-type", model_type.value, "--base-model-name", ckpt,
                              "--prompt", "a photograph of <embedding> riding a horse",
                              "--destination", image_path, "--steps", "4",
                              "--width", str(size), "--height", str(size),
                              "--embedding-name", config.output_model_destination]
                             + sample_argv)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        sample_launches = _delta(_launch_counts(), before)
        image = read_png(image_path)
        checks["sample"] = (sample_launches == {**none, "K1": sample_k1}
                            and image.std() > 0 and bool((image == result.image).all()))
    print(f"[{tag}] EMBEDDING through the train command ({len(paths)} run(s), "
          f"{train_s:.2f} s): vectors {({k: tuple(v.shape) for k, v in vectors.items()})}, "
          f"file {sorted(written)}; steps (global step, s): "
          f"{', '.join(f'{g}: {s:.4f}' for g, _, s in steps)}; launches {launches}"
          + (f"; sample with --embedding-name {sample_s:.2f} s, {sample_launches}"
             if sample_launches is not None else "") + f"; checks {checks}")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag} EMBEDDING failed: "
                             f"{[k for k, ok in checks.items() if not ok]}")
    return launches


def _cli_weights(prior_dtype=None):
    """`_embedding_cli`'s `configure` for the DiT CLI phases: the weights
    of their LoRA runs (bf16, the transformer in `prior_dtype`), gradient
    checkpointing on."""
    def configure(config):
        from onetrainer_tpu_torch.util.enums import DataType, GradientCheckpointingMethod
        config.weight_dtype = DataType.BFLOAT_16
        if prior_dtype is not None:
            config.prior.weight_dtype = prior_dtype
        config.gradient_checkpointing = GradientCheckpointingMethod.ON
    return configure


def _sd15_additional_embedding_cli(torch, files: dict) -> dict:
    """sd15_cli's LoRA beside one additional embedding ("astronaut", 2
    tokens) through the train command: epoch 1 with a backup, the resume
    for epoch 2 (the adapters and the vectors from the backup), exactly
    sd15_cli's launches per step (the adapters need every self-attention's
    gradients), the LoRA file bundling the vectors bit for bit as
    `bundle_emb.astronaut.emp_params`. -> the launches of both runs."""
    from onetrainer_tpu_torch.config.train_config import TrainEmbeddingConfig
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    root = os.path.join(os.path.dirname(files["ckpt"]), "lora_embedding")
    os.makedirs(root)
    config = _cli_config(root, files["ckpt"], files["dataset"])
    extra = TrainEmbeddingConfig.default_values()
    extra.placeholder, extra.token_count, extra.initial_embedding_text = \
        "astronaut", 2, "a photograph"
    config.additional_embeddings = [extra]
    paths = [os.path.join(root, "epoch1.json"), os.path.join(root, "epoch2.json")]
    with open(paths[0], "w") as f:
        json.dump(config.to_dict(), f)
    config.epochs = 2
    config.continue_last_backup = True
    with open(paths[1], "w") as f:
        json.dump(config.to_dict(), f)
    _reset_launch_counts()
    runs, trainer = [], None
    for path in paths:
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        events = []
        trainer, _ = _cli_run(torch, path, events)
        runs.append(events)
    launches = _launch_counts()
    steps, _, _ = _cli_timeline(*runs)
    written = load_safetensors(config.output_model_destination)
    vectors = trainer.setup.state.params["embeddings"].detach().cpu()
    per_step = {"K1": 5, "K2": 5, "K3": 5, "K3pre": 5, "K4": 0, "K5": 0}
    checks = {
        "groups": set(trainer.setup.state.params) == {"unet_lora", "embeddings"},
        "launches per step": len(steps) == 4 and all(d == per_step for _, d, _ in steps),
        "bundled": torch.equal(written["bundle_emb.astronaut.emp_params"], vectors),
        "global step": trainer.train_progress.global_step == 4,
    }
    print(f"[sd15_cli] LoRA beside an additional embedding {tuple(vectors.shape)}: steps "
          f"{[(g, round(s, 4)) for g, _, s in steps]}, launches {launches}, checks {checks}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    if not all(checks.values()):
        raise AssertionError(f"sd15_cli additional embedding failed: "
                             f"{[k for k, ok in checks.items() if not ok]}")
    return launches


def update_launches(sizes: list) -> int:
    """K5 launches of one bf16 update of leaves of `sizes` elements, one u
    dtype: one per chunk of the train step's (consecutive leaves of at most
    UPDATE_CHUNK_ELEMENTS elements, a larger leaf alone)."""
    from onetrainer_tpu_torch.train.optimizers import chunk_lengths
    from onetrainer_tpu_torch.train.sd_train_step import UPDATE_CHUNK_ELEMENTS
    return len(chunk_lengths(sizes, UPDATE_CHUNK_ELEMENTS))


def _ft_grads_against_plain(torch, setup, batch, tag: str, params: dict) -> dict:
    """The gradients of one FINE_TUNE step's loss with respect to `params`
    ({name: tensor}) with K1-K3 against plain attention, at fixed
    timesteps and noise: relative L2 over all of them, summed tensor by
    tensor (no copy of the whole set); the K1 launches of one forward by
    sequence length."""
    from onetrainer_tpu_torch.ops import flash_folded as ff
    draws = _fixed_draws(torch, batch, _continuous(setup.config.model_type))
    latent_draw = {"latent_noise": draws[2]} if "latent_logvar" in batch else {}
    names, tensors = list(params), list(params.values())
    seqs = []
    kernel_fn = ff.flash_attention_folded

    def grads():
        loss = setup.train_step.loss(batch, None, timestep=draws[0], noise=draws[1],
                                     **latent_draw)
        return torch.autograd.grad(loss, tensors)

    def recorded(q, *args, **kwargs):
        seqs.append(q.shape[1])
        return kernel_fn(q, *args, **kwargs)
    ff.flash_attention_folded = recorded
    try:
        g_kernel = grads()
    finally:
        ff.flash_attention_folded = kernel_fn
    ff.flash_attention_folded = _plain_attention(ff)
    try:
        g_plain = grads()
    finally:
        ff.flash_attention_folded = kernel_fn
    diff = sum(float((a.float() - b.float()).square().sum()) for a, b in zip(g_kernel, g_plain))
    ref = sum(float(b.float().square().sum()) for b in g_plain)
    rel = (diff / ref) ** 0.5
    finite = all(bool(torch.isfinite(g).all()) for g in (*g_kernel, *g_plain))
    by_seq = {n: seqs.count(n) for n in sorted(set(seqs), reverse=True)}
    n = sum(t.numel() for t in tensors)
    print(f"[{tag}] gradients of {len(names)} trained tensors ({n} values: {names[0]} .. "
          f"{names[-1]}), kernels vs plain attention: rel L2 {rel:.3e} (bound "
          f"{GRAD_REL_L2_BOUND:g}); K1 launches of one forward by sequence length {by_seq}")
    return {"rel": rel, "finite": finite, "by_seq": by_seq}


def _dit_fine_tune(torch, model, config, tag: str, size: int, per_step_attn: dict,
                   k1_by_seq: dict, grad_params, make_batch=None, after_batch=None,
                   steps: int = TRAIN_STEPS, reckoning: str = "") -> dict:
    """A DiT FINE_TUNE in bf16 through the family registry: the setup, the
    cached batch (`make_batch(setup)` when given), `after_batch(setup)`,
    one warm-up step (after which the trained parts must have moved), then
    `steps` timed steps with every launch count zeroed just before them and
    read just after (K1-K3 and the pre-pass `per_step_attn`, K5 one launch
    per chunk of the update), one step with K5's calls captured (against
    the plain rounding; each call's device time), one step's gradients of
    `grad_params(setup)` against plain attention (K1 `k1_by_seq` times by
    sequence length in its forward and backward; skipped when
    `grad_params` is None), a profiler split."""
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.train.sd_train_step import UPDATE_CHUNK_ELEMENTS
    from onetrainer_tpu_torch.train.train_state import param_groups
    family = get_family(config.model_type)
    t0 = time.perf_counter()
    setup = family.create_setup(model, config, 100)
    batch = make_batch(setup) if make_batch is not None else \
        _train_batch(torch, family, setup, config.batch_size, size)
    if after_batch is not None:
        after_batch(setup)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    groups = param_groups(setup.state.params)
    sizes = [t.numel() for g in groups.values() for t in g]
    dtypes = {t.dtype for g in groups.values() for t in g}
    elements = {name: sum(t.numel() for t in g) for name, g in groups.items()}
    k5_per_step = update_launches(sizes)
    print(f"[{tag}] FINE_TUNE of {elements} ({len(sizes)} tensors, {sum(sizes)} elements, "
          f"{dtypes}); Adafactor (the reference's defaults), lr {config.learning_rate:g}, "
          f"clip {config.clip_grad_norm:g}, stochastic rounding, batch {config.batch_size} at "
          f"{size}x{size}, the update in chunks of at most {UPDATE_CHUNK_ELEMENTS} elements "
          f"({k5_per_step} per step); {reckoning}set up in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")

    # the trained parts moved: each group's 4 largest tensors (a small one
    # may keep every element: lr 1e-5 is a fraction of one bf16 step)
    watched = {name: sorted(g, key=lambda t: -t.numel())[:4] for name, g in groups.items()}
    start = {name: [t.detach().clone() for t in ts] for name, ts in watched.items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    metrics = setup.train_step(setup.state, batch, gen)
    first = [metrics["loss"].item(), metrics["grad_norm"].item()]
    warm_s = time.perf_counter() - t0
    moved = {name: sum(not torch.equal(a, t) for a, t in zip(start[name], ts))
             for name, ts in watched.items()}
    del start
    print(f"[{tag}] warm-up step {warm_s:.3f} s: loss {first[0]:.6f} grad_norm "
          f"{first[1]:.6f}; of the 4 largest tensors of each group moved {moved}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    step_s, losses, norms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = setup.train_step(setup.state, batch, gen)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        step_s.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(step_s)
    expected = {**{k: steps * v for k, v in per_step_attn.items()}, "K4": 0,
                "K5": steps * k5_per_step}
    print(f"[{tag}] {steps} timed steps: sec/step median {med:.4f} "
          f"({', '.join(f'{x:.4f}' for x in step_s)}), images/s {config.batch_size / med:.3f}, "
          f"peak max_memory_allocated {peak_gib:.2f} GiB, losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}, grad_norms "
          f"{', '.join(f'{x:.6f}' for x in norms)}, launches {launches} (expected {expected})")

    with _K5Capture(torch, time_reps=3) as capture:
        setup.train_step(setup.state, batch, gen)["loss"].item()
    k5 = _k5_on_the_update(torch, capture)
    set_bound = _bound_ms(0.0, (8 if torch.float32 in k5["u_dtypes"] else 6) * k5["elements"])
    leaf = _k5_largest_leaf(torch, capture)
    card = gpu_line()
    per_launch = ", ".join(f"{c['device_ms']:.4f} ({c['timed_by']})" for c in capture.calls)
    print(f"[{tag}] K5 over the update on {card}: {k5['leaves']} leaves, {k5['elements']} "
          f"elements in {k5['launches']} launches (leaves per launch "
          f"{[c['leaves'] for c in capture.calls]}), u {sorted(str(d) for d in k5['u_dtypes'])}, "
          f"{capture.layout_copies} updates in other strides (copied); bitwise equal to the "
          f"plain rounding on {k5['bitwise']}; every output a bf16 neighbour of p + u "
          f"{k5['neighbours']}, exact where representable {k5['exact']}; device "
          f"{k5['device_ms']:.4f} ms over the update ({per_launch} per launch), least time "
          f"{set_bound[0]:.4f} ms ({set_bound[1]}; "
          f"{100 * set_bound[0] / k5['device_ms']:.1f}% of it), wrapper host time "
          f"{k5['wrapper_host_ms']:.4f} ms over the update's calls ({k5['host_ms']:.4f} ms in "
          f"the step); the largest leaf {leaf['shape']} alone {leaf['ms']:.4f} ms per launch "
          f"({leaf['ms_with_wrapper']:.4f} ms per call with the wrapper), plain "
          f"{leaf['plain_ms']:.4f} ms, least time {leaf['bound_ms']:.4f} ms")
    del capture
    gc.collect()
    torch.cuda.empty_cache()
    grads = None if grad_params is None else \
        _ft_grads_against_plain(torch, setup, batch, tag, grad_params(setup))
    profile_train_step(torch, setup, batch, gen, tag)
    checks = {
        "bf16 parameters": dtypes == {torch.bfloat16},
        "finite": _finite(first + losses + norms) and (grads is None or grads["finite"]),
        "every group moved": all(m == len(watched[n]) for n, m in moved.items()),
        "launches per step": launches == expected,
        "K5 one launch per chunk": k5["launches"] == k5_per_step
        and len(k5["u_dtypes"]) == 1 and k5["leaves"] == len(sizes),
        "K5 bitwise on the named leaves": all(k5["bitwise"].values())
        and {"largest", "1-D", "2-D"} <= {n.split()[0] for n in k5["bitwise"]},
        "K5 neighbours on every leaf": k5["neighbours"] and k5["exact"],
    }
    if grads is not None:
        checks["gradients against plain attention"] = grads["rel"] <= GRAD_REL_L2_BOUND
        checks["K1 per forward and backward"] = grads["by_seq"] == k1_by_seq
    print(f"[{tag}] checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} failed: {[k for k, ok in checks.items() if not ok]}")
    return {"launches": launches, "sec_per_step": med, "peak_gib": peak_gib,
            "k5": dict(ms=leaf["ms"], ms_with_wrapper=leaf["ms_with_wrapper"],
                       plain_ms=leaf["plain_ms"], bound_ms=leaf["bound_ms"],
                       bound_by=leaf["bound_by"], max_abs_err=k5["max_err"],
                       set_ms=k5["device_ms"], set_bound_ms=set_bound[0],
                       set_host_ms=k5["wrapper_host_ms"], leaves=k5["leaves"],
                       elements=k5["elements"], launches_per_update=k5["launches"],
                       u_dtype=sorted(str(d) for d in k5["u_dtypes"]),
                       shape=f"largest leaf of the {tag} update, {k5['largest_numel']} "
                             f"elements")}


def _ft_cli_config(root: str, files: dict):
    """The sd15_ft_cli phase's config: FINE_TUNE of the UNet (fp32 weights,
    bf16 compute), text encoder frozen and cached, AdamW 1e-5, clip 1.0,
    batch 4 at 512x512, masked training (unmasked weight 0.1, area
    normalized), zero-terminal-SNR rescaling (v-prediction), an EMA on the
    card (decay 0.999, every update), gradient accumulation 2, one epoch
    with a backup before the fp16 single-file output."""
    from onetrainer_tpu_torch.util.enums import DataType, EMAMode, ModelFormat, ModelType
    config = _cli_config(root, files["ckpt"], files["dataset"])
    template = _fine_tune_config(ModelType.STABLE_DIFFUSION_15, 4)
    for name in ("training_method", "learning_rate", "clip_grad_norm"):
        setattr(config, name, getattr(template, name))
    config.train_dtype = DataType.BFLOAT_16
    config.weight_dtype = DataType.FLOAT_32
    config.masked_training = True
    config.unmasked_weight = 0.1
    config.normalize_masked_area_loss = True
    config.rescale_noise_scheduler_to_zero_terminal_snr = True
    config.ema = EMAMode.GPU
    config.ema_decay = 0.999
    config.ema_update_step_interval = 1
    config.gradient_accumulation_steps = 2
    config.output_dtype = DataType.FLOAT_16
    config.output_model_format = ModelFormat.SAFETENSORS
    config.output_model_destination = os.path.join(root, "sd15_ft.safetensors")
    return config


def phase_sd15_ft_cli(torch, files: dict) -> dict:
    """Phase 15 (see the module docstring)."""
    from onetrainer_tpu_torch.io import ldm
    from onetrainer_tpu_torch.io.png import read_png
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    from onetrainer_tpu_torch.scripts import sample

    root = os.path.join(os.path.dirname(files["ckpt"]), "fine_tune")
    os.makedirs(root)
    config = _ft_cli_config(root, files)
    paths = []
    for epochs in (1, 2):
        # the resume writes the output and no second backup
        config.epochs, config.continue_last_backup = epochs, epochs == 2
        config.backup_before_save = epochs == 1
        paths.append(os.path.join(root, f"epoch{epochs}.json"))
        with open(paths[-1], "w") as f:
            json.dump(config.to_dict(), f)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    events1, events2 = [], []
    t0 = time.perf_counter()
    first, _ = _cli_run(torch, paths[0], events1)
    first_s = time.perf_counter() - t0
    state = first.setup.state
    after_first = (first.train_progress.global_step, state.opt_state.inner["unet"].count,
                   state.ema.step, state.opt_state.mini_step)
    backup = first.config.get_last_backup_path()
    backup_files = sorted(os.listdir(backup))
    backup_gib = sum(os.path.getsize(os.path.join(backup, f)) for f in backup_files
                     if os.path.isfile(os.path.join(backup, f))) / 2 ** 30
    del first, state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed, _ = _cli_run(torch, paths[1], events2)
    resume_s = time.perf_counter() - t0
    state = resumed.setup.state
    after_resume = (resumed.train_progress.global_step, state.opt_state.inner["unet"].count,
                    state.ema.step, state.opt_state.mini_step)
    source = resumed._source_dir
    before_sample = _launch_counts()
    image_path = os.path.join(root, "sample.png")
    t0 = time.perf_counter()
    out = sample.main(["--model-type", "STABLE_DIFFUSION_15", "--base-model-name",
                       config.output_model_destination,
                       "--prompt", "a photograph of an astronaut riding a horse",
                       "--destination", image_path, "--steps", "4", "--cfg", "7",
                       "--width", str(CLI_SIZE), "--height", str(CLI_SIZE),
                       "--scheduler", "DDIM"])
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    per_step = {"K1": 5, "K2": 5, "K3": 5, "K3pre": 5, "K4": 0, "K5": 0}
    none = {k: 0 for k in per_step}
    steps, cache_launches, _ = _cli_timeline(events1, events2)
    sample_launches = _delta(launches, before_sample)

    # the output: the EMA cast to fp16, bit for bit
    written = ldm.split_sd15_single_file(load_safetensors(config.output_model_destination))
    ema = state.ema.params["unet"]
    ema_bitwise = set(written["unet"]) == set(ema) and all(
        written["unet"][k].dtype == torch.float16
        and torch.equal(written["unet"][k], v.to(torch.float16).cpu()) for k, v in ema.items())
    trained = dict(resumed.model.unet.named_parameters())
    ema_differs = any(not torch.equal(ema[k], trained[k].detach()) for k in ema)
    image = read_png(image_path)
    with torch.no_grad():
        loader = resumed.data_loader
        batch = loader.materialize_batch(loader.batches_for_epoch(0)[0])
    masked_area = float(batch["latent_mask"].mean())
    checks = {
        "launches per micro-step": all(d == per_step for _, d, _ in steps) and len(steps) == 4,
        "none while caching": all(c == none for c in cache_launches)
        and len(cache_launches) == 2,
        "K1 over the sample": sample_launches == {**none, "K1": 20},
        "main-path launches": launches == {
            k: 4 * v + sample_launches[k] for k, v in per_step.items()},
        "steps, updates and EMA updates after epoch 1": after_first == (2, 1, 1, 0),
        "after the resume": after_resume == (4, 2, 2, 0),
        "resumed from the backup's model": source == os.path.join(backup, "model.safetensors"),
        "backup": backup_files == ["ema.safetensors", "meta.json", "model.safetensors",
                                   "onetrainer_config", "optimizer.safetensors"],
        "masks": 0.0 < masked_area < 1.0,
        "v-prediction": resumed.model.prediction_type == "v_prediction",
        "output is the EMA in fp16": ema_bitwise and ema_differs,
        "finite loss": _finite([resumed._loss_ema]),
        "image": image.shape == (CLI_SIZE, CLI_SIZE, 3) and image.std() > 0
        and bool((image == out.image).all()),
    }
    card = gpu_line()
    print(f"[sd15_ft_cli] statuses {[w for k, w, _, _ in events1 if k == 'status']} then "
          f"{[w for k, w, _, _ in events2 if k == 'status']}")
    print(f"[sd15_ft_cli] on {card}: epoch 1 with its backup {first_s:.2f} s, the resume "
          f"with the output {resume_s:.2f} s; backup {backup_gib:.3f} GiB ({backup_files}); "
          f"micro-steps (global step, s): {', '.join(f'{g}: {x:.4f}' for g, _, x in steps)}; "
          f"(global step, optimizer updates, EMA updates, mini step) {after_first} then "
          f"{after_resume}; mean latent mask {masked_area:.4f}; sample {sample_s:.2f} s; "
          f"peak max_memory_allocated {peak_gib:.2f} GiB; launches {launches} (sample "
          f"{sample_launches}); checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sd15_ft_cli failed: "
                             f"{[name for name, ok in checks.items() if not ok]}")
    return {"launches": launches, "peak_gib": peak_gib}


# -- SD3 (phases sd3_model, sd3_sample, sd3_transformer, sd3_train, sd3_cli) -------------

# the transformer forward with K1 against plain attention: 24 joint
# attentions whose outputs differ by bf16 roundings, carried through a bf16
# network of random weights (the UNet's bound)
SD3_REL_L2_BOUND = 5e-2
SD3_CLI_SIZE = 512          # sd15_files' PNGs: 154 + 1024 joint tokens
# the sd3_cli phase's directory: SD3-medium cut to 6 of its 24 joint blocks
# (the script's time limit)
SD3_CLI_BLOCKS = 6


def sd3_lora_layers(blocks: int) -> int:
    """SD3-medium's adapted layers at `blocks` joint blocks: 14 dense layers
    in each block but the context-pre-only last one, 10 in that one, and 9
    outside them (the patch conv, the four time/text embedder layers, the
    context embedder, norm_out and proj_out): 341 at its 24 blocks."""
    return 14 * blocks + 5


def build_sd3_model(torch):
    """SD3-medium at its published widths with seeded weights on the card:
    the MMDiT (24 blocks of 24 d=64 heads, 1536 wide, pos_embed_max_size
    192), CLIP-L and CLIP-G (both projected), T5-XXL (24 layers, d_model
    4096, 64 heads, d_ff 10240) and the 16-channel VAE; fp32 parameters,
    bf16 compute, the reference loader's checkpoint policy (dots_nb_attn)."""
    from onetrainer_tpu_torch.io.weights import init_sd3_weights
    from onetrainer_tpu_torch.models.remat import SD3_POLICY
    from onetrainer_tpu_torch.models.sd3_model import create_sd3_model
    from onetrainer_tpu_torch.util.enums import ModelType
    t0 = time.perf_counter()
    model = create_sd3_model(ModelType.STABLE_DIFFUSION_3, dtype=torch.bfloat16,
                             gradient_checkpointing=True,
                             remat_policy=SD3_POLICY, device="meta")
    init_sd3_weights(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in model.modules().items()}
    print(f"[sd3_model] SD3-medium, parameters counted on the card {counts} (total "
          f"{sum(counts.values())}; fp32, compute bf16, checkpoint policy "
          f"{model.transformer_config.remat_policy}), seeded in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB allocated")
    return model


def phase_sd3_transformer(torch, model):
    """One full-width transformer forward (latent 2x128x128x16, 154-row
    context) with K1 and with plain attention: K1 once per block, relative
    L2 of the outputs."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    latents = torch.randn((2, 128, 128, 16), generator=gen, device="cuda")
    context = torch.randn((2, 154, 4096), generator=gen, device="cuda")
    pooled = torch.randn((2, 2048), generator=gen, device="cuda")
    ts = torch.tensor([250.0, 750.0], device="cuda")

    def forward():
        with torch.inference_mode():
            out = model.transformer(latents, ts, pooled, context)
        torch.cuda.synchronize()
        return out

    run = _k1_and_plain(torch, forward)
    launches = run["launches"]["K1"]
    ok = (run["finite"] and run["rel"] <= SD3_REL_L2_BOUND and launches == SD3_BLOCKS
          and tuple(run["out"].shape) == (2, 128, 128, 16))
    print(f"[sd3_transformer] full-width SD3 MMDiT forward, latent 2x128x128x16, context "
          f"154 rows (joint attention over 4250 tokens): K1 {run['k1_s'] * 1e3:.2f} ms "
          f"({launches} K1 launches, expected {SD3_BLOCKS}), plain attention "
          f"{run['plain_s'] * 1e3:.2f} ms, rel L2 {run['rel']:.3e} (bound "
          f"{SD3_REL_L2_BOUND:g}), peak max_memory_allocated {run['peak_gib']:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the SD3 transformer with K1 disagrees with plain attention")


def phase_sd3_train(torch, model) -> dict:
    """bench.py's _bench_sd3 as a LoRA step (see the module docstring):
    exact K1, K2, K3 and pre-pass launches per step, the LoRA gradients
    against plain attention, a profiler split. The text encoders are freed
    once the batch is cached."""
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    config = _lora_config(2, ModelType.STABLE_DIFFUSION_3)
    config.prior.weight_dtype = DataType.FLOAT_8
    # the loader's cast of a quantized part, which the setup then quantizes
    model.transformer.to(config.weight_dtypes().prior.to_load_dtype())

    def free_encoders(setup):
        model.text_encoder = model.text_encoder_2 = model.text_encoder_3 = None
        gc.collect()
        torch.cuda.empty_cache()

    run = _setup_and_steps(torch, model, config, "sd3_train", 1024, after_batch=free_encoders)
    setup, batch = run["setup"], run["batch"]
    fp8 = sum(getattr(getattr(m, "weight", None), "q", None) is not None
              and m.weight.q.dtype == torch.float8_e4m3fn for m in model.transformer.modules())
    # dots_nb_attn: the attention runs outside each block's recomputed
    # halves, so its forward (K1) runs once per block and step, not twice
    n = TRAIN_STEPS * SD3_BLOCKS
    expected = {"K1": n, "K2": n, "K3": n, "K3pre": n, "K4": 0, "K5": 0}
    grads = _grads_against_plain(torch, setup, batch, "sd3_train")
    ok = (run["finite"] and grads["finite"] and run["up_max"] > 0
          and run["launches"] == expected and grads["by_seq"] == {4250: SD3_BLOCKS}
          and grads["rel"] <= GRAD_REL_L2_BOUND and fp8 > 0
          and len(setup.state.params["transformer_lora"]) == sd3_lora_layers(SD3_BLOCKS)
          and setup.model.prediction_type == "flow")
    print(f"[sd3_train] {fp8} transformer layers hold e4m3 weights; checkpoint policy "
          f"{model.transformer_config.remat_policy} (the attention outside the recomputed "
          f"halves: K1 once per block and step); launches {run['launches']} (expected "
          f"{expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sd3_train failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], "sd3_train")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"]}


# the fine-tunes' images: 1024x1024, as bench.py's SD3 stage and flux_train
DIT_FT_SIZE = 1024


def _dit_ft_config(model_type, batch_size: int, train_te: bool):
    """FINE_TUNE of the transformer (`prior`) and, with `train_te`, CLIP-L,
    both in bf16, the other text encoders frozen; Adafactor (the
    reference's defaults) with stochastic rounding, lr 1e-5, clip 1.0."""
    from onetrainer_tpu_torch.util.enums import DataType, Optimizer
    config = _fine_tune_config(model_type, batch_size)
    config.prior.train = True
    config.prior.weight_dtype = DataType.BFLOAT_16
    config.text_encoder.train = train_te
    config.text_encoder.weight_dtype = DataType.BFLOAT_16
    config.optimizer.optimizer = Optimizer.ADAFACTOR
    config.optimizer.stochastic_rounding = True
    return config


def _gib(n_elements: int, nbytes: int = 2) -> float:
    return n_elements * nbytes / 2 ** 30


def phase_sd3_ft(torch, model) -> dict:
    """sd3_ft: SD3-medium's FINE_TUNE at full width and depth in bf16 (see
    the module docstring), on sd3_model's weights cast to bf16 (the
    loader's cast of every part to the transformer's weight dtype)."""
    from onetrainer_tpu_torch.util.enums import ModelType
    config = _dit_ft_config(ModelType.STABLE_DIFFUSION_3, 2, train_te=True)
    for module in model.modules().values():
        module.to(torch.bfloat16)
    torch.cuda.empty_cache()
    per_step = {"K1": SD3_BLOCKS, "K2": SD3_BLOCKS, "K3": SD3_BLOCKS, "K3pre": SD3_BLOCKS}
    n = sum(p.numel() for name in ("transformer", "text_encoder")
            for p in model.modules()[name].parameters())
    reckoning = (f"weights, gradients and the update {3 * _gib(n):.2f} GiB in bf16 beside "
                 f"CLIP-G and T5-XXL (frozen, live) ")

    def every_trained_tensor(setup):
        return {f"{group}.{name}": t for group, tensors in setup.state.params.items()
                for name, t in tensors.items()}

    return _dit_fine_tune(torch, model, config, "sd3_ft", DIT_FT_SIZE, per_step,
                          {4250: SD3_BLOCKS}, every_trained_tensor, reckoning=reckoning)


def sd3_config_jsons(model) -> dict:
    """Each component's config.json (diffusers' and transformers' keys) for
    a diffusers SD3 directory of the port's `model`."""
    t, v, t5 = model.transformer_config, model.vae_config, model.te3_config

    def clip(c):
        return {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                "intermediate_size": c.intermediate_size, "num_hidden_layers": c.num_layers,
                "num_attention_heads": c.num_heads,
                "max_position_embeddings": c.max_position_embeddings,
                "hidden_act": c.hidden_act, "eos_token_id": c.eos_token_id,
                "projection_dim": c.projection_dim,
                "architectures": ["CLIPTextModelWithProjection"]}
    return {
        "transformer": {
            "sample_size": t.sample_size, "patch_size": t.patch_size,
            "in_channels": t.in_channels, "out_channels": t.out_channels,
            "num_layers": t.num_layers, "num_attention_heads": t.num_heads,
            "attention_head_dim": t.head_dim, "joint_attention_dim": t.joint_attention_dim,
            "caption_projection_dim": t.caption_projection_dim,
            "pooled_projection_dim": t.pooled_projection_dim,
            "pos_embed_max_size": t.pos_embed_max_size,
            "qk_norm": "rms_norm" if t.qk_norm else None, "dual_attention_layers": []},
        "vae": {"in_channels": v.in_channels, "out_channels": v.out_channels,
                "latent_channels": v.latent_channels,
                "block_out_channels": list(v.block_out_channels),
                "layers_per_block": v.layers_per_block, "scaling_factor": v.scaling_factor,
                "shift_factor": v.shift_factor},
        "text_encoder": clip(model.te_config), "text_encoder_2": clip(model.te2_config),
        "text_encoder_3": {"vocab_size": t5.vocab_size, "d_model": t5.d_model,
                           "d_kv": t5.d_kv, "d_ff": t5.d_ff, "num_layers": t5.num_layers,
                           "num_heads": t5.num_heads},
    }


def sd3_files(torch, root: str) -> str:
    """A seeded SD3-medium at full width, cut to SD3_CLI_BLOCKS joint blocks
    and T5-XXL to CUT_T5_LAYERS layers, written as an fp16 diffusers
    directory in `root` -> its path."""
    from onetrainer_tpu_torch.io.sd3_checkpoints import save_sd3_diffusers
    from onetrainer_tpu_torch.io.sd_checkpoints import state_dict_of
    from onetrainer_tpu_torch.util.enums import ModelType
    model = build_cut_dit(torch, ModelType.STABLE_DIFFUSION_3, (SD3_CLI_BLOCKS,),
                          CUT_T5_LAYERS)
    ckpt = os.path.join(root, "sd3-medium")
    t0 = time.perf_counter()
    m = model.modules()
    save_sd3_diffusers(ckpt, model, *(state_dict_of(m[name]) for name in (
        "transformer", "vae", "text_encoder", "text_encoder_2", "text_encoder_3")),
        save_dtype=torch.float16)
    for name, config in sd3_config_jsons(model).items():
        with open(os.path.join(ckpt, name, "config.json"), "w") as f:
            json.dump(config, f)
    write_s = time.perf_counter() - t0
    del model, m
    gc.collect()
    torch.cuda.empty_cache()
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt) for f in fs)
    print(f"[sd3_files] wrote {ckpt} ({size / 2 ** 30:.3f} GiB, fp16, diffusers layout, "
          f"{SD3_CLI_BLOCKS} joint blocks, T5 {CUT_T5_LAYERS} layers) in {write_s:.2f} s")
    return ckpt


def _dit_lora_cli(torch, tag: str, ckpt: str, dataset: str, model_type, size: int,
                  per_step: dict, lora_layers: int, cache_shapes: dict, sample_argv: list,
                  sample_k1: int, policy: str, load_note: str, prior_dtype=None,
                  denoiser: str = "transformer", configure=None) -> dict:
    """A family's LoRA r16 a16 on its `denoiser` ("transformer" or "unet")
    from a checkpoint through the train and sample commands: size x size,
    batch 4 over sd15_files' eight PNGs, bf16 weights (the transformer in
    `prior_dtype` when given), gradient checkpointing on (the loader's
    `policy`), then `configure(config)` when given, epoch 1 with a backup,
    the resume for epoch 2, the LoRA file read back bitwise and its reload
    loss, the sample command (`sample_argv` past the model and the
    destination). Exactly `per_step` launches per step and none while
    caching, `sample_k1` K1 over the sample; the cache's rows of
    `cache_shapes`; `lora_layers` adapted layers."""
    from onetrainer_tpu_torch.io.png import read_png
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    from onetrainer_tpu_torch.peft.lora import kohya_state_dict_to_peft, peft_module_keys
    from onetrainer_tpu_torch.scripts import sample
    from onetrainer_tpu_torch.util.enums import DataType, GradientCheckpointingMethod

    root = os.path.join(os.path.dirname(ckpt), "lora")
    os.makedirs(root)
    config = _cli_config(root, ckpt, dataset)
    config.model_type = model_type
    config.resolution = str(size)
    config.weight_dtype = DataType.BFLOAT_16
    if prior_dtype is not None:
        config.prior.weight_dtype = prior_dtype
    config.gradient_checkpointing = GradientCheckpointingMethod.ON
    if configure is not None:
        configure(config)
    config_path = os.path.join(root, "epoch1.json")
    with open(config_path, "w") as f:
        json.dump(config.to_dict(), f)
    config.epochs = 2
    config.continue_last_backup = True
    resume_path = os.path.join(root, "epoch2.json")
    with open(resume_path, "w") as f:
        json.dump(config.to_dict(), f)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    events1, events2 = [], []
    first, _ = _cli_run(torch, config_path, events1)
    step_after_first = first.train_progress.global_step
    loss_first = first._loss_ema
    del first
    gc.collect()
    torch.cuda.empty_cache()
    resumed, prof = _cli_run(torch, resume_path, events2, profiled_step=4)
    # PixArt's and Sana's blocks run one policy, "full" (models/remat.py)
    loaded_policy = getattr(getattr(resumed.model, f"{denoiser}_config"), "remat_policy",
                            "full")
    train_launches = _launch_counts()
    image_path = os.path.join(root, "sample.png")
    lora = load_safetensors(config.output_model_destination)
    adapters = resumed.setup.state.params[f"{denoiser}_lora"]
    keys = peft_module_keys(getattr(resumed.model, denoiser), resumed.setup.peft_cfg,
                            getattr(resumed.setup, "lora_key_maps", {}).get(f"{denoiser}_lora"))
    read, alpha = kohya_state_dict_to_peft(lora, f"lora_{denoiser}", keys)
    bitwise = (set(read) == set(adapters) and alpha == resumed.setup.peft_cfg.alpha
               and all(torch.equal(read[k][n], t.detach().cpu())
                       for k, e in adapters.items() for n, t in e.items()))
    with torch.no_grad():
        for key, entry in adapters.items():
            for name, t in entry.items():
                t.copy_(read[key][name])
        loader = resumed.data_loader
        batch = loader.materialize_batch(loader.batches_for_epoch(0)[0])
        gen = torch.Generator(device="cuda").manual_seed(3)
        reload_loss = resumed.setup.train_step.loss(batch, gen).item()
    n_adapters, resumed_loss = len(adapters), resumed._loss_ema
    step_after_resume = resumed.train_progress.global_step
    del resumed, adapters, read, batch, loader
    gc.collect()
    torch.cuda.empty_cache()
    before_sample = _launch_counts()   # the reload loss's forward left out
    t0 = time.perf_counter()
    out = sample.main(["--model-type", model_type.value, "--base-model-name", ckpt,
                       "--prompt", "a photograph of an astronaut riding a horse",
                       "--destination", image_path, "--steps", "4",
                       "--width", str(size), "--height", str(size),
                       "--weight-dtype", "BFLOAT_16"] + sample_argv)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    sample_launches = _delta(_launch_counts(), before_sample)
    launches = {k: train_launches[k] + sample_launches[k] for k in train_launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    none = {k: 0 for k in per_step}
    steps, cache_launches, times = _cli_timeline(events1, events2)
    step_s = [s for global_step, _, s in steps if global_step != 4]   # 4: profiled
    sums, _, _ = _kernel_times(prof)
    device_ms = sum(sums.values())
    profiled_ms = steps[-1][2] * 1e3
    cache_files = [os.path.join(config.cache_dir, f) for f in os.listdir(config.cache_dir)]
    rows = [load_safetensors(f) for f in cache_files]
    cached = (len(rows) == CLI_IMAGES
              and all(name in r and tuple(r[name].shape) == shape for r in rows
                      for name, shape in cache_shapes.items()))
    image = read_png(image_path)
    checks = {
        "policy": loaded_policy == policy,
        "launches per step": all(d == per_step for _, d, _ in steps) and len(steps) == 4,
        "none while caching": all(c == none for c in cache_launches)
        and len(cache_launches) == 2,
        "K1 over the sample": sample_launches == {**none, "K1": sample_k1},
        "main-path launches": train_launches == {k: 4 * v for k, v in per_step.items()},
        "global steps": (step_after_first, step_after_resume) == (2, 4),
        "cache": cached,
        "LoRA keys": n_adapters == lora_layers and len(lora) == 3 * lora_layers,
        "LoRA read back bitwise": bitwise,
        "finite losses": _finite([loss_first, resumed_loss, reload_loss]),
        "image": image.shape == (size, size, 3) and image.std() > 0
        and bool((image == out.image).all()),
    }
    card = gpu_line()
    print(f"[{tag}] statuses {[w for k, w, _, _ in events1 if k == 'status']} then "
          f"{[w for k, w, _, _ in events2 if k == 'status']}")
    print(f"[{tag}] on {card}: load {', '.join(f'{x:.2f}' for x in times['load_s'])} s "
          f"({load_note}, run 1 and the resume); caching {times['cache_s'][0]:.3f} s for "
          f"{CLI_IMAGES} images (the resume {times['cache_s'][1]:.3f} s, all cached)")
    print(f"[{tag}] on {card}: steps (global step, s): "
          f"{', '.join(f'{g}: {s:.4f}' for g, _, s in steps)}; CLI step median "
          f"{statistics.median(step_s):.4f} s over the unprofiled steps (the first includes "
          f"the warm-up); step 4 under torch.profiler: host {profiled_ms:.3f} ms, device "
          f"{device_ms:.3f} ms ({100 * device_ms / profiled_ms:.1f}% busy)")
    sampler = "DDIM" if denoiser == "unet" or model_type.is_pixart() else \
        "DDPM-Würstchen" if model_type.is_wuerstchen() else "flow Euler"
    print(f"[{tag}] on {card}: sample (load + 4 {sampler} steps + decode + PNG) "
          f"{sample_s:.2f} s; peak max_memory_allocated {peak_gib:.2f} GiB; launches "
          f"{launches} (sample {sample_launches}); LoRA file {len(lora)} keys, reload loss "
          f"{reload_loss:.6f}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} failed: "
                             f"{[name for name, ok in checks.items() if not ok]}")
    return {"launches": launches, "step_s": statistics.median(step_s), "peak_gib": peak_gib}


def phase_sd15_inpaint_cli(torch, files: dict) -> dict:
    """SD 1.5 inpainting from files through the train and sample commands:
    a seeded full-width SD 1.5-inpainting UNet (9 input channels) written
    beside sd15_files' checkpoint as one fp16 single file, sd15_files' PNGs
    (not at their bucket's size) with their masks and the one
    `-condlabel.png` (custom conditioning images on), unmasked probability
    0.1; LoRA r16 a16 at batch 4, 512x512, fp32 weights in bf16, no
    gradient checkpointing: exactly K1, K2, K3 and the pre-pass 5 each per
    step, none while caching; the cache's rows carry the conditioning
    latent and the mask; then `--sample-inpainting` at 512x512 from a base
    image and mask at 600x560 (4 DDIM steps, 20 K1)."""
    from onetrainer_tpu_torch.io.sd_checkpoints import save_sd_single_file, state_dict_of
    from onetrainer_tpu_torch.util.enums import GradientCheckpointingMethod, ModelType
    root = os.path.join(os.path.dirname(files["ckpt"]), "inpaint")
    os.makedirs(root)
    model = build_model(torch, None, ModelType.STABLE_DIFFUSION_15_INPAINTING)
    ckpt = os.path.join(root, "sd15-inpainting.safetensors")
    t0 = time.perf_counter()
    save_sd_single_file(ckpt, model, *(state_dict_of(m) for m in
                                       (model.unet, model.vae, model.text_encoder)),
                        save_dtype=torch.float16)
    print(f"[sd15_inpaint_files] wrote {ckpt} ({os.path.getsize(ckpt) / 2 ** 30:.3f} GiB, "
          f"fp16, conv_in {tuple(model.unet.conv_in.weight.shape)}) in "
          f"{time.perf_counter() - t0:.2f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    base, mask = inpaint_inputs(torch, root, *CLI_PNG_SIZE)

    def configure(config):
        config.gradient_checkpointing = GradientCheckpointingMethod.OFF
        config.custom_conditioning_image = True
        config.unmasked_probability = 0.1

    per_step = {"K1": 5, "K2": 5, "K3": 5, "K3pre": 5, "K4": 0, "K5": 0}
    latent = CLI_SIZE // 8
    return _dit_lora_cli(
        torch, "sd15_inpaint_cli", ckpt, files["dataset"],
        ModelType.STABLE_DIFFUSION_15_INPAINTING, CLI_SIZE, per_step, SD15_LORA_LAYERS,
        {"latent_image": (latent, latent, 4), "latent_conditioning_image": (latent, latent, 4),
         "latent_mask": (latent, latent, 1), "text_encoder_hidden_state": (77, 768)},
        ["--cfg", "7", "--sample-inpainting", "--base-image-path", base,
         "--mask-image-path", mask], 4 * 5, "tx_only",
        "fp16 single file to bf16 on the card", denoiser="unet", configure=configure)


def phase_sd3_cli(torch, ckpt: str, dataset: str) -> dict:
    """SD3 from a diffusers directory through the train and sample commands
    (`_dit_lora_cli`) at 512x512; the sample at CFG 7. Exactly K1-K3 and the
    pre-pass once per block and step (the joint attention at 154 + 1024
    tokens: dots_nb_attn keeps it out of the recompute), SD3_CLI_BLOCKS
    blocks."""
    from onetrainer_tpu_torch.util.enums import ModelType
    blocks = SD3_CLI_BLOCKS
    per_step = {"K1": blocks, "K2": blocks, "K3": blocks, "K3pre": blocks, "K4": 0, "K5": 0}
    latent = SD3_CLI_SIZE // 8
    result = _dit_lora_cli(
        torch, "sd3_cli", ckpt, dataset, ModelType.STABLE_DIFFUSION_3, SD3_CLI_SIZE,
        per_step, sd3_lora_layers(blocks),
        {"latent_image": (latent, latent, 16), "sd3_context": (154, 4096),
         "sd3_pooled": (2048,)}, ["--cfg", "7"], 4 * blocks, "dots_nb_attn",
        "fp16 diffusers directory to bf16 on the card")
    gc.collect()
    torch.cuda.empty_cache()
    result["embedding_launches"] = _embedding_cli(
        torch, "sd3_cli", ckpt, dataset, ModelType.STABLE_DIFFUSION_3, SD3_CLI_SIZE, per_step,
        {"clip_l", "clip_g", "t5", "clip_l_out", "clip_g_out", "t5_out"},
        configure=_cli_weights())
    return result


# FLUX.1-dev: 19 double-stream and 38 single-stream blocks, one attention
# each; 77 + 4096 = 4173 joint tokens at 1024x1024, 77 + 1024 = 1101 at 512
FLUX_DOUBLE, FLUX_SINGLE = 19, 38
FLUX_BLOCKS = FLUX_DOUBLE + FLUX_SINGLE
FLUX_TOKENS = 77 + 4096
FLUX_GUIDANCE = 3.5         # the sampling guidance FLUX.1-dev's card suggests
FLUX_FILL_GUIDANCE = 30.0   # the guidance BFL's FLUX.1-Fill-dev card suggests
# the flux_cli phase's diffusers directory: FLUX.1-dev's widths, its
# transformer cut to 2 double and 4 single blocks (the full one is a 23.8 GB
# bf16 file to write and read three times)
FLUX_CLI_DOUBLE, FLUX_CLI_SINGLE = 2, 4
FLUX_CLI_SIZE = 512


def flux_nf4_layers(double: int, single: int) -> tuple[int, int]:
    """(NF4 layers of a FLUX transformer, those inside its blocks): every
    dense layer is quantized (the smallest, proj_out, has 3072 x 64 =
    196,608 >= 4096 elements): 14 per double block, 6 per single block, and
    10 outside them (x_embedder, context_embedder, the time, guidance and
    text embedders' six layers, norm_out, proj_out). Under "full"
    checkpointing a step dequantizes the ones in the blocks twice."""
    in_blocks = 14 * double + 6 * single
    return in_blocks + 10, in_blocks


def build_flux_model(torch, double: int = FLUX_DOUBLE, single: int = FLUX_SINGLE,
                     quantize: bool = True, model_type=None):
    """FLUX.1-dev (FLUX.1-Fill-dev for FLUX_FILL_DEV_1: a 384-wide
    x_embedder) at its published widths with seeded weights on the card
    (`double` + `single` blocks of 24 d=128 heads, hidden 3072, RoPE axes
    (16, 56, 56), the guidance embedding; CLIP-L; T5-XXL; the 16-channel
    VAE, scaling 0.3611 and shift 0.1159), bf16 compute, the reference's
    FLUX checkpoint policy ("full"). The transformer is built in bf16 (its
    fp32 parameters would be 47.6 GB) and, with `quantize`, quantized to NF4
    through the setup's policy (setup/quantize.py, the prior's weight dtype
    NFLOAT_4) layer by layer; the other parts are fp32 (bf16 without
    `quantize`: the CLI phase's files)."""
    from dataclasses import replace

    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.io.weights import init_flux_weights
    from onetrainer_tpu_torch.models.flux import FluxTransformer2D
    from onetrainer_tpu_torch.models.flux_model import create_flux_model
    from onetrainer_tpu_torch.models.remat import FLUX_POLICY
    from onetrainer_tpu_torch.ops.quant import is_quantized
    from onetrainer_tpu_torch.setup.quantize import quantize_frozen_parts
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    model_type = model_type or ModelType.FLUX_DEV_1
    label = "FLUX.1-Fill-dev" if model_type == ModelType.FLUX_FILL_DEV_1 else "FLUX.1-dev"
    tag = "flux_fill_model" if model_type == ModelType.FLUX_FILL_DEV_1 else "flux_model"
    t0 = time.perf_counter()
    model = create_flux_model(model_type, dtype=torch.bfloat16,
                              gradient_checkpointing=True, remat_policy=FLUX_POLICY,
                              device="meta")
    if (double, single) != (FLUX_DOUBLE, FLUX_SINGLE):
        model.transformer_config = replace(model.transformer_config, num_layers=double,
                                           num_single_layers=single)
        with torch.device("meta"):
            model.transformer = FluxTransformer2D(model.transformer_config)
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in model.modules().items()}
    for name, module in model.modules().items():
        if name == "transformer" or not quantize:
            module.to(torch.bfloat16)    # on "meta": no memory yet
    init_flux_weights(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    built_gib = torch.cuda.memory_allocated() / 2 ** 30
    line = (f"[{tag}] {label} ({double} double, {single} single blocks, x_embedder "
            f"{tuple(model.transformer.x_embedder.weight.shape)}), parameters "
            f"{counts} (total {sum(counts.values())}), seeded on the card in {init_s:.2f} s, "
            f"{built_gib:.2f} GiB allocated")
    if not quantize:
        print(line + " (all bf16)")
        return model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    config = TrainConfig.default_values()
    config.prior.weight_dtype = DataType.NFLOAT_4
    quantize_frozen_parts({"transformer": model.transformer}, config.weight_dtypes(),
                          {"transformer": "prior"})
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    layers = [m for m in model.transformer.modules() if is_quantized(getattr(m, "weight", None))]
    nf4_gib = sum(m.weight.q.numel() + 4 * m.weight.scales.numel() for m in layers) / 2 ** 30
    expected = flux_nf4_layers(double, single)[0]
    after_gib = torch.cuda.memory_allocated() / 2 ** 30
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{line} (transformer bf16, the rest fp32); transformer quantized to NF4 in "
          f"{quant_s:.2f} s: {len(layers)} NF4 layers (expected {expected}), "
          f"{nf4_gib:.3f} GiB of codes and scales; after it {after_gib:.2f} GiB allocated, "
          f"peak while quantizing {peak_gib:.2f} GiB")
    if len(layers) != expected:
        raise AssertionError(f"{len(layers)} NF4 layers, expected {expected}")
    return model


def _flux_block_inputs(torch, model, batch: int):
    """Hidden states, conditioning and RoPE tables of one FLUX block at
    1024x1024: image [B, 4096, 3072] and text [B, 77, 3072] rows, temb from
    the model's own time/guidance/text embedder."""
    from onetrainer_tpu_torch.models.flux import prepare_latent_image_ids, rope_tables
    cfg = model.transformer_config
    gen = torch.Generator(device="cuda").manual_seed(19)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    img, txt = rand(batch, 4096, cfg.hidden_size), rand(batch, 77, cfg.hidden_size)
    with torch.inference_mode():
        temb = model.transformer.time_text_embed(
            torch.tensor([0.25, 0.75][:batch], device="cuda"),
            torch.full((batch,), FLUX_GUIDANCE, device="cuda"),
            torch.randn((batch, cfg.pooled_projection_dim), generator=gen, device="cuda"))
    ids = torch.cat([torch.zeros((77, 3), device="cuda"),
                     prepare_latent_image_ids(128, 128, "cuda")])
    return img, txt, temb, rope_tables(ids, cfg.axes_dims_rope, cfg.rope_theta)


def phase_flux_transformer(torch, model):
    """The NF4 transformer's first double and first single block at full
    width (batch 2, 4173 joint tokens) with K1 and with plain attention:
    K1 once per block, K4 once per layer, relative L2 of the output."""
    t = model.transformer
    img, txt, temb, rope = _flux_block_inputs(torch, model, 2)

    def forward():
        with torch.inference_mode():
            i, x = t.transformer_blocks[0](img, txt, temb, rope)
            out = t.single_transformer_blocks[0](torch.cat([x, i], dim=1), temb, rope)
        torch.cuda.synchronize()
        return out

    run = _k1_and_plain(torch, forward)
    expected = {"K1": 2, "K2": 0, "K3": 0, "K3pre": 0, "K4": 14 + 6, "K5": 0}
    ok = (run["finite"] and run["rel"] <= SD3_REL_L2_BOUND and run["launches"] == expected
          and tuple(run["out"].shape) == (2, FLUX_TOKENS, 3072))
    print(f"[flux_transformer] FLUX.1-dev double block 0 + single block 0, NF4, batch 2 over "
          f"{FLUX_TOKENS} joint tokens (24 heads of d=128): K1 {run['k1_s'] * 1e3:.2f} ms "
          f"(launches {run['launches']}, expected {expected}), plain attention "
          f"{run['plain_s'] * 1e3:.2f} ms, rel L2 {run['rel']:.3e} (bound "
          f"{SD3_REL_L2_BOUND:g}), peak max_memory_allocated {run['peak_gib']:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the FLUX blocks with K1 disagree with plain attention")


def phase_flux_train(torch, model) -> dict:
    """LoRA r16 a16 on all 504 dense layers of the NF4 transformer, fp32
    adapters, AdamW 1e-4, clip 1.0, batch 2 at 1024x1024 through the port's
    caches (one seeded image and prompt through the VAE, CLIP-L and T5,
    which are then freed), "full" checkpointing, guidance 1 (the config's
    default): one warm-up and TRAIN_STEPS timed steps with exact launches per
    step (K1 twice per block, K2, K3 and the pre-pass once, K4 once per NF4
    layer and again per layer inside the recomputed blocks), the LoRA
    gradients against plain attention and the plain dequant, a profiler
    split."""
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    config = _lora_config(2, ModelType.FLUX_DEV_1)
    config.prior.weight_dtype = DataType.NFLOAT_4

    def free_encoders(setup):
        model.text_encoder = model.text_encoder_2 = None
        gc.collect()
        torch.cuda.empty_cache()

    run = _setup_and_steps(torch, model, config, "flux_train", 1024, after_batch=free_encoders)
    setup, batch = run["setup"], run["batch"]
    n_quant, n_in_blocks = flux_nf4_layers(FLUX_DOUBLE, FLUX_SINGLE)
    n = TRAIN_STEPS * FLUX_BLOCKS
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n,
                "K4": TRAIN_STEPS * (n_quant + n_in_blocks), "K5": 0}
    grads = _grads_against_plain(torch, setup, batch, "flux_train", plain_dequant=True)
    ok = (run["finite"] and grads["finite"] and run["up_max"] > 0
          and run["launches"] == expected and grads["by_seq"] == {FLUX_TOKENS: 2 * FLUX_BLOCKS}
          and grads["rel"] <= GRAD_REL_L2_BOUND
          and len(setup.state.params["transformer_lora"]) == n_quant
          and model.transformer_config.remat_policy == "full"
          and setup.model.prediction_type == "flow")
    print(f"[flux_train] {n_quant} NF4 layers ({n_in_blocks} in the blocks), all adapted; "
          f"checkpoint policy {model.transformer_config.remat_policy} (the blocks recompute: "
          f"K1 twice per block and step, K4 {n_quant + n_in_blocks} per step); launches "
          f"{run['launches']} (expected {expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flux_train failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], "flux_train")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"]}


def phase_flux_fill_train(torch, model) -> dict:
    """flux_train on FLUX.1-Fill-dev: the same LoRA, batch, checkpointing
    and optimizer, the batch's cache rows with the conditioning latent
    [2, 128, 128, 16] and the 64-channel mask [2, 128, 128, 64] beside the
    latents (the transformer takes 64 + 64 + 256 = 384 packed channels):
    the same launches per step as flux_train (x_embedder is one of the 504
    NF4 layers), the LoRA gradients against plain attention and the plain
    dequant, a profiler split."""
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    config = _lora_config(2, ModelType.FLUX_FILL_DEV_1)
    config.prior.weight_dtype = DataType.NFLOAT_4
    family = get_family(config.model_type)
    widths = []

    def free_encoders(setup):
        model.text_encoder = model.text_encoder_2 = None
        gc.collect()
        torch.cuda.empty_cache()

    hook = model.transformer.register_forward_pre_hook(
        lambda module, args: widths.append(args[0].shape[-1]))
    try:
        run = _setup_and_steps(
            torch, model, config, "flux_fill_train", 1024, after_batch=free_encoders,
            make_batch=lambda setup: _inpaint_batch(torch, family, setup, 2, 1024))
    finally:
        hook.remove()
    setup, batch = run["setup"], run["batch"]
    n_quant, n_in_blocks = flux_nf4_layers(FLUX_DOUBLE, FLUX_SINGLE)
    n = TRAIN_STEPS * FLUX_BLOCKS
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n,
                "K4": TRAIN_STEPS * (n_quant + n_in_blocks), "K5": 0}
    grads = _grads_against_plain(torch, setup, batch, "flux_fill_train", plain_dequant=True)
    rows = {k: tuple(batch[k].shape) for k in ("latent_image", "latent_conditioning_image",
                                              "latent_mask")}
    ok = (run["finite"] and grads["finite"] and run["up_max"] > 0
          and run["launches"] == expected and grads["by_seq"] == {FLUX_TOKENS: 2 * FLUX_BLOCKS}
          and grads["rel"] <= GRAD_REL_L2_BOUND and set(widths) == {384}
          and rows == {"latent_image": (2, 128, 128, 16),
                       "latent_conditioning_image": (2, 128, 128, 16),
                       "latent_mask": (2, 128, 128, 64)}
          and len(setup.state.params["transformer_lora"]) == n_quant
          and "x_embedder" in setup.state.params["transformer_lora"])
    print(f"[flux_fill_train] cache rows {rows}; transformer input widths {sorted(set(widths))}; "
          f"{n_quant} NF4 layers, all adapted (x_embedder 384 x 3072 among them); launches "
          f"{run['launches']} (expected {expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flux_fill_train failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], "flux_fill_train")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"]}


def phase_flux_ft(torch, model) -> dict:
    """flux_ft: FLUX.1-dev's FINE_TUNE at full width and depth in bf16 (see
    the module docstring): the transformer trained, text cached, T5 and
    the VAE freed once the batch is cached; the gradients against plain
    attention taken for the first double block, the last single block,
    x_embedder and proj_out (every attention of the network lies on their
    backward path)."""
    from onetrainer_tpu_torch.train.sd_train_step import UPDATE_CHUNK_ELEMENTS
    from onetrainer_tpu_torch.util.enums import ModelType
    config = _dit_ft_config(ModelType.FLUX_DEV_1, 1, train_te=False)
    n = sum(p.numel() for p in model.transformer.parameters())
    chunk = min(n, UPDATE_CHUNK_ELEMENTS)
    reckoning = (f"the reckoning: weights {_gib(n):.2f} + gradients {_gib(n):.2f} + one chunk "
                 f"of updates {_gib(chunk):.2f} GiB (all at once: {3 * _gib(n):.2f}) of "
                 f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f} GiB; ")

    def free_encoders(setup):
        model.text_encoder_2 = model.vae = None

    def watched(setup):
        last = f"single_transformer_blocks.{FLUX_SINGLE - 1}."
        return {name: t for name, t in setup.state.params["transformer"].items()
                if name.startswith(("transformer_blocks.0.", last, "x_embedder.",
                                    "proj_out."))}

    per_step = {"K1": 2 * FLUX_BLOCKS, "K2": FLUX_BLOCKS, "K3": FLUX_BLOCKS,
                "K3pre": FLUX_BLOCKS}
    return _dit_fine_tune(torch, model, config, "flux_ft", DIT_FT_SIZE, per_step,
                          {FLUX_TOKENS: 2 * FLUX_BLOCKS}, watched, after_batch=free_encoders,
                          reckoning=reckoning)


def flux_config_jsons(model) -> dict:
    """Each component's config.json (diffusers' and transformers' keys) for
    a diffusers FLUX directory of the port's `model`."""
    t, v, c, t5 = model.transformer_config, model.vae_config, model.te_config, \
        model.te2_config
    return {
        "transformer": {
            "in_channels": t.in_channels, "out_channels": t.out_channels,
            "num_layers": t.num_layers, "num_single_layers": t.num_single_layers,
            "num_attention_heads": t.num_heads, "attention_head_dim": t.head_dim,
            "joint_attention_dim": t.joint_attention_dim,
            "pooled_projection_dim": t.pooled_projection_dim,
            "guidance_embeds": t.guidance_embeds, "axes_dims_rope": list(t.axes_dims_rope)},
        "vae": {"in_channels": v.in_channels, "out_channels": v.out_channels,
                "latent_channels": v.latent_channels,
                "block_out_channels": list(v.block_out_channels),
                "layers_per_block": v.layers_per_block, "scaling_factor": v.scaling_factor,
                "shift_factor": v.shift_factor},
        "text_encoder": {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                         "intermediate_size": c.intermediate_size,
                         "num_hidden_layers": c.num_layers,
                         "num_attention_heads": c.num_heads,
                         "max_position_embeddings": c.max_position_embeddings,
                         "hidden_act": c.hidden_act, "eos_token_id": c.eos_token_id,
                         "architectures": ["CLIPTextModel"]},
        "text_encoder_2": {"vocab_size": t5.vocab_size, "d_model": t5.d_model,
                           "d_kv": t5.d_kv, "d_ff": t5.d_ff, "num_layers": t5.num_layers,
                           "num_heads": t5.num_heads},
    }


def save_sharded(component_dir: str, stem: str, state_dict: dict, shards: int) -> None:
    """`state_dict` as `shards` safetensors files (host copies of the
    tensors as they are) behind a `<stem>.safetensors.index.json`."""
    from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
    keys = list(state_dict)
    weight_map = {}
    for i in range(shards):
        name = f"{stem}-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = keys[i * len(keys) // shards:(i + 1) * len(keys) // shards]
        save_safetensors(os.path.join(component_dir, name),
                         {k: state_dict[k].detach().cpu() for k in part})
        weight_map.update({k: name for k in part})
    with open(os.path.join(component_dir, f"{stem}.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


def write_flux_dir(ckpt: str, model) -> None:
    """The port's FLUX `model` as a diffusers directory laid out as
    FLUX.1-dev ships it: each component's config.json, the transformer in
    three shards and T5 in two behind their indices, the VAE and CLIP-L one
    file each, every tensor in its own dtype."""
    from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
    from onetrainer_tpu_torch.io.sd_checkpoints import state_dict_of
    m = model.modules()
    for name, config in flux_config_jsons(model).items():
        os.makedirs(os.path.join(ckpt, name))
        with open(os.path.join(ckpt, name, "config.json"), "w") as f:
            json.dump(config, f)
    save_sharded(os.path.join(ckpt, "transformer"), "diffusion_pytorch_model",
                 state_dict_of(m["transformer"]), 3)
    save_sharded(os.path.join(ckpt, "text_encoder_2"), "model",
                 state_dict_of(m["text_encoder_2"]), 2)
    for name, stem in (("vae", "diffusion_pytorch_model"), ("text_encoder", "model")):
        save_safetensors(os.path.join(ckpt, name, f"{stem}.safetensors"),
                         {k: v.cpu() for k, v in state_dict_of(m[name]).items()})


def flux_files(torch, root: str) -> str:
    """A seeded FLUX.1-dev at full width, its transformer cut to
    FLUX_CLI_DOUBLE + FLUX_CLI_SINGLE blocks and T5-XXL to CUT_T5_LAYERS
    layers, written in bf16 as a diffusers directory in `root`
    (`write_flux_dir`) -> its path."""
    from onetrainer_tpu_torch.util.enums import ModelType
    model = build_cut_dit(torch, ModelType.FLUX_DEV_1, (FLUX_CLI_DOUBLE, FLUX_CLI_SINGLE),
                          CUT_T5_LAYERS)
    ckpt = os.path.join(root, "flux-dev")
    t0 = time.perf_counter()
    write_flux_dir(ckpt, model)
    write_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt) for f in fs)
    print(f"[flux_files] wrote {ckpt} ({size / 2 ** 30:.3f} GiB, bf16, diffusers layout, the "
          f"transformer {FLUX_CLI_DOUBLE} + {FLUX_CLI_SINGLE} blocks in 3 shards, T5 "
          f"{CUT_T5_LAYERS} layers in 2) in {write_s:.2f} s")
    return ckpt


def phase_flux_cli(torch, ckpt: str, dataset: str) -> dict:
    """FLUX from `flux_files`' diffusers directory through the train and
    sample commands (`_dit_lora_cli`) at 512x512, the transformer NF4; the
    sample in bf16 at guidance 3.5. Exactly per step K1 twice per block
    ("full" recomputes the blocks) at 77 + 1024 tokens, K2, K3 and the
    pre-pass once, K4 once per NF4 layer and again per layer in the
    blocks."""
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    blocks = FLUX_CLI_DOUBLE + FLUX_CLI_SINGLE
    n_quant, n_in_blocks = flux_nf4_layers(FLUX_CLI_DOUBLE, FLUX_CLI_SINGLE)
    per_step = {"K1": 2 * blocks, "K2": blocks, "K3": blocks, "K3pre": blocks,
                "K4": n_quant + n_in_blocks, "K5": 0}
    latent = FLUX_CLI_SIZE // 8
    result = _dit_lora_cli(
        torch, "flux_cli", ckpt, dataset, ModelType.FLUX_DEV_1, FLUX_CLI_SIZE, per_step,
        n_quant, {"latent_image": (latent, latent, 16), "t5_hidden_state": (77, 4096),
                  "clip_pooled_state": (768,)}, ["--cfg", str(FLUX_GUIDANCE)],
        4 * blocks, "full", "bf16 diffusers directory to the card, the transformer "
        "quantized to NF4", prior_dtype=DataType.NFLOAT_4)
    gc.collect()
    torch.cuda.empty_cache()
    result["embedding_launches"] = _embedding_cli(
        torch, "flux_cli", ckpt, dataset, ModelType.FLUX_DEV_1, FLUX_CLI_SIZE, per_step,
        {"clip_l", "t5", "t5_out"}, configure=_cli_weights(DataType.NFLOAT_4))
    return result


# HunyuanVideo: 20 double-stream and 40 single-stream blocks, one joint
# attention each (K1 per block, twice per step under "full"), at 9 latent
# frames of 64x64 (33 video frames at 512x512): 9216 + 77 = 9293 tokens
HV_DOUBLE, HV_SINGLE = 20, 40
HV_BLOCKS = HV_DOUBLE + HV_SINGLE
HV_TOKENS = HV_IMAGE_TOKENS + HV_TEXT_TOKENS
HV_FRAMES, HV_LATENT_FRAMES, HV_SIZE = 33, 9, 512
HV_GUIDANCE = 6.0           # the sampling guidance HunyuanVideo's pipeline defaults to
HV_TEXT_DIM, HV_POOLED_DIM = 4096, 768     # Llama's width, CLIP-L's projection
# the hunyuan_cli phase's diffusers directory: HunyuanVideo's widths, the
# transformer cut to 2 double and 4 single blocks and Llama to 4 layers
# (layer -3 must exist), as FLUX's CLI cut
HV_CLI_DOUBLE, HV_CLI_SINGLE, HV_CLI_LLAMA_LAYERS = 2, 4, 4
HV_CLI_SIZE = 512


def hunyuan_nf4_layers(double: int, single: int) -> tuple[int, int]:
    """(NF4 layers of a HunyuanVideo transformer, those inside its blocks):
    every dense layer is quantized (the smallest, x_embedder and proj_out,
    have 64 x 3072 = 196,608 >= 4096 elements): 14 per double block, 6 per
    single block, and 28 outside them (x_embedder; the token refiner's 19:
    its time and text embedders' four, proj_in and seven per refiner block;
    the time, guidance and text embedders' six; norm_out, proj_out). Under
    "full" checkpointing a step dequantizes the ones in the blocks twice."""
    in_blocks = 14 * double + 6 * single
    return in_blocks + 28, in_blocks


def build_hunyuan_model(torch, double: int = HV_DOUBLE, single: int = HV_SINGLE,
                        llama_layers: int | None = None, quantize: bool = True):
    """HunyuanVideo at its published widths with seeded weights on the card
    (`double` + `single` blocks of 24 d=128 heads, hidden 3072, two refiner
    layers, RoPE axes (16, 56, 56) theta 256, the guidance embedding;
    Llama-3-8B (`llama_layers` of its 32 when given); CLIP-L with its 768
    projection; the causal VAE, channels (128, 256, 512, 512)), bf16
    compute, the reference's checkpoint policy ("full"). The transformer is
    built in bf16 (fp32 would be 51 GB) and, with `quantize`, quantized to
    NF4 through the setup's policy (the prior's weight dtype NFLOAT_4) layer
    by layer; the other parts are fp32 (bf16 without `quantize`: the CLI
    phase's files)."""
    from dataclasses import replace

    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.io.weights import init_hunyuan_weights
    from onetrainer_tpu_torch.models.hunyuan_video import HunyuanVideoTransformer3D
    from onetrainer_tpu_torch.models.hunyuan_video_model import create_hunyuan_video_model
    from onetrainer_tpu_torch.models.llama import LlamaEncoder
    from onetrainer_tpu_torch.ops.quant import is_quantized
    from onetrainer_tpu_torch.setup.quantize import quantize_frozen_parts
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    t0 = time.perf_counter()
    model = create_hunyuan_video_model(ModelType.HUNYUAN_VIDEO, dtype=torch.bfloat16,
                                       gradient_checkpointing=True, device="meta")
    if (double, single) != (HV_DOUBLE, HV_SINGLE):
        model.transformer_config = replace(model.transformer_config, num_layers=double,
                                           num_single_layers=single)
        with torch.device("meta"):
            model.transformer = HunyuanVideoTransformer3D(model.transformer_config)
    if llama_layers is not None:
        model.te_config = replace(model.te_config, num_layers=llama_layers)
        with torch.device("meta"):
            model.text_encoder = LlamaEncoder(model.te_config)
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in model.modules().items()}
    for name, module in model.modules().items():
        if name == "transformer" or not quantize:
            module.to(torch.bfloat16)    # on "meta": no memory yet
    torch.cuda.reset_peak_memory_stats()
    init_hunyuan_weights(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    built_gib = torch.cuda.memory_allocated() / 2 ** 30
    line = (f"[hunyuan_model] HunyuanVideo ({double} double, {single} single blocks, "
            f"Llama {model.te_config.num_layers} layers), parameters {counts} (total "
            f"{sum(counts.values())}), seeded on the card in {init_s:.2f} s, "
            f"{built_gib:.2f} GiB allocated")
    if not quantize:
        print(line + " (all bf16)")
        return model
    t0 = time.perf_counter()
    config = TrainConfig.default_values()
    config.prior.weight_dtype = DataType.NFLOAT_4
    quantize_frozen_parts({"transformer": model.transformer}, config.weight_dtypes(),
                          {"transformer": "prior"})
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    layers = [m for m in model.transformer.modules() if is_quantized(getattr(m, "weight", None))]
    nf4_gib = sum(m.weight.q.numel() + 4 * m.weight.scales.numel() for m in layers) / 2 ** 30
    expected = hunyuan_nf4_layers(double, single)[0]
    after_gib = torch.cuda.memory_allocated() / 2 ** 30
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{line} (transformer bf16, the rest fp32); transformer quantized to NF4 in "
          f"{quant_s:.2f} s: {len(layers)} NF4 layers (expected {expected}), "
          f"{nf4_gib:.3f} GiB of codes and scales; after it {after_gib:.2f} GiB allocated, "
          f"peak of the phase {peak_gib:.2f} GiB")
    if len(layers) != expected:
        raise AssertionError(f"{len(layers)} NF4 layers, expected {expected}")
    return model


def _hunyuan_inputs(torch, model, batch: int = 1):
    """Seeded transformer inputs at 512x512 with 9 latent frames: latents
    [B, 9, 64, 64, 16], Llama states [B, 77, 4096] with the keep mask of
    HV_REAL_TEXT real rows, CLIP pooled [B, 768], timesteps and guidance."""
    cfg = model.transformer_config
    gen = torch.Generator(device="cuda").manual_seed(23)
    latent = HV_SIZE // 8
    return dict(
        latents=torch.randn((batch, HV_LATENT_FRAMES, latent, latent, 16), generator=gen,
                            device="cuda"),
        timestep=torch.tensor([250.0, 750.0][:batch], device="cuda"),
        text_states=torch.randn((batch, HV_TEXT_TOKENS, cfg.text_embed_dim), generator=gen,
                                device="cuda"),
        text_mask=hunyuan_keep(torch, batch, 0).int(),
        pooled=torch.randn((batch, cfg.pooled_projection_dim), generator=gen, device="cuda"),
        guidance=torch.full((batch,), HV_GUIDANCE * 1000.0, device="cuda"))


def phase_hunyuan_transformer(torch, model):
    """One forward of the NF4 transformer at full width (batch 1, 9 latent
    frames of 64x64: 9216 image and 77 text rows, 29 kept) with K1 and with
    plain attention (on chunks of heads): K1 once per block with the keep
    mask, K4 once per NF4 layer, relative L2 of the output."""
    inputs = _hunyuan_inputs(torch, model)

    def forward():
        with torch.inference_mode():
            out = model.transformer(**inputs)
        torch.cuda.synchronize()
        return out

    run = _k1_and_plain(torch, forward)
    n_quant, _ = hunyuan_nf4_layers(HV_DOUBLE, HV_SINGLE)
    expected = {"K1": HV_BLOCKS, "K2": 0, "K3": 0, "K3pre": 0, "K4": n_quant, "K5": 0}
    ok = (run["finite"] and run["rel"] <= SD3_REL_L2_BOUND and run["launches"] == expected
          and tuple(run["out"].shape) == (1, HV_LATENT_FRAMES, HV_SIZE // 8, HV_SIZE // 8, 16))
    print(f"[hunyuan_transformer] HunyuanVideo transformer ({HV_DOUBLE} double, {HV_SINGLE} "
          f"single blocks), NF4, batch 1 over {HV_TOKENS} joint tokens (24 heads of d=128, "
          f"{HV_REAL_TEXT} of 77 text rows kept): K1 {run['k1_s'] * 1e3:.2f} ms (launches "
          f"{run['launches']}, expected {expected}), plain attention "
          f"{run['plain_s'] * 1e3:.2f} ms, rel L2 {run['rel']:.3e} (bound "
          f"{SD3_REL_L2_BOUND:g}), peak max_memory_allocated {run['peak_gib']:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the HunyuanVideo transformer with K1 disagrees with plain "
                             "attention")


def phase_hunyuan_train(torch, model) -> dict:
    """LoRA r16 a16 on all 548 dense layers of the NF4 transformer, fp32
    adapters, AdamW 1e-4, clip 1.0, batch 1 at 512x512 with 9 latent frames
    through the cache's rows (seeded latents [1, 9, 64, 64, 16] and their
    logvar, Llama states [1, 77, 4096] with HV_REAL_TEXT rows kept, CLIP
    pooled [1, 768]; the text encoders and the VAE freed), "full"
    checkpointing, the config's guidance 1: one warm-up and two timed
    steps with exact launches per step (K1 twice per block, K2, K3 and the
    pre-pass once, K4 once per NF4 layer and again per layer inside the
    recomputed blocks), the LoRA gradients against plain attention and the
    plain dequant, a profiler split."""
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    config = _lora_config(1, ModelType.HUNYUAN_VIDEO)
    config.prior.weight_dtype = DataType.NFLOAT_4

    def cached_rows(setup):
        x = _hunyuan_inputs(torch, model)
        gen = torch.Generator(device="cuda").manual_seed(29)
        return {"latent_image": x["latents"],
                "latent_logvar": torch.full_like(x["latents"], -4.0)
                + 0.1 * torch.randn(x["latents"].shape, generator=gen, device="cuda"),
                "text_encoder_1_hidden_state": x["text_states"],
                "tokens_mask_1": x["text_mask"],
                "text_encoder_2_pooled_state": x["pooled"],
                "loss_weight": torch.ones((1,), device="cuda")}

    def free_encoders(setup):
        model.text_encoder = model.text_encoder_2 = model.vae = None
        gc.collect()
        torch.cuda.empty_cache()

    run = _setup_and_steps(torch, model, config, "hunyuan_train", HV_SIZE,
                           after_batch=free_encoders, make_batch=cached_rows)
    setup, batch = run["setup"], run["batch"]
    n_quant, n_in_blocks = hunyuan_nf4_layers(HV_DOUBLE, HV_SINGLE)
    n = TRAIN_STEPS * HV_BLOCKS
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n,
                "K4": TRAIN_STEPS * (n_quant + n_in_blocks), "K5": 0}
    grads = _grads_against_plain(torch, setup, batch, "hunyuan_train", plain_dequant=True)
    ok = (run["finite"] and grads["finite"] and run["up_max"] > 0
          and run["launches"] == expected and grads["by_seq"] == {HV_TOKENS: 2 * HV_BLOCKS}
          and grads["rel"] <= GRAD_REL_L2_BOUND
          and len(setup.state.params["transformer_lora"]) == n_quant
          and model.transformer_config.remat_policy == "full"
          and setup.model.prediction_type == "flow")
    print(f"[hunyuan_train] {n_quant} NF4 layers ({n_in_blocks} in the blocks), all adapted; "
          f"checkpoint policy {model.transformer_config.remat_policy} (the blocks recompute: "
          f"K1 twice per block and step, K4 {n_quant + n_in_blocks} per step); launches "
          f"{run['launches']} (expected {expected}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("hunyuan_train failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], "hunyuan_train")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"]}


def hunyuan_ft_reckoning(torch, model) -> str:
    """hunyuan_ft's memory reckoning from the shapes, before its first step:
    bf16 weights and gradients, one chunk of updates, Adafactor's state
    (factored for the 2-D weights: a row and a column vector; full for the
    others), the activations "full" checkpointing keeps (each block's
    input, [1, 9293, 3072] bf16) and one block's recompute, Llama, CLIP-L
    and the VAE freed after the batch is cached."""
    from onetrainer_tpu_torch.train.sd_train_step import UPDATE_CHUNK_ELEMENTS
    params = list(model.transformer.parameters())
    n = sum(p.numel() for p in params)
    state = sum(4 * (sum(p.shape) if p.dim() == 2 else p.numel()) for p in params)
    chunk = min(n, UPDATE_CHUNK_ELEMENTS)
    saved = HV_BLOCKS * HV_TOKENS * 3072 * 2
    # one single block's recompute and backward: its fused [9293, 21504]
    # projection in bf16 and fp32 grads of it, a few times over
    block = 6 * HV_TOKENS * 21504 * 2
    encoders = {name: sum(p.numel() for p in getattr(model, name).parameters())
                for name in ("text_encoder", "text_encoder_2", "vae")}
    total = 2 * _gib(n) + _gib(chunk) + state / 2 ** 30 + (saved + block) / 2 ** 30
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    return (f"the reckoning: weights {_gib(n):.2f} + gradients {_gib(n):.2f} + one chunk of "
            f"updates {_gib(chunk):.2f} + Adafactor's state {state / 2 ** 30:.2f} + "
            f"activations {saved / 2 ** 30:.2f} (each block's input) + one block's "
            f"recompute about {block / 2 ** 30:.2f} = {total:.2f} GiB of {card:.2f} GiB "
            f"({card - total:.2f} left); Llama, CLIP-L and the VAE "
            f"{ {k: round(_gib(v), 2) for k, v in encoders.items()} } GiB freed after caching; ")


def phase_hunyuan_ft(torch, model) -> dict:
    """hunyuan_ft: HunyuanVideo's FINE_TUNE at full width and depth in bf16
    on the seeded transformer built after the NF4 model is freed: the
    transformer trained (12.8e9 elements, the update in chunks of at most
    UPDATE_CHUNK_ELEMENTS, K5 once per chunk), Adafactor with stochastic
    rounding, lr 1e-5, clip 1.0, batch 1 at 512x512 with 9 latent frames
    (9293 tokens) through the cache's rows (hunyuan_train's), "full"
    checkpointing; Llama, CLIP-L and the VAE freed once the batch is
    cached; the memory reckoning printed before the steps, the peak after
    them. Its gradients are not taken again against plain attention:
    hunyuan_train holds K1-K3 against it at this shape and keep mask."""
    from onetrainer_tpu_torch.util.enums import ModelType
    config = _dit_ft_config(ModelType.HUNYUAN_VIDEO, 1, train_te=False)
    reckoning = hunyuan_ft_reckoning(torch, model)
    print(f"[hunyuan_ft] {reckoning}")

    def cached_rows(setup):
        x = _hunyuan_inputs(torch, model)
        gen = torch.Generator(device="cuda").manual_seed(29)
        return {"latent_image": x["latents"],
                "latent_logvar": torch.full_like(x["latents"], -4.0)
                + 0.1 * torch.randn(x["latents"].shape, generator=gen, device="cuda"),
                "text_encoder_1_hidden_state": x["text_states"],
                "tokens_mask_1": x["text_mask"],
                "text_encoder_2_pooled_state": x["pooled"],
                "loss_weight": torch.ones((1,), device="cuda")}

    def free_encoders(setup):
        model.text_encoder = model.text_encoder_2 = model.vae = None

    per_step = {"K1": 2 * HV_BLOCKS, "K2": HV_BLOCKS, "K3": HV_BLOCKS, "K3pre": HV_BLOCKS}
    out = _dit_fine_tune(torch, model, config, "hunyuan_ft", HV_SIZE, per_step,
                         {HV_TOKENS: 2 * HV_BLOCKS}, None, make_batch=cached_rows,
                         after_batch=free_encoders, reckoning=reckoning)
    print(f"[hunyuan_ft] peak max_memory_allocated over the timed steps "
          f"{out['peak_gib']:.2f} GiB on {gpu_line()}")
    return out


def hunyuan_config_jsons(model) -> dict:
    """Each component's config.json (diffusers' and transformers' keys) for
    a diffusers HunyuanVideo directory of the port's `model`."""
    t, v, ll, c = model.transformer_config, model.vae_config, model.te_config, \
        model.te2_config
    return {
        "transformer": {
            "in_channels": t.in_channels, "out_channels": t.out_channels,
            "num_layers": t.num_layers, "num_single_layers": t.num_single_layers,
            "num_refiner_layers": t.num_refiner_layers,
            "num_attention_heads": t.num_heads, "attention_head_dim": t.head_dim,
            "text_embed_dim": t.text_embed_dim,
            "pooled_projection_dim": t.pooled_projection_dim,
            "guidance_embeds": t.guidance_embeds, "rope_axes_dim": list(t.axes_dims_rope)},
        "vae": {"in_channels": v.in_channels, "latent_channels": v.latent_channels,
                "block_out_channels": list(v.block_out_channels),
                "layers_per_block": v.layers_per_block,
                "temporal_compression_ratio": v.temporal_compression,
                "spatial_compression_ratio": v.spatial_compression,
                "scaling_factor": v.scaling_factor},
        "text_encoder": {"vocab_size": ll.vocab_size, "hidden_size": ll.hidden_size,
                         "intermediate_size": ll.intermediate_size,
                         "num_hidden_layers": ll.num_layers,
                         "num_attention_heads": ll.num_heads,
                         "num_key_value_heads": ll.num_kv_heads, "head_dim": ll.head_dim,
                         "rope_theta": ll.rope_theta, "rms_norm_eps": ll.rms_norm_eps},
        "text_encoder_2": {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                           "intermediate_size": c.intermediate_size,
                           "num_hidden_layers": c.num_layers,
                           "num_attention_heads": c.num_heads,
                           "max_position_embeddings": c.max_position_embeddings,
                           "hidden_act": c.hidden_act, "eos_token_id": c.eos_token_id,
                           "projection_dim": c.projection_dim,
                           "architectures": ["CLIPTextModelWithProjection"]},
    }


def hunyuan_files(torch, root: str) -> str:
    """A seeded HunyuanVideo at full width, its transformer cut to
    HV_CLI_DOUBLE + HV_CLI_SINGLE blocks and Llama to HV_CLI_LLAMA_LAYERS,
    written in bf16 by the port's own saver as a diffusers directory in
    `root` (Llama in two shards behind an index) -> its path."""
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import save_hunyuan_diffusers
    from onetrainer_tpu_torch.io.sd_checkpoints import state_dict_of
    model = build_hunyuan_model(torch, HV_CLI_DOUBLE, HV_CLI_SINGLE, HV_CLI_LLAMA_LAYERS,
                                quantize=False)
    ckpt = os.path.join(root, "hunyuan-video")
    t0 = time.perf_counter()
    sd = {name: state_dict_of(m) for name, m in model.modules().items()}
    save_hunyuan_diffusers(ckpt, model, sd["transformer"], sd["vae"], sd["text_encoder"],
                           sd["text_encoder_2"], save_dtype=None)
    llama = os.path.join(ckpt, "text_encoder", "model.safetensors")
    os.remove(llama)
    save_sharded(os.path.dirname(llama), "model", sd["text_encoder"], 2)
    for name, config in hunyuan_config_jsons(model).items():
        with open(os.path.join(ckpt, name, "config.json"), "w") as f:
            json.dump(config, f)
    write_s = time.perf_counter() - t0
    del model, sd
    gc.collect()
    torch.cuda.empty_cache()
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt) for f in fs)
    print(f"[hunyuan_files] wrote {ckpt} ({size / 2 ** 30:.3f} GiB, bf16, diffusers layout, "
          f"the transformer {HV_CLI_DOUBLE} + {HV_CLI_SINGLE} blocks, Llama "
          f"{HV_CLI_LLAMA_LAYERS} layers in 2 shards) in {write_s:.2f} s")
    return ckpt


def phase_hunyuan_cli(torch, ckpt: str, dataset: str) -> dict:
    """HunyuanVideo from `hunyuan_files`' diffusers directory through the
    train and sample commands (`_dit_lora_cli`) at 512x512, sd15_files' PNGs
    as 1-frame clips (the card has no OpenCV: no video files), the
    transformer NF4; the sample (one frame, the sample config's default) in
    bf16 at guidance 6. Exactly per step K1 twice per block ("full"
    recomputes the blocks) at 1024 + 77 tokens, K2, K3 and the pre-pass
    once, K4 once per NF4 layer and again per layer in the blocks."""
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    blocks = HV_CLI_DOUBLE + HV_CLI_SINGLE
    n_quant, n_in_blocks = hunyuan_nf4_layers(HV_CLI_DOUBLE, HV_CLI_SINGLE)
    per_step = {"K1": 2 * blocks, "K2": blocks, "K3": blocks, "K3pre": blocks,
                "K4": n_quant + n_in_blocks, "K5": 0}
    latent = HV_CLI_SIZE // 8
    result = _dit_lora_cli(
        torch, "hunyuan_cli", ckpt, dataset, ModelType.HUNYUAN_VIDEO, HV_CLI_SIZE, per_step,
        n_quant, {"latent_image": (1, latent, latent, 16),
                  "text_encoder_1_hidden_state": (HV_TEXT_TOKENS, HV_TEXT_DIM),
                  "tokens_mask_1": (HV_TEXT_TOKENS,),
                  "text_encoder_2_pooled_state": (HV_POOLED_DIM,)},
        ["--cfg", str(HV_GUIDANCE)], 4 * blocks, "full",
        "bf16 diffusers directory to the card, the transformer quantized to NF4",
        prior_dtype=DataType.NFLOAT_4)
    gc.collect()
    torch.cuda.empty_cache()
    result["embedding_launches"] = _embedding_cli(
        torch, "hunyuan_cli", ckpt, dataset, ModelType.HUNYUAN_VIDEO, HV_CLI_SIZE, per_step,
        {"llama", "clip_l", "llama_out"}, configure=_cli_weights(DataType.NFLOAT_4))
    return result


# the files the CLI phases write hold T5-XXL cut to CUT_T5_LAYERS of its 24
# layers (all of it is 9.5 GB in 16 bits, and a machine's disk takes about
# 45 GiB of writes over the whole script); dit_single_file's models are cut
# further: SD3-medium to SF_SD3_BLOCKS joint blocks and CLIP-G to
# SF_CLIP_G_LAYERS layers, FLUX.1-dev to SF_FLUX_BLOCKS (double, single) (a
# FINE_TUNE backup holds the model in fp32)
CUT_T5_LAYERS = 2
SF_SD3_BLOCKS = 2
SF_CLIP_G_LAYERS = 4
SF_FLUX_BLOCKS = (1, 1)
SF_SIZE = 512


def build_cut_dit(torch, model_type, blocks: tuple, t5_layers: int,
                  clip_g_layers: int | None = None):
    """SD3-medium or FLUX.1-dev at full width with seeded bf16 weights on
    the card, the transformer cut to `blocks` (SD3: (joint blocks,); FLUX:
    (double, single)), T5-XXL to `t5_layers` and SD3's CLIP-G to
    `clip_g_layers` when given."""
    from dataclasses import replace

    from onetrainer_tpu_torch.io.weights import init_sd3_weights
    from onetrainer_tpu_torch.models.clip import CLIPTextModel
    from onetrainer_tpu_torch.models.flux import FluxTransformer2D
    from onetrainer_tpu_torch.models.flux_model import create_flux_model
    from onetrainer_tpu_torch.models.sd3 import SD3Transformer2D
    from onetrainer_tpu_torch.models.sd3_model import create_sd3_model
    from onetrainer_tpu_torch.models.t5 import T5Encoder
    sd3 = model_type.is_stable_diffusion_3()
    create = create_sd3_model if sd3 else create_flux_model
    model = create(model_type, dtype=torch.bfloat16, gradient_checkpointing=True,
                   device="meta")
    layers = dict(num_layers=blocks[0]) if sd3 else dict(num_layers=blocks[0],
                                                         num_single_layers=blocks[1])
    model.transformer_config = replace(model.transformer_config, **layers)
    t5 = "text_encoder_3" if sd3 else "text_encoder_2"
    t5_config = "te3_config" if sd3 else "te2_config"
    setattr(model, t5_config, replace(getattr(model, t5_config), num_layers=t5_layers))
    if clip_g_layers is not None:
        model.te2_config = replace(model.te2_config, num_layers=clip_g_layers)
    with torch.device("meta"):
        model.transformer = (SD3Transformer2D if sd3 else FluxTransformer2D)(
            model.transformer_config)
        setattr(model, t5, T5Encoder(getattr(model, t5_config)))
        if clip_g_layers is not None:
            model.text_encoder_2 = CLIPTextModel(model.te2_config)
    for module in model.modules().values():
        module.to(torch.bfloat16)
    init_sd3_weights(model, seed=0, device="cuda")
    return model


def _frozen_config(model_type):
    """A FINE_TUNE config that trains no part (its setup serves sampling and
    saving), every part loaded in bf16."""
    from onetrainer_tpu_torch.util.enums import DataType
    config = _fine_tune_config(model_type, 1)
    config.unet.train = config.prior.train = False
    config.weight_dtype = config.prior.weight_dtype = DataType.BFLOAT_16
    return config


def _sf_config(root: str, ckpt: str, dataset: str, model_type):
    """FINE_TUNE of the transformer from a single file through the train
    command: bf16 weights, text cached, Adafactor with stochastic rounding,
    lr 1e-5, clip 1.0, batch 4 at 512x512 over sd15_files' PNGs, gradient
    checkpointing on, epoch 1 with a backup, a single-file bf16 output."""
    from onetrainer_tpu_torch.util.enums import (
        DataType, GradientCheckpointingMethod, ModelFormat, Optimizer, TrainingMethod,
    )
    config = _cli_config(root, ckpt, dataset)
    config.model_type = model_type
    config.training_method = TrainingMethod.FINE_TUNE
    config.resolution = str(SF_SIZE)
    config.learning_rate = 1e-5
    config.weight_dtype = DataType.BFLOAT_16
    config.prior.weight_dtype = DataType.BFLOAT_16
    config.prior.train = True
    config.text_encoder.train = config.text_encoder_2.train = False
    config.gradient_checkpointing = GradientCheckpointingMethod.ON
    config.optimizer.optimizer = Optimizer.ADAFACTOR
    config.optimizer.stochastic_rounding = True
    config.output_dtype = DataType.BFLOAT_16
    config.output_model_format = ModelFormat.SAFETENSORS
    config.output_model_destination = os.path.join(root, "fine_tuned.safetensors")
    return config


def _sf_fine_tune_cli(torch, tag: str, ckpt: str, dataset: str, model_type, per_step: dict,
                      sample_argv: list, sample_k1: int) -> dict:
    """The train command's FINE_TUNE from `ckpt` (a single file, or a
    diffusers directory): epoch 1 with a backup (the model in the base's
    layout, in the trained dtype), the resume from it for epoch 2 and the
    bf16 single-file output, read back bit for bit as the trained
    transformer; exactly `per_step` launches per step and none while
    caching; then the sample command on the output (`sample_k1` K1), a
    non-constant uint8 image."""
    from onetrainer_tpu_torch.io.png import read_png
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    from onetrainer_tpu_torch.scripts import sample
    from onetrainer_tpu_torch.setup.families import get_family
    root = os.path.join(os.path.dirname(ckpt), tag)
    os.makedirs(root)
    config = _sf_config(root, ckpt, dataset, model_type)
    paths = []
    for epochs in (1, 2):
        config.epochs, config.continue_last_backup = epochs, epochs == 2
        config.backup_before_save = epochs == 1
        paths.append(os.path.join(root, f"epoch{epochs}.json"))
        with open(paths[-1], "w") as f:
            json.dump(config.to_dict(), f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    events1, events2 = [], []
    t0 = time.perf_counter()
    first, _ = _cli_run(torch, paths[0], events1)
    first_s = time.perf_counter() - t0
    step_after_first = first.train_progress.global_step
    backup = first.config.get_last_backup_path()
    # the backup's model in the base's layout: a single file, or a
    # diffusers directory from a diffusers base
    backup_model = os.path.join(backup, "model.safetensors" if os.path.isfile(ckpt)
                                else "model")
    backup_gib = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(backup_model)
                     for f in fs) / 2 ** 30 if os.path.isdir(backup_model) else \
        os.path.getsize(backup_model) / 2 ** 30 if os.path.isfile(backup_model) else 0
    del first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed, _ = _cli_run(torch, paths[1], events2)
    resume_s = time.perf_counter() - t0
    train_launches = _launch_counts()
    source = resumed._source_dir
    trained = {k: t.detach() for k, t in resumed.model.transformer.state_dict().items()}
    step_after_resume = resumed.train_progress.global_step
    loss = resumed._loss_ema
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    family = get_family(model_type)
    read = family.load(config.output_model_destination, _frozen_config(model_type),
                       device="cuda")
    written = read.transformer.state_dict()
    output_bitwise = set(written) == set(trained) and all(
        torch.equal(written[k].to(torch.bfloat16), t) for k, t in trained.items())
    del read, written, trained
    gc.collect()
    torch.cuda.empty_cache()
    before_sample = _launch_counts()
    image_path = os.path.join(root, "sample.png")
    t0 = time.perf_counter()
    out = sample.main(["--model-type", model_type.value, "--base-model-name",
                       config.output_model_destination,
                       "--prompt", "a photograph of an astronaut riding a horse",
                       "--destination", image_path, "--steps", "4",
                       "--width", str(SF_SIZE), "--height", str(SF_SIZE),
                       "--weight-dtype", "BFLOAT_16"] + sample_argv)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    sample_launches = _delta(_launch_counts(), before_sample)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    none = {k: 0 for k in per_step}
    steps, cache_launches, times = _cli_timeline(events1, events2)
    image = read_png(image_path)
    checks = {
        "launches per step": all(d == per_step for _, d, _ in steps) and len(steps) == 4,
        "none while caching": all(c == none for c in cache_launches)
        and len(cache_launches) == 2,
        "main-path launches": train_launches == {k: 4 * v for k, v in per_step.items()},
        "K1 over the sample": sample_launches == {**none, "K1": sample_k1},
        "global steps": (step_after_first, step_after_resume) == (2, 4),
        "resumed from the backup's single file": source == backup_model,
        "output read back bitwise": output_bitwise,
        "finite loss": _finite([loss]),
        "image": image.dtype.name == "uint8" and image.shape == (SF_SIZE, SF_SIZE, 3)
        and image.std() > 0 and bool((image == out.image).all()),
    }
    card = gpu_line()
    print(f"[{tag}] on {card}: epoch 1 with its backup {first_s:.2f} s (backup model "
          f"{backup_gib:.3f} GiB), the resume with the output {resume_s:.2f} s; load "
          f"{', '.join(f'{x:.2f}' for x in times['load_s'])} s, caching "
          f"{times['cache_s'][0]:.3f} s; steps (global step, s): "
          f"{', '.join(f'{g}: {x:.4f}' for g, _, x in steps)}; sample {sample_s:.2f} s; "
          f"peak max_memory_allocated {peak_gib:.2f} GiB; launches {train_launches} "
          f"(sample {sample_launches}); checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} failed: {[k for k, ok in checks.items() if not ok]}")
    return {"launches": {k: train_launches[k] + sample_launches[k] for k in train_launches},
            "step_s": statistics.median(x for g, _, x in steps if g != 1)}


def _write_and_read_back(torch, tag: str, model, family, path: str, config,
                         transformer_only: bool = False) -> dict:
    """`model` through its family's single-file saver (bf16, a setup that
    trains nothing; with `transformer_only`, the transformer alone, the
    reference's HunyuanVideo layout) and loader on the card: every tensor
    of every part written back bit for bit. -> {"write_s", "read_s",
    "gib"}."""
    from onetrainer_tpu_torch.io.single_file import save_hunyuan_single_file
    t0 = time.perf_counter()
    if transformer_only:
        save_hunyuan_single_file(path, model.transformer.state_dict(), None, None, None,
                                 save_dtype=torch.bfloat16)
    else:
        family.save_single_file(family.create_setup(model, config, 1), path,
                                save_dtype=torch.bfloat16)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read = family.load(path, config, device="cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    parts = {"transformer": model.transformer} if transformer_only else model.modules()
    mismatched = [f"{name}.{key}" for name, module in parts.items()
                  for key, value in module.state_dict().items()
                  if not torch.equal(read.modules()[name].state_dict()[key],
                                     value.to(torch.bfloat16))]
    gib = os.path.getsize(path) / 2 ** 30
    print(f"[dit_single_file] {tag}: wrote {path} ({gib:.3f} GiB, bf16) in {write_s:.2f} s, "
          f"read it to the card in {read_s:.2f} s; parts "
          f"{ {n: sum(p.numel() for p in m.parameters()) for n, m in parts.items()} }"
          f"; tensors that differ from those written: {mismatched[:5]} ({len(mismatched)})")
    del read
    gc.collect()
    torch.cuda.empty_cache()
    if mismatched:
        raise AssertionError(f"{tag}: {len(mismatched)} tensors read back differ")
    return dict(write_s=write_s, read_s=read_s, gib=gib)


def phase_dit_single_file(torch, hunyuan_ckpt: str, dataset: str) -> dict:
    """dit_single_file (see the module docstring): the SAI, BFL and
    HunyuanVideo single files written and read back bitwise on the card,
    then the train command's FINE_TUNE from the SD3 and FLUX files, and
    from hunyuan_cli's diffusers directory (its transformer cut to
    HV_CLI_DOUBLE + HV_CLI_SINGLE blocks), each with a backup, a resume and
    a single-file output (HunyuanVideo's own), and the sample command on
    each output. Each file is deleted once its checks ran (the disk)."""
    import shutil

    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import ModelType
    root = os.path.dirname(hunyuan_ckpt)
    family = get_family(ModelType.HUNYUAN_VIDEO)
    config = _frozen_config(ModelType.HUNYUAN_VIDEO)
    model = family.load(hunyuan_ckpt, config, device="cuda")
    path = os.path.join(root, "hunyuan-video.safetensors")
    _write_and_read_back(torch, "HunyuanVideo (hunyuan_cli's model), the transformer", model,
                         family, path, config, transformer_only=True)
    os.remove(path)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    blocks = HV_CLI_DOUBLE + HV_CLI_SINGLE
    tag = "hunyuan_sf_ft_cli"
    run = _sf_fine_tune_cli(torch, tag, hunyuan_ckpt, dataset, ModelType.HUNYUAN_VIDEO,
                            {"K1": 2 * blocks, "K2": blocks, "K3": blocks, "K3pre": blocks,
                             "K4": 0, "K5": 1}, ["--cfg", str(HV_GUIDANCE)], 4 * blocks)
    launches = dict(run["launches"])
    shutil.rmtree(os.path.join(root, tag), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    for model_type, blocks, name, per_step, sample_argv in (
            (ModelType.STABLE_DIFFUSION_3, (SF_SD3_BLOCKS,), "sd3-medium-sai.safetensors",
             {"K1": SF_SD3_BLOCKS, "K2": SF_SD3_BLOCKS, "K3": SF_SD3_BLOCKS,
              "K3pre": SF_SD3_BLOCKS, "K4": 0, "K5": 1}, ["--cfg", "7"]),
            (ModelType.FLUX_DEV_1, SF_FLUX_BLOCKS, "flux1-dev-bfl.safetensors",
             {"K1": 2 * sum(SF_FLUX_BLOCKS), "K2": sum(SF_FLUX_BLOCKS),
              "K3": sum(SF_FLUX_BLOCKS), "K3pre": sum(SF_FLUX_BLOCKS), "K4": 0, "K5": 1},
             ["--cfg", str(FLUX_GUIDANCE)])):
        sd3 = model_type.is_stable_diffusion_3()
        model = build_cut_dit(torch, model_type, blocks, CUT_T5_LAYERS,
                              SF_CLIP_G_LAYERS if sd3 else None)
        path = os.path.join(root, name)
        _write_and_read_back(torch, f"{model_type.value} {blocks} blocks, T5 {CUT_T5_LAYERS} "
                             f"layers{f', CLIP-G {SF_CLIP_G_LAYERS}' if sd3 else ''}, bundled",
                             model, get_family(model_type), path, _frozen_config(model_type))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        tag = "sd3_sf_ft_cli" if sd3 else "flux_sf_ft_cli"
        run = _sf_fine_tune_cli(torch, tag, path, dataset, model_type, per_step, sample_argv,
                                4 * per_step["K2"])
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        os.remove(path)
        shutil.rmtree(os.path.join(root, tag), ignore_errors=True)
    return {"launches": launches}


# -- PixArt-Σ and Sana 1600M ------------------------------------------------------------

# PixArt-Σ at its published widths (PixArt-alpha/PixArt-Sigma-XL-2-1024-MS,
# transformer/config.json: 28 blocks of 16 d=72 heads, caption 4096, 8
# output channels, sample size 128, no micro-conditions), T5-XXL at 300
# tokens, the SDXL-shaped VAE; at 1024x1024 its 128x128 latent is 4096
# tokens of 2x2 patches. Sana 1600M (Efficient-Large-Model/
# Sana_1600M_1024px_diffusers: 20 blocks, 70 linear heads x 32, 20 cross
# heads x 112, caption 2304, mlp ratio 2.5, patch 1), Gemma-2-2B at 300
# tokens, DC-AE f32c32: at 1024x1024 a 32x32 latent of 32 channels, 1024
# tokens. Neither runs K1-K3: PixArt's d=72 and Sana's cross-attention
# d=112 sit off the kernel's slots (SDPA), Sana's self-attention is linear.
PIXART_BLOCKS, SANA_BLOCKS = 28, 20
PIXART_SANA_SIZE = 1024
PIXART_TEXT_TOKENS = SANA_TEXT_TOKENS = 300
PIXART_CFG = SANA_CFG = 4.5
# the CLI phase's diffusers directories: both transformers cut to 2 blocks,
# T5-XXL to CUT_T5_LAYERS layers and Gemma-2-2B to 2; 512x512
CUT_DIT_BLOCKS, CUT_GEMMA_LAYERS = 2, 2
PIXART_SANA_CLI_SIZE = 512


def pixart_nf4_layers(blocks: int) -> tuple[int, int]:
    """(NF4 layers of a PixArt-Σ transformer, those inside its blocks):
    every dense and conv layer (the smallest, the patch projection, has 4 x
    1152 x 2 x 2 = 18,432 >= 4096 elements): 10 per block (attn1's and
    attn2's q, k, v, out and the feed-forward's two), and 7 outside them
    (pos_embed.proj, the timestep embedder's two, adaln_single.linear, the
    caption projection's two, proj_out)."""
    return 10 * blocks + 7, 10 * blocks


def sana_nf4_layers(blocks: int) -> tuple[int, int]:
    """(NF4 layers of a Sana transformer, those inside its blocks): 11 per
    block (attn1's and attn2's q, k, v, out and GLUMBConv's three convs, the
    depthwise 3x3's [11200, 1, 3, 3] = 100,800 elements among them), and 7
    outside them (patch_embed.proj, the timestep embedder's two,
    time_embed.linear, the caption projection's two, proj_out). LoRA adapts
    all but the depthwise convs."""
    return 11 * blocks + 7, 11 * blocks


def _quantize_prior(torch, module, tag: str, expected: int) -> None:
    """The transformer to NF4 through the setup's policy (the prior's
    weight dtype NFLOAT_4), checked against the expected layer count."""
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.ops.quant import is_quantized
    from onetrainer_tpu_torch.setup.quantize import quantize_frozen_parts
    from onetrainer_tpu_torch.util.enums import DataType
    t0 = time.perf_counter()
    config = TrainConfig.default_values()
    config.prior.weight_dtype = DataType.NFLOAT_4
    quantize_frozen_parts({"transformer": module}, config.weight_dtypes(),
                          {"transformer": "prior"})
    torch.cuda.synchronize()
    layers = [m for m in module.modules() if is_quantized(getattr(m, "weight", None))]
    nf4_gib = sum(m.weight.q.numel() + 4 * m.weight.scales.numel() for m in layers) / 2 ** 30
    print(f"[{tag}] transformer quantized to NF4 in {time.perf_counter() - t0:.2f} s: "
          f"{len(layers)} NF4 layers (expected {expected}), {nf4_gib:.3f} GiB of codes and "
          f"scales; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if len(layers) != expected:
        raise AssertionError(f"{len(layers)} NF4 layers, expected {expected}")


def _seeded(torch, model, init, tag: str, quantize: bool) -> None:
    """`init` the model's seeded weights on the card: the transformer in
    bf16 (the rest fp32; everything bf16 without `quantize`, the CLI's
    files), the parameter counts printed."""
    counts = {name: sum(p.numel() for p in m.parameters())
              for name, m in model.modules().items()}
    for name, module in model.modules().items():
        if name == "transformer" or not quantize:
            module.to(torch.bfloat16)    # on "meta": no memory yet
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[{tag}] parameters {counts} (total {sum(counts.values())}), seeded on the card "
          f"in {time.perf_counter() - t0:.2f} s ({'transformer bf16, the rest fp32' if quantize else 'all bf16'}), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")


def build_pixart_model(torch, blocks: int = PIXART_BLOCKS, t5_layers: int | None = None,
                       quantize: bool = True):
    """PixArt-Σ at its published widths with seeded weights on the card
    (`blocks` of its 28 blocks; T5-XXL, `t5_layers` of its 24 when given,
    its tokenizer wrapped at 300 tokens; the SDXL-shaped VAE), bf16
    compute, "full" checkpointing; with `quantize` the transformer NF4."""
    from dataclasses import replace

    from onetrainer_tpu_torch.io.weights import init_pixart_weights
    from onetrainer_tpu_torch.models.pixart import PixArtTransformer2D
    from onetrainer_tpu_torch.models.pixart_model import create_pixart_model
    from onetrainer_tpu_torch.models.t5 import T5Encoder
    from onetrainer_tpu_torch.models.vae import AutoencoderKL, sdxl_vae_config
    from onetrainer_tpu_torch.setup.tokenizer import T5TokenizerWrapper
    from onetrainer_tpu_torch.util.enums import ModelType
    model = create_pixart_model(ModelType.PIXART_SIGMA, dtype=torch.bfloat16,
                                gradient_checkpointing=True, device="meta")
    model.transformer_config = replace(model.transformer_config, sample_size=128,
                                       use_additional_conditions=False, num_layers=blocks)
    model.vae_config = sdxl_vae_config(dtype=torch.bfloat16)
    if t5_layers is not None:
        model.te_config = replace(model.te_config, num_layers=t5_layers)
    with torch.device("meta"):
        model.transformer = PixArtTransformer2D(model.transformer_config)
        model.vae = AutoencoderKL(model.vae_config)
        model.text_encoder = T5Encoder(model.te_config)
    model.tokenizer = T5TokenizerWrapper(None, max_length=PIXART_TEXT_TOKENS,
                                         vocab_size=model.te_config.vocab_size)
    tag = "pixart_model"
    print(f"[{tag}] PixArt-Σ {blocks} blocks of 16 d=72 heads (hidden 1152), T5-XXL "
          f"{model.te_config.num_layers} layers at {PIXART_TEXT_TOKENS} tokens, SDXL VAE "
          f"(scaling {model.vae_config.scaling_factor})")
    _seeded(torch, model, init_pixart_weights, tag, quantize)
    if quantize:
        _quantize_prior(torch, model.transformer, tag, pixart_nf4_layers(blocks)[0])
    return model


def build_sana_model(torch, blocks: int = SANA_BLOCKS, gemma_layers: int | None = None,
                     quantize: bool = True):
    """Sana 1600M at its published widths with seeded weights on the card
    (`blocks` of its 20 blocks; Gemma-2-2B, `gemma_layers` of its 26 when
    given, at 300 tokens; DC-AE f32c32), bf16 compute, "full"
    checkpointing; with `quantize` the transformer NF4."""
    from dataclasses import replace

    from onetrainer_tpu_torch.io.weights import init_sana_weights
    from onetrainer_tpu_torch.models.dcae import AutoencoderDC
    from onetrainer_tpu_torch.models.gemma import Gemma2Encoder
    from onetrainer_tpu_torch.models.sana import SanaTransformer2D
    from onetrainer_tpu_torch.models.sana_model import create_sana_model
    from onetrainer_tpu_torch.util.enums import ModelType
    model = create_sana_model(ModelType.SANA, dtype=torch.bfloat16,
                              gradient_checkpointing=True, device="meta")
    model.transformer_config = replace(model.transformer_config, num_layers=blocks)
    if gemma_layers is not None:
        model.te_config = replace(model.te_config, num_layers=gemma_layers)
    with torch.device("meta"):
        model.transformer = SanaTransformer2D(model.transformer_config)
        model.vae = AutoencoderDC(model.vae_config)
        model.text_encoder = Gemma2Encoder(model.te_config)
    tag = "sana_model"
    print(f"[{tag}] Sana {blocks} blocks (hidden 2240: 70 linear heads x 32, 20 cross heads "
          f"x 112), Gemma-2-2B {model.te_config.num_layers} layers at {SANA_TEXT_TOKENS} "
          f"tokens, DC-AE f32c32")
    _seeded(torch, model, init_sana_weights, tag, quantize)
    if quantize:
        _quantize_prior(torch, model.transformer, tag, sana_nf4_layers(blocks)[0])
    return model


def _sana_batch(torch, setup, batch_size: int, size: int) -> dict:
    """Sana's cache rows at size x size, tiled: the DC-AE latent of a
    seeded image (deterministic: no logvar), the Gemma states of the prompt
    and their keep mask."""
    from onetrainer_tpu_torch.setup.families import get_family
    encode_images, encode_text = get_family(setup.config.model_type).make_encode_fns(setup)
    gen = torch.Generator(device="cuda").manual_seed(11)
    image = torch.rand((1, size, size, 3), generator=gen, device="cuda") * 2 - 1
    text = encode_text("a photograph of an astronaut riding a horse")

    def tile(t):
        return t.expand(batch_size, *t.shape[1:]).contiguous()
    return {"latent_image": tile(encode_images(image)["latent_image"]),
            "text_encoder_hidden_state": tile(text["text_encoder_hidden_state"][None]),
            "tokens_mask": tile(torch.as_tensor(text["tokens_mask"], device="cuda")[None]),
            "loss_weight": torch.ones((batch_size,), device="cuda")}


def _k4_over_the_layers(torch, module, tag: str) -> None:
    """K4 on every NF4 layer's codes of `module` against the plain dequant,
    bit for bit, to bf16 (what the layers compute with) and fp32 (what the
    export decodes); the distinct kernel shapes listed. These launches come
    outside any counted window."""
    from onetrainer_tpu_torch.ops.nf4 import nf4_dequant_flat, nf4_dequant_reference
    from onetrainer_tpu_torch.ops.quant import is_quantized
    shapes, same, n = set(), True, 0
    for layer in module.modules():
        w = getattr(layer, "weight", None)
        if not is_quantized(w):
            continue
        n += 1
        shapes.add(tuple(w.shape))
        for dtype, view in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
            out = nf4_dequant_flat(w.q, w.scales, dtype)
            ref = nf4_dequant_reference(w.q, w.scales, dtype)
            same = same and bool(torch.equal(out.view(view), ref.view(view)))
    torch.cuda.synchronize()
    print(f"[{tag}] K4 on all {n} NF4 layers' codes, to bf16 and fp32: bitwise equal to the "
          f"plain dequant {same}; kernel shapes {sorted(shapes)}")
    if not same:
        raise AssertionError(f"{tag}: K4 differs from the plain dequant")


def _k5_set_plain_ms(torch, setup) -> float:
    """The plain rounding's time over a copy of the step's adapter set (bf16
    p, seeded bf16 u, a seed per leaf), tensor by tensor."""
    from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16
    gen = torch.Generator(device="cuda").manual_seed(57)
    ps = [t.detach().clone() for g in setup.state.params.values() for e in g.values()
          for t in e.values()]
    us = [(torch.randn(p.shape, generator=gen, device="cuda") * 1e-4).to(torch.bfloat16)
          for p in ps]
    seeds = torch.empty(len(ps), dtype=torch.int64, device="cuda")
    seeds.random_(generator=gen)

    def plain():
        for i, (p, u) in enumerate(zip(ps, us)):
            bits = philox_bits(seeds[i:i + 1], p.numel(), p.device).view(p.shape)
            p.copy_(stochastic_round_to_bf16(p.float() + u.float(), bits))
    return _once_ms(torch, plain)


def _dit_qlora_train(torch, model, tag: str, n_layers: tuple, adapted: int,
                     make_batch=None) -> dict:
    """LoRA r16 a16 over the NF4 transformer with bf16 adapters and
    stochastic rounding, AdamW 1e-4, clip 1.0, batch 2 at 1024x1024
    (PIXART_SANA_SIZE) from
    the port's caches (`make_batch(setup)` when given), the text encoder and
    the VAE freed once cached, "full" checkpointing: one warm-up and
    TRAIN_STEPS timed steps with exactly, per step, K4 once per NF4 layer
    and again per layer in the recomputed blocks, K5 once, no K1-K3; K4 on
    every layer's codes bit for bit; one step's gradients with K4 against
    the plain dequant (GRAD_REL_L2_BOUND: K4 is bitwise, but SDPA's flash
    backward, PixArt's attention, sums with atomics in no fixed order, and
    differed by 1.1e-3 between two runs); one step's K5 call bit for bit against the plain
    rounding (`_k5_over_the_adapters`); the plain rounding's time over the
    set; a profiler split."""
    from onetrainer_tpu_torch.util.enums import DataType
    config = _lora_config(2, model.model_type)
    config.prior.weight_dtype = DataType.NFLOAT_4
    config.lora_weight_dtype = DataType.BFLOAT_16
    config.optimizer.stochastic_rounding = True

    def free_encoders(setup):
        model.text_encoder = model.vae = None
        gc.collect()
        torch.cuda.empty_cache()

    run = _setup_and_steps(torch, model, config, tag, PIXART_SANA_SIZE,
                           after_batch=free_encoders, make_batch=make_batch)
    setup, batch = run["setup"], run["batch"]
    n_quant, n_in_blocks = n_layers
    expected = {"K1": 0, "K2": 0, "K3": 0, "K3pre": 0,
                "K4": TRAIN_STEPS * (n_quant + n_in_blocks), "K5": TRAIN_STEPS}
    _k4_over_the_layers(torch, model.transformer, tag)
    grads = _grads_against_plain(torch, setup, batch, tag, plain_dequant=True)
    k5 = _k5_over_the_adapters(torch, setup, batch, run["gen"], tag)
    k5["plain_ms"] = _k5_set_plain_ms(torch, setup)
    adapters = setup.state.params["transformer_lora"]
    ok = (run["finite"] and grads["finite"] and run["up_max"] > 0
          and run["launches"] == expected and grads["by_seq"] == {}
          and grads["rel"] <= GRAD_REL_L2_BOUND and len(adapters) == adapted
          and set(setup.state.params) == {"transformer_lora"})
    print(f"[{tag}] {n_quant} NF4 layers ({n_in_blocks} in the blocks), {len(adapters)} adapted "
          f"(expected {adapted}); K5 over the {k5['leaves']} adapter tensors: "
          f"{k5['ms']:.4f} ms, plain {k5['plain_ms']:.2f} ms, least time {k5['bound_ms']:.4f} ms "
          f"({k5['bound_by']}); launches {run['launches']} (expected {expected}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], tag)
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"], "k5": k5}


def phase_pixart_train(torch, model) -> dict:
    """PixArt-Σ QLoRA (`_dit_qlora_train`) with the VB loss at strength 1:
    epsilon and the learned variance, T5 states cached at 300 tokens."""
    return _dit_qlora_train(torch, model, "pixart_train", pixart_nf4_layers(PIXART_BLOCKS),
                            pixart_nf4_layers(PIXART_BLOCKS)[0])


def phase_sana_train(torch, model) -> dict:
    """Sana 1600M QLoRA (`_dit_qlora_train`), flow matching, Gemma states
    cached at 300 tokens with their keep mask."""
    n_quant, n_in_blocks = sana_nf4_layers(SANA_BLOCKS)
    return _dit_qlora_train(torch, model, "sana_train", (n_quant, n_in_blocks),
                            n_quant - SANA_BLOCKS,
                            make_batch=lambda setup: _sana_batch(torch, setup, 2,
                                                                 PIXART_SANA_SIZE))


def _config_jsons(model) -> dict:
    """Each component's config.json for a diffusers directory of the port's
    PixArt or Sana `model`."""
    t, v, te = model.transformer_config, model.vae_config, model.te_config
    if model.model_type.is_pixart():
        return {
            "transformer": {"sample_size": t.sample_size, "patch_size": t.patch_size,
                            "in_channels": t.in_channels, "out_channels": t.out_channels,
                            "num_layers": t.num_layers, "num_attention_heads": t.num_heads,
                            "attention_head_dim": t.head_dim,
                            "cross_attention_dim": t.cross_attention_dim,
                            "caption_channels": t.caption_channels,
                            "use_additional_conditions": t.use_additional_conditions},
            "vae": {"in_channels": v.in_channels, "out_channels": v.out_channels,
                    "latent_channels": v.latent_channels,
                    "block_out_channels": list(v.block_out_channels),
                    "layers_per_block": v.layers_per_block,
                    "scaling_factor": v.scaling_factor},
            "text_encoder": {"vocab_size": te.vocab_size, "d_model": te.d_model,
                             "d_kv": te.d_kv, "d_ff": te.d_ff, "num_layers": te.num_layers,
                             "num_heads": te.num_heads}}
    return {
        "transformer": {"in_channels": t.in_channels, "out_channels": t.out_channels,
                        "num_layers": t.num_layers, "num_attention_heads": t.num_attention_heads,
                        "attention_head_dim": t.attention_head_dim,
                        "num_cross_attention_heads": t.num_cross_attention_heads,
                        "cross_attention_head_dim": t.cross_attention_head_dim,
                        "caption_channels": t.caption_channels, "mlp_ratio": t.mlp_ratio,
                        "patch_size": t.patch_size},
        "vae": {"in_channels": v.in_channels, "latent_channels": v.latent_channels,
                "encoder_block_out_channels": list(v.encoder_block_out_channels),
                "decoder_block_out_channels": list(v.decoder_block_out_channels),
                "encoder_layers_per_block": list(v.encoder_layers_per_block),
                "decoder_layers_per_block": list(v.decoder_layers_per_block),
                "encoder_block_types": ["EfficientViTBlock" if vit else "ResBlock"
                                        for vit in v.vit_stages],
                "attention_head_dim": v.attention_head_dim, "scaling_factor": v.scaling_factor},
        "text_encoder": {"vocab_size": te.vocab_size, "hidden_size": te.hidden_size,
                         "intermediate_size": te.intermediate_size,
                         "num_hidden_layers": te.num_layers, "num_attention_heads": te.num_heads,
                         "num_key_value_heads": te.num_kv_heads, "head_dim": te.head_dim,
                         "query_pre_attn_scalar": te.query_pre_attn_scalar}}


def _write_dir(torch, model, root: str, name: str, tag: str) -> str:
    """`model` (bf16) written by the port's own saver as a diffusers
    directory `root`/`name`, with its config jsons -> its path."""
    from onetrainer_tpu_torch.io.pixart_checkpoints import save_pixart_diffusers
    from onetrainer_tpu_torch.io.sana_checkpoints import save_sana_diffusers
    from onetrainer_tpu_torch.io.sd_checkpoints import state_dict_of
    ckpt = os.path.join(root, name)
    t0 = time.perf_counter()
    sd = {part: state_dict_of(m) for part, m in model.modules().items()}
    save = save_pixart_diffusers if model.model_type.is_pixart() else save_sana_diffusers
    save(ckpt, model, sd["transformer"], sd["vae"], sd["text_encoder"], save_dtype=None)
    for component, config in _config_jsons(model).items():
        with open(os.path.join(ckpt, component, "config.json"), "w") as f:
            json.dump(config, f)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt) for f in fs)
    print(f"[{tag}] wrote {ckpt} ({size / 2 ** 30:.3f} GiB, bf16, diffusers layout, "
          f"{ {part: len(t) for part, t in sd.items()} } tensors) in "
          f"{time.perf_counter() - t0:.2f} s")
    return ckpt


def phase_pixart_sana_cli(torch, dataset: str) -> dict:
    """PixArt-Σ and Sana from diffusers directories through the train and
    sample commands (`_dit_lora_cli`: LoRA r16 a16 over sd15_files' PNGs at
    512x512, batch 4, the transformer NF4, gradient checkpointing on, epoch
    1 with a backup, the resume for epoch 2, the LoRA file read back bit
    for bit, the sample command in bf16 at CFG 4.5). Both at full width,
    cut to CUT_DIT_BLOCKS blocks, T5-XXL to CUT_T5_LAYERS and Gemma-2-2B to
    CUT_GEMMA_LAYERS layers, written in bf16 by the families' own savers.
    Per step exactly K4 once per NF4 layer and again per layer in the
    blocks, nothing else (fp32 adapters: no K5); no launch over the bf16
    sample."""
    import shutil

    from onetrainer_tpu_torch.setup.pixart_setup import PIXART_TOKENS
    from onetrainer_tpu_torch.setup.sana_setup import SANA_TOKENS
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    root = tempfile.mkdtemp(prefix="pixart_sana_files_")
    results = {}
    try:
        for model_type, build, layers, n_layers in (
                (ModelType.PIXART_SIGMA, lambda: build_pixart_model(
                    torch, CUT_DIT_BLOCKS, CUT_T5_LAYERS, quantize=False),
                 pixart_nf4_layers(CUT_DIT_BLOCKS)[0], pixart_nf4_layers(CUT_DIT_BLOCKS)),
                (ModelType.SANA, lambda: build_sana_model(
                    torch, CUT_DIT_BLOCKS, CUT_GEMMA_LAYERS, quantize=False),
                 sana_nf4_layers(CUT_DIT_BLOCKS)[0] - CUT_DIT_BLOCKS,
                 sana_nf4_layers(CUT_DIT_BLOCKS))):
            tag = f"{model_type.value.lower()}_cli"
            model = build()
            # the cache's rows: the latent, and the text states at the setup's
            # length (the reference's: T5 120 tokens, Gemma 300 with its mask)
            latent = PIXART_SANA_CLI_SIZE // model.vae_config.spatial_scale
            latent_shape = (latent, latent, model.vae_config.latent_channels)
            cache_shapes = {"latent_image": latent_shape, "t5_hidden_state": (
                PIXART_TOKENS, model.te_config.d_model)} if model_type.is_pixart() else {
                "latent_image": latent_shape,
                "text_encoder_hidden_state": (SANA_TOKENS, model.te_config.hidden_size),
                "tokens_mask": (SANA_TOKENS,)}
            family_root = os.path.join(root, tag)
            os.makedirs(family_root)
            ckpt = _write_dir(torch, model, family_root, model_type.value.lower(), tag)
            del model
            gc.collect()
            torch.cuda.empty_cache()
            n_quant, n_in_blocks = n_layers
            per_step = {"K1": 0, "K2": 0, "K3": 0, "K3pre": 0, "K4": n_quant + n_in_blocks,
                        "K5": 0}
            results[tag] = _dit_lora_cli(
                torch, tag, ckpt, dataset, model_type, PIXART_SANA_CLI_SIZE, per_step, layers,
                cache_shapes, ["--cfg", str(PIXART_CFG)], 0, "full",
                "bf16 diffusers directory to the card, the transformer quantized to NF4",
                prior_dtype=DataType.NFLOAT_4)
            shutil.rmtree(family_root, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": {k: results["pixart_sigma_cli"]["launches"][k]
                         + results["sana_cli"]["launches"][k]
                         for k in results["sana_cli"]["launches"]},
            **results}


# -- Würstchen v2 and Stable Cascade (phase 40) ---------------------------------------

WUERSTCHEN_SIZE = 1024
CASCADE_BATCH = 4
WUERSTCHEN_CFG = 4.0
WUERSTCHEN_PROMPT = "a photograph of an astronaut riding a horse"
# warp-ai/wuerstchen-prior's prior/config.json, as prior_config_from_diffusers reads it
V2_PRIOR_JSON = {"c_in": 16, "c": 1536, "c_cond": 1280, "c_r": 64, "depth": 32, "nhead": 24}
# wuerstchen_cli's files: the v2 prior cut to V2_CLI_DEPTH of its 32 triples,
# CLIP-G and the decoder's CLIP-H to CUT_CLIP_LAYERS layers, DiffNeXt to one
# block per level (full width); Stable Cascade's stage_c file cut to
# CUT_CASCADE_BLOCKS, CLIP-G beside it to CUT_CLIP_LAYERS
V2_CLI_DEPTH, CUT_CLIP_LAYERS = 4, 2
CUT_DIFFNEXT_BLOCKS = (1, 1, 1, 1)
CUT_CASCADE_BLOCKS = (1, 2)


def cascade_nf4_layers(blocks: tuple) -> tuple[int, int]:
    """(NF4 layers of a Stable Cascade prior, those LoRA adapts): 11 per
    triple (the depthwise 3x3, 2048 x 9 = 18,432 >= 4096 elements; the
    channelwise MLP's two; the timestep block's mapper, mapper_sca and
    mapper_crp; the kv mapper, q, k, v and out) in 2 x sum(blocks) triples,
    and 7 outside them (the three CLIP mappers, the embedding and head
    convs, the two level transitions' 1x1 convs); LoRA adapts all but the
    depthwise convs."""
    triples = 2 * sum(blocks)
    return 11 * triples + 7, 10 * triples + 7


def v2_lora_layers(depth: int) -> int:
    """Layers LoRA adapts in a Würstchen v2 prior of `depth` triples: 8 per
    triple (the channelwise MLP's two, the timestep mapper, the kv mapper,
    q, k, v, out; not the depthwise conv) and 4 outside (the projection,
    the two cond mappers, the head)."""
    return 8 * depth + 4


def diffnext_attention(cfg) -> int:
    """Attention blocks of one DiffNeXt pass: each level's "A"s, down and up."""
    return 2 * sum(b * lc.count("A") for b, lc in zip(cfg.blocks, cfg.level_config))


def _wuerstchen_seeded(torch, model, tag: str, parts: tuple) -> None:
    """Seeded weights for `parts` of `model` on the card (each in the dtype
    it has on "meta"); the eps head's weights scaled to a tenth and its bias
    zeroed, so b of (x_in - a) / (|1 - b| + 1e-5) stays near 0 as in a
    trained prior (a random head puts some b near 1, where eps is ~1e5)."""
    from onetrainer_tpu_torch.io.weights import init_wuerstchen_weights
    counts = {name: sum(p.numel() for p in getattr(model, name).parameters()) for name in parts}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_wuerstchen_weights(model, seed=0, device="cuda", parts=parts)
    head = model.prior.clf[1] if model.model_type.is_stable_cascade() else model.prior.out[1]
    with torch.no_grad():
        head.weight.mul_(0.1)
        head.bias.zero_()
    torch.cuda.synchronize()
    dtypes = {name: str(next(getattr(model, name).parameters()).dtype) for name in parts}
    print(f"[{tag}] parameters {counts} (total {sum(counts.values())}), seeded on the card in "
          f"{time.perf_counter() - t0:.2f} s ({dtypes}), {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB allocated")


def build_cascade_model(torch, quantize: bool = True, blocks: tuple | None = None,
                        te_layers: int | None = None):
    """Stable Cascade's stage C at CascadePriorConfig's defaults (the released
    prior: c_hidden (2048, 2048), 32 d=64 heads, blocks (8, 24); `blocks`
    when given) with seeded weights on the card, the prior in bf16 (NF4 with
    `quantize`), CLIP-G with its projection (`te_layers` of its 32 layers
    when given) and EfficientNetV2-S in fp32, bf16 compute."""
    from dataclasses import replace

    from onetrainer_tpu_torch.models.cascade import CascadePriorConfig
    from onetrainer_tpu_torch.models.clip import open_clip_vit_bigg_config
    from onetrainer_tpu_torch.models.wuerstchen import EffnetConfig
    from onetrainer_tpu_torch.models.wuerstchen_model import WuerstchenModel
    from onetrainer_tpu_torch.util.enums import ModelType
    prior = CascadePriorConfig(dtype=torch.bfloat16)
    if blocks is not None:
        prior = replace(prior, blocks=blocks)
    te = open_clip_vit_bigg_config(dtype=torch.bfloat16)
    if te_layers is not None:
        te = replace(te, num_layers=te_layers)
    model = WuerstchenModel(model_type=ModelType.STABLE_CASCADE_1, prior_config=prior,
                            effnet_config=EffnetConfig(dtype=torch.bfloat16), te_config=te,
                            device="meta")
    model.prior.to(torch.bfloat16)
    tag = "cascade_model"
    print(f"[{tag}] Stable Cascade stage C: c_hidden {prior.c_hidden}, heads {prior.nhead} "
          f"of d=64, blocks {prior.blocks}, c_cond {prior.c_cond}; CLIP-G {te.num_layers} "
          f"layers (projection {te.projection_dim}); EfficientNetV2-S")
    _wuerstchen_seeded(torch, model, tag, ("prior", "text_encoder", "effnet"))
    if quantize:
        _quantize_prior(torch, model.prior, tag, cascade_nf4_layers(prior.blocks)[0])
    return model


def build_wuerstchen_model(torch, depth: int = 32, te_layers: int | None = None,
                           diffnext_blocks: tuple | None = None,
                           clip_h_layers: int | None = None, effnet: bool = False):
    """Würstchen v2 at its published widths with seeded weights on the card:
    the prior from warp-ai/wuerstchen-prior's config (c 1536, 24 heads, c_cond
    1280 read by prior_config_from_diffusers; `depth` of its 32 triples) in
    bf16, CLIP-G without the projection (`te_layers` of 32), DiffNeXt at
    DiffNeXtConfig's defaults in bf16 (`diffnext_blocks` per level when
    given), the Paella VQGAN in fp32 and the decoder's CLIP-H (`clip_h_layers`
    of 24); EfficientNetV2-S only with `effnet`."""
    from dataclasses import replace

    from onetrainer_tpu_torch.io.wuerstchen_checkpoints import prior_config_from_diffusers
    from onetrainer_tpu_torch.models.clip import CLIPTextModel, open_clip_vit_bigg_config
    from onetrainer_tpu_torch.models.diffnext import DiffNeXtConfig, WuerstchenDiffNeXt
    from onetrainer_tpu_torch.models.paella_vq import PaellaVQConfig, PaellaVQDecoder
    from onetrainer_tpu_torch.models.wuerstchen import EffnetConfig
    from onetrainer_tpu_torch.models.wuerstchen_model import WuerstchenModel, clip_h_text_config
    from onetrainer_tpu_torch.util.enums import ModelType
    bf16 = torch.bfloat16
    te = replace(open_clip_vit_bigg_config(dtype=bf16), projection_dim=None)
    if te_layers is not None:
        te = replace(te, num_layers=te_layers)
    model = WuerstchenModel(
        model_type=ModelType.WUERSTCHEN_2,
        prior_config=prior_config_from_diffusers(dict(V2_PRIOR_JSON, depth=depth), bf16),
        effnet_config=EffnetConfig(dtype=bf16), te_config=te, device="meta")
    model.decoder_config = DiffNeXtConfig(dtype=bf16)
    if diffnext_blocks is not None:
        model.decoder_config = replace(model.decoder_config, blocks=diffnext_blocks)
    model.vqgan_config = PaellaVQConfig()
    model.decoder_te_config = clip_h_text_config(dtype=bf16)
    if clip_h_layers is not None:
        model.decoder_te_config = replace(model.decoder_te_config, num_layers=clip_h_layers)
    with torch.device("meta"):
        model.decoder = WuerstchenDiffNeXt(model.decoder_config).to(bf16)
        model.vqgan = PaellaVQDecoder(model.vqgan_config)
        model.decoder_text_encoder = CLIPTextModel(model.decoder_te_config)
    model.prior.to(bf16)
    tag = "wuerstchen_model"
    pc, dc = model.prior_config, model.decoder_config
    print(f"[{tag}] Würstchen v2: prior c {pc.c}, {pc.depth} triples of {pc.nhead} d=64 heads, "
          f"c_cond {pc.c_cond}; CLIP-G {te.num_layers} layers; DiffNeXt c_hidden "
          f"{dc.c_hidden}, blocks {dc.blocks}, heads {dc.nhead}; Paella VQGAN embed "
          f"{model.vqgan_config.embed_dim}; decoder CLIP-H {model.decoder_te_config.num_layers} "
          f"layers")
    parts = ("prior", "text_encoder", "decoder", "vqgan", "decoder_text_encoder")
    _wuerstchen_seeded(torch, model, tag, parts + (("effnet",) if effnet else ()))
    return model


def _wuerstchen_batch(torch, setup, batch_size: int, size: int) -> dict:
    """The family's cache rows at size x size, tiled: the effnet latent of a
    seeded image (the x0.75 resize, ImageNet normalization, EfficientNetV2-S)
    and the prompt's CLIP states (Cascade's raw states and pooled
    projection)."""
    from onetrainer_tpu_torch.setup.families import get_family
    encode_images, encode_text = get_family(setup.config.model_type).make_encode_fns(setup)
    gen = torch.Generator(device="cuda").manual_seed(11)
    image = torch.rand((1, size, size, 3), generator=gen, device="cuda") * 2 - 1
    text = encode_text(WUERSTCHEN_PROMPT)

    def tile(t):
        return t.expand(batch_size, *t.shape[1:]).contiguous()
    batch = {"latent_image": tile(encode_images(image)["latent_image"]),
             "loss_weight": torch.ones((batch_size,), device="cuda")}
    batch.update({name: tile(value[None]) for name, value in text.items()
                  if isinstance(value, torch.Tensor)})
    return batch


def _wuerstchen_sample(torch, model, tag: str, prior_attn: int, k4_per_pass: int) -> dict:
    """Text-to-image through the family registry at 1024x1024: the prior's 4
    steps with CFG WUERSTCHEN_CFG, then (v2 with its decoder stage) DiffNeXt's
    10 and the Paella VQGAN, else the linear stand-in. Exactly K1 once per
    attention block per pass (the prior's `prior_attn`, DiffNeXt's), K4
    `k4_per_pass` per prior pass, nothing else; every denoiser output finite;
    a uint8 1024x1024x3 image that is not constant. -> launches, image
    latency, per-step milliseconds."""
    from onetrainer_tpu_torch.config.sample_config import SampleConfig
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.sampling.wuerstchen_sampler import DECODER_STEPS
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import TrainingMethod
    config = TrainConfig.default_values()
    config.model_type = model.model_type
    config.training_method = TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    setup = family.create_setup(model, config, 1)
    sc = SampleConfig.default_values()
    sc.prompt, sc.negative_prompt = WUERSTCHEN_PROMPT, ""
    sc.height = sc.width = WUERSTCHEN_SIZE
    sc.diffusion_steps = 4
    sc.cfg_scale = WUERSTCHEN_CFG
    sc.seed = 42
    decoded = model.model_type.is_wuerstchen_v2() and model.decoder is not None
    decoder_attn = diffnext_attention(model.decoder_config) if decoded else 0
    finite = []
    hooks = [m.register_forward_hook(lambda m, i, o: finite.append(bool(torch.isfinite(o).all())))
             for m in ((model.prior, model.decoder) if decoded else (model.prior,))]
    stamps = []

    def on_progress(step, total):
        torch.cuda.synchronize()
        stamps.append((total, time.perf_counter()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    try:
        image = family.sample(setup, sc, on_progress).image
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    prior_t = [t for total, t in stamps if total == sc.diffusion_steps]
    dec_t = [t for total, t in stamps if total == DECODER_STEPS] if decoded else []
    prior_ms = [(b - a) * 1e3 for a, b in zip(prior_t, prior_t[1:])]
    dec_ms = [(b - a) * 1e3 for a, b in zip(dec_t, dec_t[1:])]
    expected = {"K1": prior_attn * sc.diffusion_steps + decoder_attn * DECODER_STEPS,
                "K2": 0, "K3": 0, "K3pre": 0, "K4": k4_per_pass * sc.diffusion_steps, "K5": 0}
    passes = sc.diffusion_steps + (DECODER_STEPS if decoded else 0)
    ok = (launches == expected and len(finite) == passes and all(finite)
          and image.dtype.name == "uint8"
          and image.shape == (WUERSTCHEN_SIZE, WUERSTCHEN_SIZE, 3) and image.std() > 0)
    decoder = (f"DiffNeXt {DECODER_STEPS} steps, step median {statistics.median(dec_ms):.2f} ms "
               f"(steps 2..{DECODER_STEPS}), then the Paella VQGAN" if decoded
               else "the linear stand-in decode")
    print(f"[{tag}] {model.model_type.value} {WUERSTCHEN_SIZE}x{WUERSTCHEN_SIZE} on {gpu_line()}: "
          f"image latency {total_s:.3f} s; prior {sc.diffusion_steps} steps CFG "
          f"{sc.cfg_scale:g}, denoiser step median {statistics.median(prior_ms):.2f} ms "
          f"(steps 2..{sc.diffusion_steps}: {', '.join(f'{t:.2f}' for t in prior_ms)}); "
          f"{decoder}; peak max_memory_allocated {peak_gib:.2f} GiB; launches {launches} "
          f"(expected {expected}); {len(finite)} denoiser passes all finite {all(finite)}; "
          f"image {image.shape} {image.dtype} mean {image.mean():.2f} std {image.std():.2f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} failed its checks")
    return {"launches": launches, "total_s": total_s,
            "prior_step_ms": statistics.median(prior_ms),
            "decoder_step_ms": statistics.median(dec_ms) if dec_ms else None,
            "peak_gib": peak_gib}


def phase_cascade_sample(torch, model) -> dict:
    """cascade_sample: the NF4 stage C with the pooled text and CFG, decoded
    by the stand-in (the reference has no stage B for Stable Cascade)."""
    blocks = model.prior_config.blocks
    return _wuerstchen_sample(torch, model, "cascade_sample", 2 * sum(blocks),
                              cascade_nf4_layers(blocks)[0])


def phase_wuerstchen_sample(torch, model) -> dict:
    """wuerstchen_sample: the v2 prior, DiffNeXt and the Paella VQGAN."""
    return _wuerstchen_sample(torch, model, "wuerstchen_sample", model.prior_config.depth, 0)


def phase_cascade_train(torch, model) -> dict:
    """cascade_train: LoRA r16 a16 over the NF4 stage C with bf16 adapters and
    stochastic rounding, AdamW 1e-4, clip 1.0, batch 4 at 1024x1024 on cached
    24x24x16 effnet latents and CLIP-G's 77 states and pooled projection
    (CLIP-G and the effnet freed once cached), no checkpointing: one warm-up
    step whose optimizer call is watched (16 named adapters' updates
    against the same AdamW on the host from its gradients, norm and state),
    TRAIN_STEPS timed steps with exactly, per step, K1-K3 and the pre-pass
    once per attention block (64), K4 once per NF4 layer, K5 once; K4 on
    every layer's codes bit for bit; one step's gradients with K1-K4 against
    plain attention and the plain dequant; one step's K5 call bit for bit;
    the plain rounding's time over the set; a profiler split."""
    from onetrainer_tpu_torch.train.train_state import param_groups, param_names
    from onetrainer_tpu_torch.util.enums import DataType, ModelType
    tag = "cascade_train"
    blocks = model.prior_config.blocks
    attn = 2 * sum(blocks)
    n_quant, adapted = cascade_nf4_layers(blocks)
    config = _lora_config(CASCADE_BATCH, ModelType.STABLE_CASCADE_1)
    config.prior.weight_dtype = DataType.NFLOAT_4
    config.lora_weight_dtype = DataType.BFLOAT_16
    config.optimizer.stochastic_rounding = True
    watch = {}

    def after_batch(setup):
        model.text_encoder = model.effnet = None
        gc.collect()
        torch.cuda.empty_cache()
        groups = param_groups(setup.state.params)["prior_lora"]
        watch["indices"] = _checked_indices(groups, OPT_CHECK_LEAVES)
        watch["seen"] = _watch_next_update(torch, setup, "prior_lora", watch["indices"])

    run = _setup_and_steps(torch, model, config, tag, WUERSTCHEN_SIZE, after_batch=after_batch,
                           make_batch=lambda setup: _wuerstchen_batch(
                               torch, setup, CASCADE_BATCH, WUERSTCHEN_SIZE))
    setup, batch = run["setup"], run["batch"]
    names = param_names(setup.state.params)["prior_lora"]
    cpu = _against_the_cpu(torch, setup, watch.pop("seen"), "prior_lora", watch["indices"],
                           names)
    expected = {"K1": TRAIN_STEPS * attn, "K2": TRAIN_STEPS * attn, "K3": TRAIN_STEPS * attn,
                "K3pre": TRAIN_STEPS * attn, "K4": TRAIN_STEPS * n_quant, "K5": TRAIN_STEPS}
    _k4_over_the_layers(torch, model.prior, tag)
    grads = _grads_against_plain(torch, setup, batch, tag, plain_dequant=True)
    k5 = _k5_over_the_adapters(torch, setup, batch, run["gen"], tag)
    k5["plain_ms"] = _k5_set_plain_ms(torch, setup)
    adapters = setup.state.params["prior_lora"]
    checks = {
        "finite": run["finite"] and grads["finite"],
        "lora_up moved": run["up_max"] > 0,
        "launches per step": run["launches"] == expected,
        "K1 per forward": grads["by_seq"] == {576: attn},
        "gradients against plain attention and dequant": grads["rel"] <= GRAD_REL_L2_BOUND,
        "warm-up update against the host": cpu["worst"] <= OPT_UPDATE_REL,
        "adapted layers": len(adapters) == adapted and set(setup.state.params) == {"prior_lora"},
        "cached rows": tuple(batch["latent_image"].shape) == (CASCADE_BATCH, 24, 24, 16)
        and tuple(batch["text_encoder_hidden_state"].shape) == (CASCADE_BATCH, 77, 1280)
        and tuple(batch["pooled_text_encoder_output"].shape) == (CASCADE_BATCH, 1280),
    }
    print(f"[{tag}] on {gpu_line()}: {n_quant} NF4 layers, {len(adapters)} adapted (expected "
          f"{adapted}); the warm-up's update of {len(watch['indices'])} named adapters against "
          f"the host's AdamW: worst rel L2 {cpu['worst']:.3e} (bound {OPT_UPDATE_REL:g}; "
          f"{', '.join(f'{k} {v:.2e}' for k, v in list(cpu['rel'].items())[:4])}, ...); K5 over "
          f"the {k5['leaves']} adapter tensors {k5['ms']:.4f} ms, plain {k5['plain_ms']:.2f} ms, "
          f"least time {k5['bound_ms']:.4f} ms ({k5['bound_by']}); launches {run['launches']} "
          f"(expected {expected}); checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} failed: {[k for k, ok in checks.items() if not ok]}")
    profile_train_step(torch, setup, batch, run["gen"], tag)
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"], "k5": k5}


def phase_cascade_ft(torch, model) -> dict:
    """cascade_ft: the bf16 stage C fine-tuned in full under Adafactor with
    stochastic rounding (`_dit_fine_tune`: K5 over the whole prior, 3.6e9
    elements, one launch per step), batch 4 at 1024x1024 on the cached rows,
    CLIP-G and the effnet freed once cached; the gradients against plain
    attention taken for the embedding, the first triple and the head (every
    attention of the network lies on their backward path)."""
    from onetrainer_tpu_torch.train.sd_train_step import UPDATE_CHUNK_ELEMENTS
    from onetrainer_tpu_torch.util.enums import ModelType
    attn = 2 * sum(model.prior_config.blocks)
    config = _dit_ft_config(ModelType.STABLE_CASCADE_1, CASCADE_BATCH, train_te=False)
    n = sum(p.numel() for p in model.prior.parameters())
    chunk = min(n, UPDATE_CHUNK_ELEMENTS)
    reckoning = (f"the reckoning: weights {_gib(n):.2f} + gradients {_gib(n):.2f} + one chunk "
                 f"of updates {_gib(chunk):.2f} GiB of "
                 f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f} GiB; ")

    def free_encoders(setup):
        model.text_encoder = model.effnet = None

    def watched(setup):
        return {name: t for name, t in setup.state.params["prior"].items()
                if name.startswith(("embedding.1.", "down_blocks.0.0.", "down_blocks.0.1.",
                                    "down_blocks.0.2.", "clf.1."))}

    per_step = {"K1": attn, "K2": attn, "K3": attn, "K3pre": attn}
    return _dit_fine_tune(torch, model, config, "cascade_ft", WUERSTCHEN_SIZE, per_step,
                          {576: attn}, watched, after_batch=free_encoders,
                          make_batch=lambda setup: _wuerstchen_batch(
                              torch, setup, CASCADE_BATCH, WUERSTCHEN_SIZE),
                          reckoning=reckoning)


def _v2_config_jsons(model) -> dict:
    """config.json of the prior and of each CLIP (transformers' keys) for a
    v2 prior directory, and of DiffNeXt, the VQGAN and the decoder's CLIP
    for a decoder directory."""
    def clip(c):
        return {"vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                "intermediate_size": c.intermediate_size, "num_hidden_layers": c.num_layers,
                "num_attention_heads": c.num_heads,
                "max_position_embeddings": c.max_position_embeddings,
                "hidden_act": c.hidden_act, "eos_token_id": c.eos_token_id}
    p, d, v = model.prior_config, model.decoder_config, model.vqgan_config
    return {
        "prior": {"c_in": p.c_in, "c": p.c, "c_cond": p.c_cond, "c_r": p.c_r, "depth": p.depth,
                  "nhead": p.nhead},
        "text_encoder": clip(model.te_config),
        "decoder": {"c_in": d.c_in, "c_out": d.c_out, "c_r": d.c_r, "patch_size": d.patch_size,
                    "c_cond": d.c_cond, "c_hidden": list(d.c_hidden), "nhead": list(d.nhead),
                    "blocks": list(d.blocks), "level_config": list(d.level_config),
                    "inject_effnet": list(d.inject_effnet), "effnet_embd": d.effnet_embd,
                    "clip_embd": d.clip_embd, "kernel_size": d.kernel_size},
        "vqgan": {"embed_dim": v.embed_dim, "bottleneck_blocks": v.bottleneck_blocks,
                  "latent_channels": v.latent_channels, "scale_factor": v.scale_factor},
        "decoder_text_encoder": clip(model.decoder_te_config),
    }


def wuerstchen_files(torch, root: str) -> dict:
    """A seeded v2 at its published widths, the prior cut to V2_CLI_DEPTH
    triples and CLIP-G to CUT_CLIP_LAYERS layers, written in bf16 by the
    port's own savers: the prior directory (prior/, text_encoder/), the
    effnet file, and the decoder directory (DiffNeXt cut to
    CUT_DIFFNEXT_BLOCKS, the VQGAN, CLIP-H cut to CUT_CLIP_LAYERS) -> their
    paths."""
    from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
    from onetrainer_tpu_torch.io.sd_checkpoints import state_dict_of
    from onetrainer_tpu_torch.io.wuerstchen_checkpoints import (
        save_wuerstchen_decoder, save_wuerstchen_diffusers,
    )
    model = build_wuerstchen_model(torch, V2_CLI_DEPTH, CUT_CLIP_LAYERS, CUT_DIFFNEXT_BLOCKS,
                                   CUT_CLIP_LAYERS, effnet=True)
    t0 = time.perf_counter()
    configs = _v2_config_jsons(model)
    ckpt = os.path.join(root, "wuerstchen_v2")
    save_wuerstchen_diffusers(ckpt, model, state_dict_of(model.prior),
                              state_dict_of(model.text_encoder), save_dtype=torch.bfloat16)
    for component in ("prior", "text_encoder"):
        with open(os.path.join(ckpt, component, "config.json"), "w") as f:
            json.dump(configs[component], f)
    effnet = os.path.join(root, "effnet_encoder.safetensors")
    save_safetensors(effnet, {k: v.detach().cpu() for k, v in model.effnet.state_dict().items()})
    decoder = os.path.join(root, "wuerstchen_decoder")
    save_wuerstchen_decoder(decoder, state_dict_of(model.decoder), state_dict_of(model.vqgan),
                            state_dict_of(model.decoder_text_encoder),
                            {"decoder": configs["decoder"], "vqgan": configs["vqgan"],
                             "text_encoder": configs["decoder_text_encoder"]},
                            save_dtype=torch.bfloat16)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    print(f"[wuerstchen_files] wrote {ckpt}, {effnet} and {decoder} ({size / 2 ** 30:.3f} GiB) "
          f"in {time.perf_counter() - t0:.2f} s")
    files = {"ckpt": ckpt, "effnet": effnet, "decoder": decoder,
             "decoder_attn": diffnext_attention(model.decoder_config)}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return files


def _cascade_single_file(torch, root: str) -> dict:
    """Stable Cascade's stage_c file at cut depth (CUT_CASCADE_BLOCKS, CLIP-G
    CUT_CLIP_LAYERS layers), written by the family's single-file export in
    bf16 and loaded back through the registry: every tensor bit for bit,
    the config read from the shapes."""
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import DataType, ModelType, TrainingMethod
    model = build_cascade_model(torch, False, CUT_CASCADE_BLOCKS, CUT_CLIP_LAYERS)
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_CASCADE_1
    config.training_method = TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    config.weight_dtype = DataType.BFLOAT_16
    family = get_family(config.model_type)
    setup = family.create_setup(model, config, 1)
    path = os.path.join(root, "stage_c.safetensors")
    t0 = time.perf_counter()
    family.save_single_file(setup, path, save_dtype=torch.bfloat16)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = family.load(path, config, device="cuda")
    read_s = time.perf_counter() - t0
    same = {}
    for name in ("prior", "text_encoder"):
        a, b = getattr(model, name).state_dict(), getattr(loaded, name).state_dict()
        same[name] = set(a) == set(b) and all(
            torch.equal(a[k].to(torch.bfloat16), b[k]) for k in a)
    ok = all(same.values()) and loaded.prior_config.blocks == CUT_CASCADE_BLOCKS \
        and loaded.prior_config.nhead == (32, 32) and loaded.prior_config.c_in == 16
    size = os.path.getsize(path) + os.path.getsize(os.path.join(root, "text_encoder.safetensors"))
    print(f"[wuerstchen_cli] Stable Cascade stage_c at blocks {CUT_CASCADE_BLOCKS} and CLIP-G "
          f"{CUT_CLIP_LAYERS} layers: written in {write_s:.2f} s ({size / 2 ** 30:.3f} GiB, "
          f"bf16), read back in {read_s:.2f} s, config {loaded.prior_config.c_hidden} heads "
          f"{loaded.prior_config.nhead} blocks {loaded.prior_config.blocks} c_in "
          f"{loaded.prior_config.c_in}; bit for bit {same} {'ok' if ok else 'FAIL'}")
    del model, loaded, setup
    gc.collect()
    torch.cuda.empty_cache()
    return {"ok": ok}


def phase_wuerstchen_cli(torch, dataset: str) -> dict:
    """wuerstchen_cli: the cut v2 (`wuerstchen_files`) through the train
    command (`_dit_lora_cli`: LoRA r16 a16 on the bf16 prior over sd15_files'
    PNGs at 1024x1024, batch 4, the effnet caching 24x24x16 latents,
    gradient checkpointing on, epoch 1 with a backup, the resume for epoch
    2, the LoRA file read back bit for bit) and the sample command with
    `--decoder-model-name` (the prior's 4 steps, DiffNeXt's 10, the VQGAN);
    then Stable Cascade's stage_c file at cut depth (`_cascade_single_file`).
    Per step exactly K1 twice and K2, K3 and the pre-pass once per prior
    triple, nothing else; none while caching."""
    import shutil

    from onetrainer_tpu_torch.util.enums import ModelType
    root = tempfile.mkdtemp(prefix="wuerstchen_files_")
    try:
        files = wuerstchen_files(torch, root)
        d = V2_CLI_DEPTH
        per_step = {"K1": 2 * d, "K2": d, "K3": d, "K3pre": d, "K4": 0, "K5": 0}
        latent = int(round(WUERSTCHEN_SIZE * 0.75)) // 32
        result = _dit_lora_cli(
            torch, "wuerstchen_cli", files["ckpt"], dataset, ModelType.WUERSTCHEN_2,
            WUERSTCHEN_SIZE, per_step, v2_lora_layers(d),
            {"latent_image": (latent, latent, 16), "text_encoder_hidden_state": (77, 1280)},
            ["--cfg", str(WUERSTCHEN_CFG), "--decoder-model-name", files["decoder"]],
            4 * d + 10 * files["decoder_attn"], "full",
            "bf16 prior directory and effnet file to the card", denoiser="prior",
            configure=lambda config: setattr(config.effnet_encoder, "model_name",
                                             files["effnet"]))
        single = _cascade_single_file(torch, root)
        if not single["ok"]:
            raise AssertionError("wuerstchen_cli: the stage_c file did not read back bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return result


def _k1_row(k1, shape: str, path: str, dims: tuple, suffix: str, err=None) -> tuple:
    """K1 at one case of phase k1, with the launches of `path`."""
    err = err or (lambda tag, case: case)
    return (f"flash_attention_folded_fwd (K1){suffix}", "K1", "flash_fwd.cu",
            "onetrainer_tpu/ops/flash_folded.py:93", path,
            err("K1", k1[shape]["err_o"]), k1[shape]["ms"], k1[shape]["plain_ms"],
            *_attn_bounds(*dims)["K1"], k1[shape]["library_ms"], shape)


def _attention_rows(k1, k23, shape: str, path: str, dims: tuple, suffix: str,
                    err=None) -> list:
    """K1, K2, K3 and the pre-pass at one case of phases k1/k23, with the
    launches of `path`. `err` picks each row's max_abs_err (default: the
    case's own)."""
    bounds = _attn_bounds(*dims)
    err = err or (lambda tag, case: case)
    return [
        _k1_row(k1, shape, path, dims, suffix, err),
        (f"flash_attention_folded_dq (K2, delta given){suffix}", "K2", "flash_bwd.cu",
         "onetrainer_tpu/ops/flash_folded.py:196", path,
         err("K2", k23[shape]["errs"]["dq"]), k23[shape]["k2_ms"],
         k23[shape]["plain_dq_ms"], *bounds["K2"], k23[shape]["library_ms"], shape),
        (f"flash_attention_folded_dkv (K3, delta given){suffix}", "K3", "flash_bwd.cu",
         "onetrainer_tpu/ops/flash_folded.py:248", path,
         err("K3", max(k23[shape]["errs"]["dk"], k23[shape]["errs"]["dv"])),
         k23[shape]["k3_ms"], k23[shape]["plain_dkv_ms"], *bounds["K3"],
         k23[shape]["library_ms"], shape),
        (f"flash_attention_folded_delta (K3's pre-pass){suffix}", "K3pre", "flash_bwd.cu",
         "onetrainer_tpu/ops/flash_folded.py:276", path,
         err("K3pre", k23[shape]["err_delta"]), k23[shape]["delta_ms"],
         k23[shape]["plain_delta_ms"], *bounds["delta"], None, shape),
    ]


def _kernel_table(k1, k23, k4, k5, k5_ft, launches: dict, k5_dit: dict) -> dict:
    """One row per kernel and path: `launches` from the path that runs it
    (K1-K3 the fp32-base SDXL LoRA step, and again at SD 1.5's, SD 2.1's,
    SD3's and FLUX's shapes with their steps' launches; K4-K5 the QLoRA step,
    K4 again at FLUX's largest kernel with the FLUX step's; K5 again at
    the SDXL fine-tune's largest leaf, with the call's time with its
    wrapper and the whole update's device time, bound and host time beside
    it; and at the SD3 and FLUX fine-tunes' largest leaves, `k5_dit`, with
    their whole updates beside them, and HunyuanVideo's; K4 again with the
    DoRA step's launches; K1-K3 again at the fine-tunes' shapes, FLUX's at batch 1,
    HunyuanVideo's), the device time at that path's shape, and the counts
    of every path."""
    worst = {
        "K1": max(c["err_o"] for c in k1.values()),
        "K2": max(c["errs"]["dq"] for c in k23.values()),
        "K3": max(max(c["errs"]["dk"], c["errs"]["dv"]) for c in k23.values()),
        "K3pre": max(c["err_delta"] for c in k23.values()),
    }
    ff = K4_CASES[0][0]
    rows = _attention_rows(k1, k23, "sdxl_b2_s4096_h10_d64", "train", (2, 4096, 4096, 10, 64),
                           "", err=lambda tag, case: worst[tag])
    rows += _attention_rows(k1, k23, SD15_SHAPE, "sd15_train", (4, 4096, 4096, 8, 40),
                            " at SD 1.5's B4 S4096 H8 d40")
    rows += _attention_rows(k1, k23, SD21_SHAPE, "sd21_train", (2, 9216, 9216, 5, 64),
                            " at SD 2.1's B2 S9216 H5 d64")
    rows += _attention_rows(k1, k23, SD3_SHAPE, "sd3_train", (2, 4250, 4250, 24, 64),
                            " at SD3's B2 S4250 H24 d64")
    rows += _attention_rows(k1, k23, FLUX_SHAPE, "flux_train", (2, 4173, 4173, 24, 128),
                            " at FLUX's B2 S4173 H24 d128")
    rows += _attention_rows(k1, k23, HV_SHAPE, "hunyuan_train",
                            (1, HV_TOKENS, HV_TOKENS, 24, 128),
                            f" at HunyuanVideo's B1 S{HV_TOKENS} H24 d128 with the keep mask")
    rows += [
        ("nf4_dequant_flat (K4)", "K4", "nf4_dequant.cu",
         "onetrainer_tpu/ops/nf4_pallas.py:41", "qlora",
         max(c["max_abs_err"] for c in k4.values()), k4[ff]["ms"],
         k4[ff]["plain_ms"], k4[ff]["bound_ms"], k4[ff]["bound_by"], None, ff),
        ("nf4_dequant_flat (K4) at FLUX's norm1.linear", "K4", "nf4_dequant.cu",
         "onetrainer_tpu/ops/nf4_pallas.py:41", "flux_train", k4[FLUX_K4]["max_abs_err"],
         k4[FLUX_K4]["ms"], k4[FLUX_K4]["plain_ms"], k4[FLUX_K4]["bound_ms"],
         k4[FLUX_K4]["bound_by"], None, FLUX_K4),
        ("nf4_dequant_flat (K4) at FLUX.1-fill's x_embedder", "K4", "nf4_dequant.cu",
         "onetrainer_tpu/ops/nf4_pallas.py:41", "flux_fill_train",
         k4[FLUX_FILL_K4]["max_abs_err"], k4[FLUX_FILL_K4]["ms"], k4[FLUX_FILL_K4]["plain_ms"],
         k4[FLUX_FILL_K4]["bound_ms"], k4[FLUX_FILL_K4]["bound_by"], None, FLUX_FILL_K4),
        ("nf4_dequant_flat (K4) at HunyuanVideo's norm1.linear (FLUX's shape)", "K4",
         "nf4_dequant.cu", "onetrainer_tpu/ops/nf4_pallas.py:41", "hunyuan_train",
         k4[FLUX_K4]["max_abs_err"], k4[FLUX_K4]["ms"], k4[FLUX_K4]["plain_ms"],
         k4[FLUX_K4]["bound_ms"], k4[FLUX_K4]["bound_by"], None, FLUX_K4),
        ("sr_update_leaves (K5, one launch per step)", "K5", "sr_update.cu",
         "onetrainer_tpu/ops/pallas_sr.py:26", "qlora", k5["max_abs_err"], k5["list_ms"],
         k5["list_plain_ms"], k5["list_bound_ms"], k5["list_bound_by"], None,
         f"{k5['n_leaves']} QLoRA adapter tensors, {k5['n_elements']} elements"),
        ("sr_update_leaves (K5) at the SDXL fine-tune's largest leaf", "K5", "sr_update.cu",
         "onetrainer_tpu/ops/pallas_sr.py:26", "sdxl_ft", k5_ft["max_abs_err"], k5_ft["ms"],
         k5_ft["plain_ms"], k5_ft["bound_ms"], k5_ft["bound_by"], None, k5_ft["shape"]),
    ]
    rows += [(f"sr_update_leaves (K5) at the {label} fine-tune's largest leaf", "K5",
              "sr_update.cu", "onetrainer_tpu/ops/pallas_sr.py:26", path,
              k5_dit[path]["max_abs_err"], k5_dit[path]["ms"], k5_dit[path]["plain_ms"],
              k5_dit[path]["bound_ms"], k5_dit[path]["bound_by"], None, k5_dit[path]["shape"])
             for path, label in (("sd3_ft", "SD3"), ("flux_ft", "FLUX"),
                                 ("hunyuan_ft", "HunyuanVideo"),
                                 ("sd15_vae_ft", "SD 1.5 VAE"),
                                 ("cascade_ft", "Stable Cascade prior"))]
    rows += [(f"nf4_dequant_flat (K4) at {label}", "K4", "nf4_dequant.cu",
              "onetrainer_tpu/ops/nf4_pallas.py:41", path, k4[case]["max_abs_err"],
              k4[case]["ms"], k4[case]["plain_ms"], k4[case]["bound_ms"],
              k4[case]["bound_by"], None, case)
             for path, label, case in (
                 ("pixart_train", "PixArt-Σ's adaln_single.linear", PIXART_K4),
                 ("sana_train", "Sana's GLUMBConv conv_inverted", SANA_K4))]
    rows += [(f"sr_update_leaves (K5) over {label}'s adapter set", "K5", "sr_update.cu",
              "onetrainer_tpu/ops/pallas_sr.py:26", path, k5_dit[path]["max_abs_err"],
              k5_dit[path]["ms"], k5_dit[path]["plain_ms"], k5_dit[path]["bound_ms"],
              k5_dit[path]["bound_by"], None,
              f"{k5_dit[path]['leaves']} bf16 adapter tensors, {k5_dit[path]['elements']} "
              f"elements")
             for path, label in (("pixart_train", "PixArt-Σ"), ("sana_train", "Sana"),
                                 ("cascade_train", "Stable Cascade"))]
    cascade = (4, 576, 658, 32, 64)
    rows += _attention_rows(k1, k23, CASCADE_SHAPE, "cascade_train", cascade,
                            " at Stable Cascade's B4 Sq576 Skv658 H32 d64")
    rows += _attention_rows(k1, k23, CASCADE_SHAPE, "cascade_ft", cascade,
                            " at Stable Cascade's B4 Sq576 Skv658 H32 d64 (the fine-tune)")
    rows += _attention_rows(k1, k23, V2_SHAPE, "wuerstchen_cli", (4, 576, 653, 24, 64),
                            " at Würstchen v2's B4 Sq576 Skv653 H24 d64 (the train command)")
    rows += [_k1_row(k1, shape, path, dims, label)
             for shape, path, dims, label in (
                 (CASCADE_SAMPLE_SHAPE, "cascade_sample", (2, 576, 658, 32, 64),
                  " at Stable Cascade's sampling B2 Sq576 Skv658 H32 d64"),
                 (V2_SAMPLE_SHAPE, "wuerstchen_sample", (2, 576, 653, 24, 64),
                  " at Würstchen v2's sampling B2 Sq576 Skv653 H24 d64"),
                 (DIFFNEXT_SHAPES[0], "wuerstchen_sample", (1, 4096, 4173, 10, 64),
                  " at DiffNeXt's B1 Sq4096 Skv4173 H10 d64"),
                 (DIFFNEXT_SHAPES[1], "wuerstchen_sample", (1, 1024, 1101, 20, 64),
                  " at DiffNeXt's B1 Sq1024 Skv1101 H20 d64"),
                 (DIFFNEXT_SHAPES[2], "wuerstchen_sample", (1, 256, 333, 20, 64),
                  " at DiffNeXt's B1 Sq256 Skv333 H20 d64"))]
    rows.append(("nf4_dequant_flat (K4) at Stable Cascade's channelwise MLP", "K4",
                 "nf4_dequant.cu", "onetrainer_tpu/ops/nf4_pallas.py:41", "cascade_train",
                 k4[CASCADE_K4]["max_abs_err"], k4[CASCADE_K4]["ms"], k4[CASCADE_K4]["plain_ms"],
                 k4[CASCADE_K4]["bound_ms"], k4[CASCADE_K4]["bound_by"], None, CASCADE_K4))
    rows.append(("nf4_dequant_flat (K4) under DoRA", "K4", "nf4_dequant.cu",
                 "onetrainer_tpu/ops/nf4_pallas.py:41", "sdxl_dora",
                 max(c["max_abs_err"] for c in k4.values()), k4[ff]["ms"],
                 k4[ff]["plain_ms"], k4[ff]["bound_ms"], k4[ff]["bound_by"], None, ff))
    rows += _attention_rows(k1, k23, HV_SHAPE, "hunyuan_ft", (1, HV_TOKENS, HV_TOKENS, 24, 128),
                            f" at HunyuanVideo's B1 S{HV_TOKENS} H24 d128 (the fine-tune)")
    rows += _attention_rows(k1, k23, SD3_SHAPE, "sd3_ft", (2, 4250, 4250, 24, 64),
                            " at SD3's B2 S4250 H24 d64 (the fine-tune)")
    rows += _attention_rows(k1, k23, FLUX_SAMPLE_SHAPE, "flux_ft", (1, 4173, 4173, 24, 128),
                            " at FLUX's B1 S4173 H24 d128 (the fine-tune)")
    rows += _attention_rows(k1, k23, "sdxl_b2_s4096_h10_d64", "sdxl_embedding",
                            (2, 4096, 4096, 10, 64), " in the SDXL embedding step")
    rows += _attention_rows(k1, k23, "sdxl_b2_s4096_h10_d64", "sdxl_optimizers",
                            (2, 4096, 4096, 10, 64), " in the SDXL optimizer steps")
    rows += _attention_rows(k1, k23, SD15_SHAPE, "sd15_ft_8bit", (4, 4096, 4096, 8, 40),
                            " in the SD 1.5 fine-tune under AdamW and AdamW 8-bit")
    kernels = []
    for (name, tag, source, replaces, path, err, ms, plain_ms, bound_ms, bound_by,
         library_ms, shape) in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": f"onetrainer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[path][tag], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": shape, "path": path,
            "library_backend": (k1 if tag == "K1" else k23).get(shape, {}).get(
                "library_backend") if library_ms is not None else None,
            "launches_by_path": {p: counts[tag] for p, counts in launches.items()},
        })
    # the fine-tunes' K5 rows: the whole update's time, bound and host time
    updates = {"sdxl_ft": k5_ft, **{p: k5_dit[p] for p in k5_dit
                                   if p not in ("pixart_train", "sana_train", "cascade_train")}}
    extras = ("set_ms", "set_bound_ms", "set_host_ms", "leaves", "elements", "u_dtype")
    for row in kernels:
        k5_row = updates.get(row["path"])
        if k5_row is None or not row["name"].startswith("sr_update_leaves"):
            continue
        row["ms_with_wrapper"] = k5_row["ms_with_wrapper"]
        row.update({f"update_{k}": k5_row[k] for k in extras})
        row["update_launches"] = k5_row.get("launches_per_update", 1)
    return {"kernels": kernels}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import onetrainer_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    failures = []
    results: dict = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            results[name] = fn(*args)
            return results[name]
        except Exception:
            failures.append(name)
            print(f"[{name}] FAILED\n{traceback.format_exc()}", file=sys.stderr)
            return None
        finally:
            print(f"[{name}] phase wall time {time.perf_counter() - t0:.1f} s")

    gpu = run("nvidia-smi", gpu_line)
    if gpu is not None:
        print(gpu)
    run("build", phase_build)
    run("k1", phase_k1_cases, torch)
    run("k23", phase_k23_cases, torch)
    run("k4", phase_k4, torch)
    run("k5", phase_k5, torch)
    model = run("model", build_model, torch)
    if model is not None:
        run("unet", phase_unet, torch, model)
        run("sample", phase_sample, torch, model, 1024, SDXL_SELF_ATTN, "sample")
        run("train", phase_train, torch, model, _lora_config(2), 1024, SDXL_SELF_ATTN,
            "train")
        run("sdxl_optimizers", phase_sdxl_optimizers, torch, model,
            (results.get("train") or {}).pop("batch", None))
    # the fp32 model must not stay alive into the later phases' peak memory
    del model
    results.pop("model", None)
    # the PEFT phases train on the qlora and fp8 phases' models
    for name, fn, peft in (("qlora", phase_qlora, ("sdxl_dora", phase_sdxl_dora)),
                           ("fp8", phase_fp8, ("sdxl_loha", phase_sdxl_loha)),
                           ("sdxl_ft", phase_sdxl_ft, None)):
        gc.collect()
        torch.cuda.empty_cache()
        out = run(name, fn, torch)
        if peft is not None and out is not None:
            model = out.pop("model")
            gc.collect()
            torch.cuda.empty_cache()
            run(*peft, torch, model)
            del model
    gc.collect()
    torch.cuda.empty_cache()
    run("sdxl_embedding", phase_sdxl_embedding, torch)
    import shutil
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    inputs = tempfile.mkdtemp(prefix="inpaint_inputs_")
    try:
        run("sdxl_inpaint", phase_sdxl_inpaint, torch, inputs)
    finally:
        shutil.rmtree(inputs, ignore_errors=True)

    from onetrainer_tpu_torch.util.enums import ModelType
    gc.collect()
    torch.cuda.empty_cache()
    model = run("sd15_model", build_model, torch, None, ModelType.STABLE_DIFFUSION_15)
    if model is not None:
        run("sd15_sample", phase_sample, torch, model, 512, SD15_SELF_ATTN,
            "sd15_sample")
        run("sd15_train", phase_train, torch, model,
            _lora_config(4, ModelType.STABLE_DIFFUSION_15), 512, SD15_SELF_ATTN,
            "sd15_train")
        gc.collect()
        torch.cuda.empty_cache()
        run("sd15_ft_8bit", phase_sd15_ft_8bit, torch, model,
            (results.get("sd15_train") or {}).pop("batch", None))
    del model
    results.pop("sd15_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("sd21_model", build_model, torch, None, ModelType.STABLE_DIFFUSION_21)
    if model is not None:
        config = _lora_config(2, ModelType.STABLE_DIFFUSION_21)
        config.force_v_prediction = True   # the 768-v checkpoint's objective
        run("sd21_train", phase_train, torch, model, config, 768, SD21_SELF_ATTN,
            "sd21_train")
    del model
    results.pop("sd21_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    run("sd15_vae_ft", phase_sd15_vae_ft, torch)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("sd3_model", build_sd3_model, torch)
    if model is not None:
        run("sd3_sample", phase_sample, torch, model, 1024, {4250: SD3_BLOCKS}, "sd3_sample")
        run("sd3_transformer", phase_sd3_transformer, torch, model)
        # the fine-tune casts the model to bf16 and trains it; the LoRA step
        # after it quantizes the transformer to fp8 and frees the encoders
        run("sd3_ft", phase_sd3_ft, torch, model)
        gc.collect()
        torch.cuda.empty_cache()
        run("sd3_train", phase_sd3_train, torch, model)
    del model
    results.pop("sd3_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("flux_model", build_flux_model, torch)
    if model is not None:
        run("flux_sample", phase_sample, torch, model, 1024, {FLUX_TOKENS: FLUX_BLOCKS},
            "flux_sample", FLUX_GUIDANCE, flux_nf4_layers(FLUX_DOUBLE, FLUX_SINGLE)[0])
        run("flux_transformer", phase_flux_transformer, torch, model)
        run("flux_train", phase_flux_train, torch, model)
    del model
    results.pop("flux_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("flux_fill_model", build_flux_model, torch, FLUX_DOUBLE, FLUX_SINGLE, True,
                ModelType.FLUX_FILL_DEV_1)
    if model is not None:
        inputs = tempfile.mkdtemp(prefix="inpaint_inputs_")
        try:
            run("flux_fill_sample", phase_sample, torch, model, 1024,
                {FLUX_TOKENS: FLUX_BLOCKS}, "flux_fill_sample", FLUX_FILL_GUIDANCE,
                flux_nf4_layers(FLUX_DOUBLE, FLUX_SINGLE)[0], 1,
                inpaint_inputs(torch, inputs, 896, 1152))
        finally:
            shutil.rmtree(inputs, ignore_errors=True)
        run("flux_fill_train", phase_flux_fill_train, torch, model)
    del model
    results.pop("flux_fill_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    # the bf16 FLUX.1-dev of the full fine-tune, after the NF4 models are freed
    model = run("flux_ft_model", build_flux_model, torch, FLUX_DOUBLE, FLUX_SINGLE, False)
    if model is not None:
        run("flux_ft", phase_flux_ft, torch, model)
    del model
    results.pop("flux_ft_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("hunyuan_model", build_hunyuan_model, torch)
    if model is not None:
        run("hunyuan_sample", phase_sample, torch, model, HV_SIZE, {HV_TOKENS: HV_BLOCKS},
            "hunyuan_sample", HV_GUIDANCE, hunyuan_nf4_layers(HV_DOUBLE, HV_SINGLE)[0],
            HV_FRAMES)
        run("hunyuan_transformer", phase_hunyuan_transformer, torch, model)
        run("hunyuan_train", phase_hunyuan_train, torch, model)
    del model
    results.pop("hunyuan_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    # the bf16 HunyuanVideo of the full fine-tune, after the NF4 model is freed
    model = run("hunyuan_ft_model", build_hunyuan_model, torch, HV_DOUBLE, HV_SINGLE, None,
                False)
    if model is not None:
        run("hunyuan_ft", phase_hunyuan_ft, torch, model)
    del model
    results.pop("hunyuan_ft_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("pixart_model", build_pixart_model, torch)
    if model is not None:
        run("pixart_sample", phase_sample, torch, model, PIXART_SANA_SIZE, {}, "pixart_sample",
            PIXART_CFG, pixart_nf4_layers(PIXART_BLOCKS)[0])
        run("pixart_train", phase_pixart_train, torch, model)
    del model
    results.pop("pixart_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("sana_model", build_sana_model, torch)
    if model is not None:
        run("sana_sample", phase_sample, torch, model, PIXART_SANA_SIZE, {}, "sana_sample",
            SANA_CFG, sana_nf4_layers(SANA_BLOCKS)[0])
        run("sana_train", phase_sana_train, torch, model)
    del model
    results.pop("sana_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("cascade_model", build_cascade_model, torch)
    if model is not None:
        run("cascade_sample", phase_cascade_sample, torch, model)
        run("cascade_train", phase_cascade_train, torch, model)
    del model
    results.pop("cascade_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    # the bf16 stage C of the full fine-tune, after the NF4 one is freed
    model = run("cascade_ft_model", build_cascade_model, torch, False)
    if model is not None:
        run("cascade_ft", phase_cascade_ft, torch, model)
    del model
    results.pop("cascade_ft_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    model = run("wuerstchen_model", build_wuerstchen_model, torch)
    if model is not None:
        run("wuerstchen_sample", phase_wuerstchen_sample, torch, model)
    del model
    results.pop("wuerstchen_model", None)
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="sd15_files_")
    try:
        files = run("sd15_files", sd15_files, torch, root)
        if files is not None:
            run("sd15_cli", phase_sd15_cli, torch,
                (results.get("sd15_train") or {}).get("sec_per_step"), files)
            gc.collect()
            torch.cuda.empty_cache()
            run("sd15_inpaint_cli", phase_sd15_inpaint_cli, torch, files)
            gc.collect()
            torch.cuda.empty_cache()
            # the 15 GB SD3 directory lives only for its phase
            sd3_root = tempfile.mkdtemp(prefix="sd3_files_")
            try:
                ckpt = run("sd3_files", sd3_files, torch, sd3_root)
                if ckpt is not None:
                    run("sd3_cli", phase_sd3_cli, torch, ckpt, files["dataset"])
            finally:
                shutil.rmtree(sd3_root, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
            flux_root = tempfile.mkdtemp(prefix="flux_files_")
            try:
                ckpt = run("flux_files", flux_files, torch, flux_root)
                if ckpt is not None:
                    run("flux_cli", phase_flux_cli, torch, ckpt, files["dataset"])
            finally:
                shutil.rmtree(flux_root, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
            hunyuan_root = tempfile.mkdtemp(prefix="hunyuan_files_")
            try:
                ckpt = run("hunyuan_files", hunyuan_files, torch, hunyuan_root)
                if ckpt is not None:
                    run("hunyuan_cli", phase_hunyuan_cli, torch, ckpt, files["dataset"])
                    gc.collect()
                    torch.cuda.empty_cache()
                    run("dit_single_file", phase_dit_single_file, torch, ckpt,
                        files["dataset"])
            finally:
                shutil.rmtree(hunyuan_root, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
            run("pixart_sana_cli", phase_pixart_sana_cli, torch, files["dataset"])
            gc.collect()
            torch.cuda.empty_cache()
            run("wuerstchen_cli", phase_wuerstchen_cli, torch, files["dataset"])
            gc.collect()
            torch.cuda.empty_cache()
            run("sd15_ft_cli", phase_sd15_ft_cli, torch, files)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    if failures:
        print(f"chip_smoke: failed phases: {', '.join(failures)}", file=sys.stderr)
        return 1
    launches = {"sample": results["sample"], "sd15_sample": results["sd15_sample"],
                "sd3_sample": results["sd3_sample"], "flux_sample": results["flux_sample"],
                "hunyuan_sample": results["hunyuan_sample"],
                "flux_fill_sample": results["flux_fill_sample"],
                "pixart_sample": results["pixart_sample"],
                "sana_sample": results["sana_sample"],
                "cascade_sample": results["cascade_sample"]["launches"],
                "wuerstchen_sample": results["wuerstchen_sample"]["launches"],
                "sdxl_inpaint_sample": results["sdxl_inpaint"]["sample_launches"],
                **{p: results[p]["launches"]
                   for p in ("train", "qlora", "fp8", "sdxl_ft", "sd15_train", "sd21_train",
                             "sd15_cli", "sd15_ft_cli", "sd3_train", "sd3_cli", "flux_train",
                             "flux_cli", "hunyuan_train", "hunyuan_cli", "flux_fill_train",
                             "sdxl_inpaint", "sd15_inpaint_cli", "sd3_ft", "flux_ft",
                             "dit_single_file", "sdxl_dora", "sdxl_loha", "hunyuan_ft",
                             "sdxl_embedding", "sd15_vae_ft", "pixart_train", "sana_train",
                             "pixart_sana_cli", "sdxl_optimizers", "sd15_ft_8bit",
                             "cascade_train", "cascade_ft", "wuerstchen_cli")},
                **{f"{p.removesuffix('_cli')}_embedding_cli": results[p]["embedding_launches"]
                   for p in ("sd15_cli", "sd3_cli", "flux_cli", "hunyuan_cli")},
                "sd15_lora_embedding_cli": results["sd15_cli"]["additional_embedding_launches"]}
    print(json.dumps(_kernel_table(results["k1"], results["k23"], results["k4"],
                                   results["k5"], results["sdxl_ft"]["k5"], launches,
                                   {p: results[p]["k5"] for p in ("sd3_ft", "flux_ft",
                                                                  "hunyuan_ft",
                                                                  "sd15_vae_ft",
                                                                  "pixart_train",
                                                                  "sana_train",
                                                                  "cascade_train",
                                                                  "cascade_ft")})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
