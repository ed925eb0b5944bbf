"""SDXL model setup, inference part.

Counterpart of onetrainer_tpu/setup/sdxl_setup.py: schedule flags,
tokenizer wrapping and `merged_inference_params` for FINE_TUNE. LoRA and
embedding training need the PEFT layers, which are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from onetrainer_tpu.setup.tokenizer import SDTokenizer
from onetrainer_tpu_torch.models.sdxl import StableDiffusionXLModel
from onetrainer_tpu_torch.util.enums import TrainingMethod


@dataclass
class SDXLSetup:
    model: StableDiffusionXLModel
    config: object
    tokenizer: SDTokenizer
    tokenizer_2: SDTokenizer

    def merged_inference_params(self):
        """(unet, text_encoder, text_encoder_2, (extra_1, extra_2)) modules
        for sampling; FINE_TUNE has no trained deltas to merge."""
        m = self.model
        return m.unet, m.text_encoder, m.text_encoder_2, (None, None)


def create_sdxl_setup(model: StableDiffusionXLModel, config,
                      total_steps: int = 10_000,
                      steps_per_epoch: int = 100) -> SDXLSetup:
    if config.training_method in (TrainingMethod.LORA, TrainingMethod.EMBEDDING):
        raise NotImplementedError(
            f"{config.training_method} needs the PEFT layers, which the "
            "torch port does not have yet")
    if config.rescale_noise_scheduler_to_zero_terminal_snr:
        model.rescale_noise_scheduler_to_zero_terminal_snr()
        model.force_v_prediction()
    if config.force_v_prediction:
        model.force_v_prediction()
    if config.force_epsilon_prediction:
        model.force_epsilon_prediction()

    def wrap_tokenizer(tok, cfg):
        if isinstance(tok, SDTokenizer):
            return tok
        return SDTokenizer(tok, max_length=cfg.max_position_embeddings,
                           vocab_size=cfg.vocab_size,
                           bos=max(cfg.eos_token_id - 1, 0), eos=cfg.eos_token_id)

    model.tokenizer = wrap_tokenizer(model.tokenizer, model.te_config)
    model.tokenizer_2 = wrap_tokenizer(model.tokenizer_2, model.te2_config)
    return SDXLSetup(model=model, config=config, tokenizer=model.tokenizer,
                     tokenizer_2=model.tokenizer_2)
