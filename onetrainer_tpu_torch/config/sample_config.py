"""Sample definition config (reference: modules/util/config/SampleConfig.py);
the port's copy of onetrainer_tpu/config/sample_config.py."""

from onetrainer_tpu_torch.config.base_config import BaseConfig, Field
from onetrainer_tpu_torch.util.enums import NoiseScheduler


class SampleConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('enabled', True, bool),
            Field('prompt', '', str),
            Field('negative_prompt', '', str),
            Field('height', 512, int),
            Field('width', 512, int),
            Field('frames', 1, int),
            Field('length', 10.0, float),
            Field('seed', 42, int),
            Field('random_seed', False, bool),
            Field('diffusion_steps', 20, int),
            Field('cfg_scale', 7.0, float),
            Field('noise_scheduler', NoiseScheduler.DDIM, NoiseScheduler),
            Field('text_encoder_1_layer_skip', 0, int),
            Field('text_encoder_2_layer_skip', 0, int),
            Field('text_encoder_3_layer_skip', 0, int),
            Field('text_encoder_4_layer_skip', 0, int),
            Field('prior_attention_mask', False, bool),
            Field('force_last_timestep', False, bool),
            Field('sample_inpainting', False, bool),
            Field('base_image_path', '', str),
            Field('mask_image_path', '', str),
        ])

    def from_train_config(self, train_config):
        self.text_encoder_1_layer_skip = train_config.text_encoder_layer_skip
        self.text_encoder_2_layer_skip = train_config.text_encoder_2_layer_skip
        self.text_encoder_3_layer_skip = train_config.text_encoder_3_layer_skip
        self.text_encoder_4_layer_skip = train_config.text_encoder_4_layer_skip
        self.prior_attention_mask = train_config.prior.attention_mask
        self.force_last_timestep = train_config.rescale_noise_scheduler_to_zero_terminal_snr
        return self
