"""Per-concept dataset config (reference: modules/util/config/ConceptConfig.py).
Field names form the JSON contract with training_concepts/*.json. The port's
copy of onetrainer_tpu/config/concept_config.py."""

import random

from onetrainer_tpu_torch.config.base_config import BaseConfig, Field
from onetrainer_tpu_torch.util.enums import BalancingStrategy, ConceptType


class ConceptImageConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('enable_crop_jitter', True, bool),
            Field('enable_random_flip', True, bool),
            Field('enable_fixed_flip', False, bool),
            Field('enable_random_rotate', False, bool),
            Field('enable_fixed_rotate', False, bool),
            Field('random_rotate_max_angle', 0.0, float),
            Field('enable_random_brightness', False, bool),
            Field('enable_fixed_brightness', False, bool),
            Field('random_brightness_max_strength', 0.0, float),
            Field('enable_random_contrast', False, bool),
            Field('enable_fixed_contrast', False, bool),
            Field('random_contrast_max_strength', 0.0, float),
            Field('enable_random_saturation', False, bool),
            Field('enable_fixed_saturation', False, bool),
            Field('random_saturation_max_strength', 0.0, float),
            Field('enable_random_hue', False, bool),
            Field('enable_fixed_hue', False, bool),
            Field('random_hue_max_strength', 0.0, float),
            Field('enable_resolution_override', False, bool),
            Field('resolution_override', '512', str),
            Field('enable_random_circular_mask_shrink', False, bool),
            Field('enable_random_mask_rotate_crop', False, bool),
        ])


class ConceptTextConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('prompt_source', 'sample', str),
            Field('prompt_path', '', str),
            Field('enable_tag_shuffling', False, bool),
            Field('tag_delimiter', ',', str),
            Field('keep_tags_count', 1, int),
            Field('tag_dropout_enable', False, bool),
            Field('tag_dropout_mode', 'FULL', str),
            Field('tag_dropout_probability', 0.0, float),
            Field('tag_dropout_special_tags_mode', 'NONE', str),
            Field('tag_dropout_special_tags', '', str),
            Field('tag_dropout_special_tags_regex', False, bool),
            Field('caps_randomize_enable', False, bool),
            Field('caps_randomize_mode', 'capslock, title, first, random', str),
            Field('caps_randomize_probability', 0.0, float),
            Field('caps_randomize_lowercase', False, bool),
        ])


class ConceptConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('image', ConceptImageConfig.default_values(), ConceptImageConfig),
            Field('text', ConceptTextConfig.default_values(), ConceptTextConfig),
            Field('name', '', str),
            Field('path', '', str),
            Field('seed', random.randint(-(1 << 30), 1 << 30), int),
            Field('enabled', True, bool),
            Field('type', ConceptType.STANDARD, ConceptType),
            Field('include_subdirectories', False, bool),
            Field('image_variations', 1, int),
            Field('text_variations', 1, int),
            Field('balancing', 1.0, float),
            Field('balancing_strategy', BalancingStrategy.REPEATS, BalancingStrategy),
            Field('loss_weight', 1.0, float),
            Field('concept_stats', {}, dict),
        ])
