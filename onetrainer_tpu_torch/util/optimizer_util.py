"""Per-optimizer default hyperparameters + user-setting persistence.

The port's copy of onetrainer_tpu/util/optimizer_util.py (reference:
modules/util/optimizer_util.py:12-445 — OPTIMIZER_DEFAULT_PARAMETERS and
change_optimizer), on the port's own config classes.

When the user switches optimizers, their tweaked settings for the old one
are remembered in config.optimizer_defaults and restored when they switch
back."""

from __future__ import annotations

from onetrainer_tpu_torch.config.train_config import TrainConfig, TrainOptimizerConfig
from onetrainer_tpu_torch.util.enums import Optimizer

OPTIMIZER_DEFAULT_PARAMETERS: dict[Optimizer, dict] = {
    Optimizer.ADAMW: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                      "weight_decay": 1e-2, "amsgrad": False,
                      "stochastic_rounding": False},
    Optimizer.ADAMW_8BIT: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                           "weight_decay": 1e-2, "amsgrad": False},
    Optimizer.ADAM: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                     "weight_decay": 0.0, "amsgrad": False,
                     "stochastic_rounding": False},
    Optimizer.ADAM_8BIT: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                          "weight_decay": 0.0, "amsgrad": False},
    Optimizer.SGD: {"momentum": 0.0, "weight_decay": 0.0, "nesterov": False},
    Optimizer.SGD_8BIT: {"momentum": 0.0, "weight_decay": 0.0,
                         "nesterov": False},
    Optimizer.LION: {"beta1": 0.9, "beta2": 0.99, "weight_decay": 0.0},
    Optimizer.LION_8BIT: {"beta1": 0.9, "beta2": 0.999, "weight_decay": 0.0},
    Optimizer.ADAGRAD: {"lr_decay": 0.0, "eps": 1e-10, "weight_decay": 0.0,
                        "initial_accumulator_value": 0},
    Optimizer.ADAGRAD_8BIT: {"lr_decay": 0.0, "eps": 1e-10,
                             "weight_decay": 0.0,
                             "initial_accumulator_value": 0},
    Optimizer.RMSPROP: {"alpha": 0.99, "eps": 1e-8, "momentum": 0.0,
                        "weight_decay": 0.0, "centered": False},
    Optimizer.RMSPROP_8BIT: {"alpha": 0.99, "eps": 1e-8, "momentum": 0.0,
                             "weight_decay": 0.0, "centered": False},
    Optimizer.LARS: {"momentum": 0.0, "weight_decay": 0.0,
                     "nesterov": False},
    Optimizer.LARS_8BIT: {"momentum": 0.0, "weight_decay": 0.0,
                          "nesterov": False},
    Optimizer.LAMB: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                     "weight_decay": 0.0},
    Optimizer.LAMB_8BIT: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                          "weight_decay": 0.0},
    Optimizer.ADEMAMIX: {"beta1": 0.9, "beta2": 0.999, "beta3": 0.9999,
                         "alpha": 5.0, "eps": 1e-8, "weight_decay": 0.01},
    Optimizer.ADEMAMIX_8BIT: {"beta1": 0.9, "beta2": 0.999, "beta3": 0.9999,
                              "alpha": 5.0, "eps": 1e-8,
                              "weight_decay": 0.01},
    Optimizer.ADOPT: {"beta1": 0.9, "beta2": 0.9999, "eps": 1e-6,
                      "weight_decay": 0.0},
    Optimizer.ADABELIEF: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-16,
                          "weight_decay": 0.0},
    Optimizer.YOGI: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-3,
                     "weight_decay": 0.0},
    Optimizer.TIGER: {"beta1": 0.965, "weight_decay": 0.01},
    Optimizer.ADAFACTOR: {"decay_rate": -0.8, "clip_threshold": 1.0,
                          "eps": 1e-30, "eps2": 1e-3, "beta1": None,
                          "weight_decay": 0.0,
                          "scale_parameter": False, "relative_step": False,
                          "warmup_init": False, "stochastic_rounding": True},
    Optimizer.CAME: {"beta1": 0.9, "beta2": 0.999, "beta3": 0.9999,
                     "eps": 1e-30, "eps2": 1e-16, "clip_threshold": 1.0,
                     "weight_decay": 1e-2, "stochastic_rounding": False},
    Optimizer.SCHEDULE_FREE_ADAMW: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                                    "weight_decay": 0.01,
                                    "weight_lr_power": 2.0},
    # momentum: the reference defaults to 0, but schedule-free recovers
    # the eval params by dividing by it, so 0 is unsupported (NaN) — 0.9
    # here, and train/optimizers.py:create_optimizer raises on 0 (the one
    # deviation from the reference's defaults the JAX package documents)
    Optimizer.SCHEDULE_FREE_SGD: {"momentum": 0.9, "weight_decay": 0.01,
                                  "weight_lr_power": 2.0},
    Optimizer.DADAPT_ADAM: {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                            "weight_decay": 0.0, "d0": 1e-6,
                            "decouple": False},
    Optimizer.DADAPT_SGD: {"momentum": 0.0, "weight_decay": 0.0,
                           "d0": 1e-6, "growth_rate": float("inf")},
    Optimizer.DADAPT_LION: {"beta1": 0.9, "beta2": 0.999,
                            "weight_decay": 0.0, "d0": 1e-6},
    Optimizer.DADAPT_ADA_GRAD: {"momentum": 0.0, "eps": 0.0,
                                "weight_decay": 0.0, "d0": 1e-6,
                                "growth_rate": float("inf")},
    Optimizer.DADAPT_ADAN: {"beta1": 0.98, "beta2": 0.92, "beta3": 0.99,
                            "eps": 1e-8, "weight_decay": 0.02, "d0": 1e-6,
                            "growth_rate": float("inf")},
    Optimizer.AIDA: {"beta1": 0.9, "beta2": 0.999, "k": 2, "xi": 1e-20,
                     "weight_decay": 0.0, "eps": 1e-8},
    Optimizer.PRODIGY: {"beta1": 0.9, "beta2": 0.999, "beta3": None,
                        "eps": 1e-8,
                        "weight_decay": 0.0, "d0": 1e-6, "d_coef": 1.0,
                        "decouple": True, "safeguard_warmup": False},
    Optimizer.PRODIGY_PLUS_SCHEDULE_FREE: {
        "beta1": 0.9, "beta2": 0.99, "beta3": None, "eps": 1e-8,
        "weight_decay": 0.0, "d0": 1e-6, "d_coef": 1.0,
        "stochastic_rounding": True},
}


def change_optimizer(config: TrainConfig) -> TrainOptimizerConfig:
    """Switch config.optimizer to config.optimizer.optimizer's saved (or
    default) settings, remembering the previous optimizer's user values
    (reference: optimizer_util.change_optimizer)."""
    new_optimizer = config.optimizer.optimizer

    saved = config.optimizer_defaults.get(str(new_optimizer))
    if saved is not None:
        new_config = saved.clone() if hasattr(saved, "clone") else \
            TrainOptimizerConfig.default_values().from_dict(saved)
    else:
        new_config = TrainOptimizerConfig.default_values()
        for key, value in OPTIMIZER_DEFAULT_PARAMETERS.get(new_optimizer, {}).items():
            setattr(new_config, key, value)
    new_config.optimizer = new_optimizer
    return new_config


def save_optimizer_defaults(config: TrainConfig):
    """Persist the current optimizer settings into optimizer_defaults."""
    config.optimizer_defaults[str(config.optimizer.optimizer)] = \
        config.optimizer.clone()


def init_optimizer_defaults(config: TrainConfig):
    """Fill None hyperparams with the per-optimizer defaults (applied when
    a preset leaves values unset)."""
    defaults = OPTIMIZER_DEFAULT_PARAMETERS.get(config.optimizer.optimizer, {})
    for key, value in defaults.items():
        if getattr(config.optimizer, key, None) is None:
            setattr(config.optimizer, key, value)
    return config.optimizer
