"""CLI training entry point of the port (reference: scripts/train.py).

    python -m onetrainer_tpu_torch.scripts.train --config-path my_run.json \
        [--secrets-path secrets.json] [--device cuda]

The config JSON is the reference's v6 schema (older versions migrate on
load). Training runs on the card unless `--device` names another
device. A run that crashes exits 1. The remote-control files
(`--callback-path`, `--command-path`) are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from onetrainer_tpu_torch.config.concept_config import ConceptConfig
from onetrainer_tpu_torch.config.sample_config import SampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig
from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
from onetrainer_tpu_torch.util.commands import TrainCommands
from onetrainer_tpu_torch.util.create import create_trainer


def parse_args(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description="Train a model")
    parser.add_argument("--config-path", required=True,
                        help="path to the train config json")
    parser.add_argument("--secrets-path", default=None,
                        help="path to a secrets json")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    return parser.parse_args(argv)


def load_config(args) -> TrainConfig:
    config = TrainConfig.default_values()
    with open(args.config_path) as f:
        config.from_dict(json.load(f))
    if args.secrets_path and os.path.exists(args.secrets_path):
        with open(args.secrets_path) as f:
            config.secrets.from_dict(json.load(f))

    if config.concepts is None and os.path.exists(config.concept_file_name):
        with open(config.concept_file_name) as f:
            config.concepts = [ConceptConfig.default_values().from_dict(c)
                               for c in json.load(f)]
    if config.samples is None and os.path.exists(config.sample_definition_file_name):
        with open(config.sample_definition_file_name) as f:
            config.samples = [SampleConfig.default_values().from_dict(s)
                              for s in json.load(f)]
    return config


def main(argv: list[str] | None = None,
         callbacks: TrainCallbacks | None = None):
    """Parse `argv` (the command line when None), train, save; -> the
    trainer. `callbacks` replaces the status printer (for a caller that
    runs it in-process)."""
    args = parse_args(argv)
    config = load_config(args)
    callbacks = callbacks or TrainCallbacks(
        on_update_status=lambda s: print(f"status: {s}", flush=True))
    trainer = create_trainer(config, callbacks, TrainCommands(), device=args.device)

    trainer.start()
    canceled = False
    crashed = False
    try:
        trainer.train()
    except KeyboardInterrupt:
        canceled = True
    except Exception:
        traceback.print_exc()
        canceled = True
        crashed = True

    if not canceled or config.backup_before_save:
        trainer.end()
    if crashed:
        sys.exit(1)
    return trainer


if __name__ == "__main__":
    main()
