"""Outbound event channel from the trainer (reference:
modules/util/callbacks/TrainCallbacks.py). Every call is
exception-suppressed so UI/observer failures never kill training."""

from collections.abc import Callable


def _safe(fn: Callable | None, *args, **kwargs):
    if fn is not None:
        try:
            return fn(*args, **kwargs)
        except Exception:
            pass
    return None


class TrainCallbacks:
    def __init__(
            self,
            on_update_train_progress: Callable = None,
            on_update_status: Callable = None,
            on_sample_default: Callable = None,
            on_update_sample_default_progress: Callable = None,
            on_sample_custom: Callable = None,
            on_update_sample_custom_progress: Callable = None,
    ):
        self._on_update_train_progress = on_update_train_progress
        self._on_update_status = on_update_status
        self._on_sample_default = on_sample_default
        self._on_update_sample_default_progress = on_update_sample_default_progress
        self._on_sample_custom = on_sample_custom
        self._on_update_sample_custom_progress = on_update_sample_custom_progress

    def set_on_update_train_progress(self, fn: Callable):
        self._on_update_train_progress = fn

    def set_on_update_status(self, fn: Callable):
        self._on_update_status = fn

    def set_on_sample_default(self, fn: Callable):
        self._on_sample_default = fn

    def set_on_update_sample_default_progress(self, fn: Callable):
        self._on_update_sample_default_progress = fn

    def set_on_sample_custom(self, fn: Callable):
        self._on_sample_custom = fn

    def set_on_update_sample_custom_progress(self, fn: Callable):
        self._on_update_sample_custom_progress = fn

    def on_update_train_progress(self, train_progress, max_sample: int, max_epoch: int):
        _safe(self._on_update_train_progress, train_progress, max_sample, max_epoch)

    def on_update_status(self, status: str):
        _safe(self._on_update_status, status)

    def on_sample_default(self, sample):
        _safe(self._on_sample_default, sample)

    def on_update_sample_default_progress(self, name: str, step: int, max_step: int):
        _safe(self._on_update_sample_default_progress, name, step, max_step)

    def on_sample_custom(self, sample):
        _safe(self._on_sample_custom, sample)

    def on_update_sample_custom_progress(self, step: int, max_step: int):
        _safe(self._on_update_sample_custom_progress, step, max_step)
