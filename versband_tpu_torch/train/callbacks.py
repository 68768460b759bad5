"""Training callback hooks (port of ``versband_tpu/train/callbacks.py::Callback``).

Only the base hooks; the setup, image/audio logging and device-stats
callbacks are not ported yet.
"""

from __future__ import annotations


class Callback:
    def on_fit_start(self, trainer):
        pass

    def on_train_batch_end(self, trainer, batch, metrics, step: int):
        pass

    def on_epoch_start(self, trainer, epoch: int):
        pass

    def on_epoch_end(self, trainer, epoch: int):
        pass

    def on_exception(self, trainer):
        pass
