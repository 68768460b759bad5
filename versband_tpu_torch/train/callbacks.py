"""Training callbacks (port of ``versband_tpu/train/callbacks.py``).

* ``SetupCallback``: the logdir layout, the merged config archived as
  ``<logdir>/configs/<now>-project.yaml`` (and ``<now>-lightning.yaml``),
  which ``cli.train -r <logdir>`` reads back; a checkpoint on a crash.
* ``ImageLogger``: every ``batch_frequency`` steps, the trainer's
  ``log_images`` mels as PNGs under ``<logdir>/images/<split>``. It writes
  one pixel per frame and bin, lowest bin at the bottom, through magma
  (``utils/png.py``): not matplotlib's 1000x300 figure, since the card has
  no matplotlib.
* ``AudioLogger``: also vocodes them to wavs under ``<logdir>/audio/<split>``
  through the vocoder of ``vocoder_cfg`` (the port's ``HifiGAN`` in the
  shipped YAML) on ``device``; a vocoder that cannot be built is printed and
  leaves mel-only logging.
* ``DeviceStatsCallback``: each epoch's seconds and the peak memory of the
  trainer's card (``torch.cuda.max_memory_allocated``).
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np


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


class SetupCallback(Callback):
    def __init__(self, resume: bool, now: str, logdir: str, ckptdir: str, cfgdir: str,
                 config, lightning_config=None, **kw):
        self.resume = resume
        self.now = now
        self.logdir = logdir
        self.ckptdir = ckptdir
        self.cfgdir = cfgdir
        self.config = config
        self.lightning_config = lightning_config

    def on_fit_start(self, trainer):
        from versband_tpu_torch.utils.config import config_to_yaml

        for d in (self.logdir, self.ckptdir, self.cfgdir):
            os.makedirs(d, exist_ok=True)
        with open(os.path.join(self.cfgdir, f"{self.now}-project.yaml"), "w") as f:
            f.write(config_to_yaml(self.config))
        if self.lightning_config is not None:
            with open(os.path.join(self.cfgdir, f"{self.now}-lightning.yaml"), "w") as f:
                f.write(config_to_yaml(self.lightning_config))

    def on_exception(self, trainer):
        print("Summoning checkpoint.")
        trainer.save_checkpoint("last")


class ImageLogger(Callback):
    """Log the trainer's ``log_images`` mels every ``batch_frequency`` steps
    (and at powers of two below it with ``increase_log_steps``)."""

    def __init__(self, batch_frequency: int = 5000, max_images: int = 8, clamp: bool = True,
                 increase_log_steps: bool = True, rescale: bool = True, melvmin: float = -5.0,
                 melvmax: float = 1.5, for_specs: bool = True, **kw):
        self.batch_freq = batch_frequency
        self.max_images = max_images
        self.melvmin = melvmin
        self.melvmax = melvmax
        self.log_steps = ([2 ** n for n in range(int(np.log2(batch_frequency)) + 1)]
                          if increase_log_steps else [batch_frequency])

    def check_frequency(self, step: int) -> bool:
        return step % self.batch_freq == 0 or step in self.log_steps

    def log_img(self, trainer, images: Dict[str, np.ndarray], step: int, split: str = "train"):
        from versband_tpu_torch.utils.png import mel_to_rgb, write_png

        root = os.path.join(trainer.logdir, "images", split)
        os.makedirs(root, exist_ok=True)
        for name, mels in images.items():
            for i, mel in enumerate(np.asarray(mels)[: self.max_images]):
                mel2d = mel[0] if mel.ndim == 3 else mel
                write_png(os.path.join(root, f"{name}_gs-{step:06}_{i:02}.png"),
                          mel_to_rgb(mel2d, self.melvmin, self.melvmax))
                if trainer.writer is not None:
                    trainer.writer.add_image(
                        f"{split}/{name}_{i}",
                        np.clip((mel2d - self.melvmin) / (self.melvmax - self.melvmin), 0, 1)[None],
                        step)

    def on_train_batch_end(self, trainer, batch, metrics, step: int):
        if not self.check_frequency(step):
            return
        if hasattr(trainer, "log_images"):
            # under a model axis every rank of rank 0's model row samples
            # (the backbone's slices meet in collectives); rank 0 writes
            images = trainer.log_images(batch)
            if images and trainer.is_main:
                self.log_img(trainer, images, step)


class AudioLogger(ImageLogger):
    """Also vocode the logged mels to ``sample_rate`` wavs."""

    def __init__(self, sample_rate: int = 24000, vocoder_cfg=None, device=None, **kw):
        super().__init__(**kw)
        from versband_tpu_torch.utils.config import instantiate_from_config

        self.sample_rate = sample_rate
        self.vocoder = None
        if vocoder_cfg is not None:
            try:
                self.vocoder = instantiate_from_config(vocoder_cfg, device=device)
            except Exception as e:
                print(f"AudioLogger: vocoder unavailable ({e}); mel-only logging")

    def log_img(self, trainer, images: Dict[str, np.ndarray], step: int, split: str = "train"):
        from versband_tpu_torch.dsp.audio_io import write_wav

        super().log_img(trainer, images, step, split)
        if self.vocoder is None:
            return
        root = os.path.join(trainer.logdir, "audio", split)
        os.makedirs(root, exist_ok=True)
        for name, mels in images.items():
            for i, mel in enumerate(np.asarray(mels)[: self.max_images]):
                wav = self.vocoder(mel[0] if mel.ndim == 3 else mel)
                write_wav(os.path.join(root, f"{name}_gs-{step:06}_{i:02}.wav"), wav,
                          self.sample_rate)
                if trainer.writer is not None:
                    trainer.writer.add_audio(f"{split}/{name}_audio_{i}", wav[None, :], step,
                                             sample_rate=self.sample_rate)


class DeviceStatsCallback(Callback):
    """Epoch time and the peak memory of the trainer's card."""

    def on_epoch_start(self, trainer, epoch: int):
        self._t0 = time.time()

    def on_epoch_end(self, trainer, epoch: int):
        import torch

        dt = time.time() - self._t0
        device = getattr(trainer, "device", None)
        if device is not None and device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
            print(f"Epoch {epoch}: {dt:.2f} s, peak device memory {peak:.2f} MiB")
        else:
            print(f"Epoch {epoch}: {dt:.2f} s")
