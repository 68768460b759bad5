"""The newest checkpoint of a directory, by step number.

The port's own copy of ``get_last_checkpoint`` (reference:
``versband_tpu/utils/checkpoint.py:52-64``, after ``ckpt_utils.py:7-21``):
files are ordered by the integer step in their name, never by the name, so
``model_ckpt_steps_100000`` comes after ``model_ckpt_steps_90000``. Besides
the reference's ``model_ckpt_steps_<n>.*`` it knows the parallel_wavegan
library's ``checkpoint-<n>steps.pkl``, BigVGAN's ``g_<n>`` and, for the
HiFi-GAN wrapper, ``model_ckpt_steps_<n>.ckpt`` alone.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

# kind -> (glob of one step's file, glob of all, the step in a file name)
PATTERNS = {
    "ldm": ("model_ckpt_steps_{}.*", "model_ckpt_steps_*", r"model_ckpt_steps_(\d+)"),
    "hifigan": ("model_ckpt_steps_{}.ckpt", "model_ckpt_steps_*.ckpt",
                r"model_ckpt_steps_(\d+)\.ckpt$"),
    "pwg": ("checkpoint-{}steps.pkl", "checkpoint-*steps.pkl", r"checkpoint-(\d+)steps\.pkl$"),
    "bigvgan": ("g_{:08d}", "g_*", r"g_(\d+)$"),
}


def get_last_checkpoint(ckpt_dir: str, steps: Optional[int] = None, kind: str = "ldm"
                        ) -> Tuple[Optional[str], Optional[str]]:
    """``(path, ckpt_dir)`` of the file with the largest step (or of step
    ``steps``), ``(None, ckpt_dir)`` when there is none. ``kind`` names the
    file pattern (:data:`PATTERNS`); ``"ldm"`` is the reference's."""
    one, every, step_re = PATTERNS[kind]
    pattern = one.format(steps) if steps is not None else every
    found = []
    for path in glob.glob(os.path.join(glob.escape(ckpt_dir), pattern)):
        m = re.match(step_re, os.path.basename(path))
        if m:
            found.append((int(m[1]), path))
    if not found:
        return None, ckpt_dir
    return max(found)[1], ckpt_dir
