"""Checkpoint files: flat ``.npz`` param trees, and the newest checkpoint of a
directory by step number.

``flatten_params``, ``unflatten_params``, ``save_npz_params``,
``load_npz_params`` and ``merge_matching`` are the port's own copies of the
JAX package's (``versband_tpu/utils/checkpoint.py:21-49,85-104``, numpy
only): an ``.npz`` holds one array per ``/``-joined path of a param tree,
which is how the JAX package exports weights for the port to read.

``get_last_checkpoint`` is the port's own copy of the reference's (reference:
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
from typing import Any, Dict, Optional, Tuple

import numpy as np

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


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_npz_params(path: str, params: Any) -> None:
    np.savez(path, **flatten_params(params))


def load_npz_params(path: str) -> Dict[str, Any]:
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})


def merge_matching(params: Any, loaded: Any, strict: bool = True, path: str = "") -> Any:
    """Overlay ``loaded`` onto ``params``; a shape mismatch keeps the original
    (printed, as the reference does). Leaves come back as numpy arrays in the
    dtype of ``params``."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if isinstance(loaded, dict) and k in loaded:
                out[k] = merge_matching(v, loaded[k], strict, f"{path}/{k}")
            else:
                if strict:
                    print(f"| missing key in checkpoint: {path}/{k}")
                out[k] = v
        return out
    arr = np.asarray(loaded)
    if tuple(arr.shape) != tuple(np.shape(params)):
        print(f"| shape mismatch at {path}: ckpt {arr.shape} vs model "
              f"{np.shape(params)} — keeping model init")
        return params
    return arr.astype(np.asarray(params).dtype)
