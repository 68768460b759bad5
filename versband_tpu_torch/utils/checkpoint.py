"""Checkpoint files: flat ``.npz`` param trees, and the newest checkpoint of a
directory by step number.

``flatten_params``, ``unflatten_params``, ``save_npz_params``,
``load_npz_params`` and ``merge_matching`` are the port's own copies of the
JAX package's (``versband_tpu/utils/checkpoint.py:21-49,85-104``; numpy,
and ``merge_matching`` also tensors): an ``.npz`` holds one array per
``/``-joined path of a param tree, which is how the JAX package exports
weights for the port to read.

``get_last_checkpoint`` is the port's own copy of the reference's (reference:
``versband_tpu/utils/checkpoint.py:52-64``, after ``ckpt_utils.py:7-21``):
files are ordered by the integer step in their name, never by the name, so
``model_ckpt_steps_100000`` comes after ``model_ckpt_steps_90000``. Besides
the reference's ``model_ckpt_steps_<n>.*`` it knows the parallel_wavegan
library's ``checkpoint-<n>steps.pkl``, BigVGAN's ``g_<n>`` and, for the
HiFi-GAN wrapper, ``model_ckpt_steps_<n>.ckpt`` alone.

``load_ckpt`` (JAX ``:67-82``) loads the newest checkpoint of a directory
into a module, a state_dict or a param tree through ``merge_matching``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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
    """Overlay ``loaded`` onto ``params`` (nested dicts, or a flat state_dict);
    a shape mismatch keeps the original (printed, as the reference does), and
    under ``strict`` a key the checkpoint lacks is printed. Leaves come back in
    the dtype of ``params``: numpy arrays, or tensors on the device of a
    tensor leaf."""
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
    if torch.is_tensor(loaded):
        loaded = loaded.detach().cpu().numpy()
    arr = np.asarray(loaded)
    shape = tuple(params.shape) if torch.is_tensor(params) else tuple(np.shape(params))
    if tuple(arr.shape) != shape:
        print(f"| shape mismatch at {path}: ckpt {arr.shape} vs model "
              f"{shape} — keeping model init")
        return params
    if torch.is_tensor(params):
        return torch.as_tensor(arr).to(dtype=params.dtype, device=params.device)
    return arr.astype(np.asarray(params).dtype)


def _read_tree(path: str) -> Dict[str, Any]:
    """The weights at ``path``: an ``.npz`` param tree, or what ``torch.load``
    reads (a Lightning checkpoint's ``state_dict``)."""
    if path.endswith(".npz"):
        return load_npz_params(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return obj


def load_ckpt(params: Any, ckpt_base_dir: str, model_name: str = "model", force: bool = True,
              strict: bool = True) -> Any:
    """Load the newest checkpoint of ``ckpt_base_dir`` (by step; or the file
    itself) into ``params``: a module (loaded in place and returned), its
    state_dict or a nested dict of arrays (the merged copy returned). The
    sub-model ``model_name`` is taken where the checkpoint holds one (a key
    of that name, or keys under ``model_name.``); weights whose shape
    differs keep ``params``' (``ckpt_utils.py:24-67`` semantics). No
    checkpoint: ``FileNotFoundError`` under ``force``, else ``params`` as it
    is."""
    path = ckpt_base_dir if os.path.isfile(ckpt_base_dir) else \
        get_last_checkpoint(ckpt_base_dir)[0]
    if path is None:
        if force:
            raise FileNotFoundError(f"no checkpoint in {ckpt_base_dir}")
        return params
    loaded = _read_tree(path)
    if model_name in loaded and isinstance(loaded[model_name], dict):
        loaded = loaded[model_name]
    elif any(k.startswith(model_name + ".") for k in loaded):
        loaded = {k[len(model_name) + 1:]: v for k, v in loaded.items()
                  if k.startswith(model_name + ".")}
    if isinstance(params, torch.nn.Module):
        params.load_state_dict(merge_matching(params.state_dict(), loaded, strict=strict))
        return params
    return merge_matching(params, loaded, strict=strict)
