"""Training checkpoints: monitored top-k, ``last`` and step archives (port of
``versband_tpu/train/checkpoints.py::CheckpointManager``), and
:func:`load_model_checkpoint`, the partial restore of one model's weights.

Checkpoints are written with ``torch.save`` as one file per name under
``<ckpt_dir>``: the state's ``state_dict()`` (module weights, optimizer,
counters, EMA). ``last_step.json`` beside ``last`` carries the step and
run-level scalars that live outside the train state, such as the
``scale_by_std`` latent scale factor, so a resume or an inference run
decodes at the trained scale. Under a ``(data, model)`` mesh the state's
``state_dict()`` is whole (``TrainState`` gathers it over the model group)
and rank 0 writes it, so the file is the one a one-process run writes:
``load_model_checkpoint`` and ``cli.generate`` read it unchanged, and it
resumes at any layout.

:func:`load_model_checkpoint` reads the port's own files, the JAX package's
``.npz`` exports and the reference's Lightning ``.ckpt``. The JAX package's
orbax directories are not read: export one with
``versband_tpu.utils.checkpoint.save_npz_params``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from versband_tpu_torch.utils.checkpoint import load_npz_params


class CheckpointManager:
    """Top-k + last checkpoints under ``ckpt_dir``."""

    def __init__(self, ckpt_dir: str, monitor: Optional[str] = None, mode: str = "min",
                 save_top_k: int = 3, every_n_train_steps: Optional[int] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.every_n_train_steps = every_n_train_steps
        self._scores: List[Dict[str, Any]] = self._load_index()

    @property
    def _index_path(self) -> str:
        return os.path.join(self.ckpt_dir, "index.json")

    def _load_index(self) -> List[Dict[str, Any]]:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return []

    def _save_index(self) -> None:
        with open(self._index_path, "w") as f:
            json.dump(self._scores, f, indent=2)

    def path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, f"{name}.pt")

    def _write(self, name: str, state: Any) -> str:
        path = self.path(name)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)  # a crash mid-write never leaves a torn checkpoint
        return path

    def save_last(self, state: Any, step: int, extra: Optional[Dict[str, Any]] = None) -> str:
        """``last`` plus ``last_step.json`` = {"step": step, **extra}."""
        path = self._write("last", state)
        with open(os.path.join(self.ckpt_dir, "last_step.json"), "w") as f:
            json.dump({"step": int(step), **(extra or {})}, f)
        return path

    def save_step_archive(self, state: Any, step: int) -> Optional[str]:
        if self.every_n_train_steps and step > 0 and step % self.every_n_train_steps == 0:
            return self._write(f"model_ckpt_steps_{step}", state)
        return None

    def save_monitored(self, state: Any, step: int, metrics: Dict[str, float]) -> Optional[str]:
        if self.monitor is None or self.monitor not in metrics:
            return None
        name = f"epoch_step_{step}"
        ranked = sorted(self._scores + [{"name": name, "score": float(metrics[self.monitor]),
                                         "step": int(step)}],
                        key=lambda r: r["score"], reverse=(self.mode == "max"))
        keep = ranked[: self.save_top_k]
        if not any(r["name"] == name for r in keep):
            return None
        path = self._write(name, state)
        for r in self._scores:
            if r not in keep and os.path.exists(self.path(r["name"])):
                os.remove(self.path(r["name"]))
        self._scores = keep
        self._save_index()
        return path

    def restore_last(self, state: Any) -> Any:
        """Load ``last`` into ``state`` (in place) and return it; None if absent."""
        path = self.path("last")
        if not os.path.exists(path):
            return None
        state.load_state_dict(torch.load(path, map_location="cpu", weights_only=False))
        return state

    def last_meta(self) -> Dict[str, Any]:
        p = os.path.join(self.ckpt_dir, "last_step.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def last_step(self) -> int:
        return int(self.last_meta().get("step", 0))


# the port's module classes -> their family in ``utils.convert.state_dict_from_jax``
_FAMILIES = {"BandMoeDiT": "dit", "TimeFreqMoeDiT": "dit", "AutoencoderKL": "vae",
             "AutoencoderKL2D": "vae", "VQModel": "vae", "VQModelInterface": "vae",
             "ConcatDiT": "concat_dit", "ConcatDiT2MLP": "concat_dit",
             "HybridDiT2MLP": "concat_dit", "HybridDiT2MLP2": "concat_dit",
             "ConcatOrderDiT": "concat_dit", "ConcatOrderDiT2": "concat_dit",
             "HifiGanGenerator": "hifigan",
             "BigVGANGenerator": "bigvgan", "ParallelWaveGANGenerator": "pwg",
             "T5Encoder": "t5", "VAEGANLoss": "vaegan_loss"}
# where the reference's Lightning checkpoints keep a sub-model's weights
_LIGHTNING_PREFIXES = ("model.diffusion_model.", "first_stage_model.", "")


def prune_ignored(state: Dict[str, Any], ignore_keys: Sequence[str] = ()) -> Dict[str, Any]:
    """Drop the keys that start with an ``ignore_keys`` prefix (``ddpm.py:190-196``)."""
    out = {}
    for k, v in state.items():
        if any(k.startswith(ig) for ig in ignore_keys):
            print(f"Deleting key {k} from state_dict.")
            continue
        out[k] = v
    return out


def _extract_jax_params(tree: Any) -> Any:
    """The model params of a JAX trainer's tree (a ``TrainState``, or stage 1's
    ``{"gen", "disc"}`` pair); any other tree as it is (JAX ``:147-160``)."""
    if isinstance(tree, dict):
        if "gen" in tree and "disc" in tree:
            return _extract_jax_params(tree["gen"])
        if "params" in tree and ("opt_state" in tree or "step" in tree):
            return tree["params"]
    return tree


def _matches(own: Dict[str, torch.Tensor], loaded: Dict[str, Any]) -> int:
    return sum(1 for k, v in own.items()
               if k in loaded and tuple(loaded[k].shape) == tuple(v.shape))


def _extract_model_state(obj: Any, own: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The model's state dict out of what ``torch.load`` read: a state dict,
    the port's trainer state (``{"model", "optimizer", "step", ...}``, or a
    ``{"gen", "disc"}`` pair), or a reference Lightning checkpoint, whose
    ``state_dict`` holds the DiT under ``model.diffusion_model.`` and the VAE
    under ``first_stage_model.`` (the prefix that matches most of the
    model's keys is taken)."""
    if not isinstance(obj, dict):
        raise ValueError(f"a checkpoint holds a dict, not {type(obj).__name__}")
    if "gen" in obj and "disc" in obj:
        return _extract_model_state(obj["gen"], own)
    if isinstance(obj.get("model"), dict) and ("optimizer" in obj or "step" in obj):
        return obj["model"]
    if isinstance(obj.get("state_dict"), dict):
        sd = obj["state_dict"]
        cands = [{k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
                 for p in _LIGHTNING_PREFIXES]
        return max(cands, key=lambda c: _matches(own, c))
    return obj


def _read_model_state(path: str, model: nn.Module) -> Dict[str, Any]:
    """The weights at ``path`` under ``model``'s state-dict keys (not yet merged)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?): the port does not read orbax. "
            f"Export its params with versband_tpu.utils.checkpoint.save_npz_params(out.npz, "
            f"params) and pass the .npz")
    if path.endswith(".npz"):
        from versband_tpu_torch.utils.convert import state_dict_from_jax

        family = _FAMILIES.get(type(model).__name__)
        if family is None:
            raise ValueError(f"no JAX param layout is known for {type(model).__name__}")
        return state_dict_from_jax(_extract_jax_params(load_npz_params(path)), family)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return _extract_model_state(obj, model.state_dict())


def load_model_checkpoint(model: nn.Module, path: str, ignore_keys: Sequence[str] = (),
                          only_model_key: Optional[str] = None) -> nn.Module:
    """Partial restore of ``model`` from ``path`` (port of JAX
    ``train/checkpoints.py:171-194``, ``ddpm.py:184-200`` semantics): keys
    under an ``ignore_keys`` prefix are dropped, ``only_model_key`` keeps one
    top-level sub-module, and a weight whose shape differs from the model's
    keeps the model's (printed). Keys the checkpoint lacks keep the model's
    too. A checkpoint of which no weight matches raises, rather than
    leaving the model as it was. An ``.npz`` is read in the JAX layout of
    the model's class (``_FAMILIES``). Returns ``model``."""
    own = model.state_dict()
    loaded = prune_ignored(_read_model_state(path, model), ignore_keys)
    if only_model_key and any(k.split(".", 1)[0] == only_model_key for k in loaded):
        loaded = {k: v for k, v in loaded.items() if k.split(".", 1)[0] == only_model_key}
    keep = {}
    for k, v in own.items():
        if k not in loaded:
            continue
        w = torch.as_tensor(loaded[k])
        if tuple(w.shape) != tuple(v.shape):
            print(f"| shape mismatch at {k}: ckpt {tuple(w.shape)} vs model {tuple(v.shape)}"
                  f" — keeping model init")
            continue
        keep[k] = w
    if not keep:
        raise ValueError(f"no weight of the checkpoint at {path} matches "
                         f"{type(model).__name__} (wrong checkpoint, or a corrupt one)")
    model.load_state_dict(keep, strict=False)
    return model
