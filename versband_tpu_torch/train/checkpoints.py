"""Training checkpoints: monitored top-k, ``last`` and step archives (port of
``versband_tpu/train/checkpoints.py::CheckpointManager``).

Checkpoints are written with ``torch.save`` as one file per name under
``<ckpt_dir>``: the state's ``state_dict()`` (module weights, optimizer,
counters, EMA). The JAX package's orbax checkpoints are not read here.
``last_step.json`` beside ``last`` carries the step and run-level scalars
that live outside the train state, such as the ``scale_by_std`` latent scale
factor, so a resume or an inference run decodes at the trained scale.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch


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
