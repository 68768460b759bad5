"""Train state: the module's parameters, AdamW with global-norm clipping and
gradient accumulation, a step counter and an EMA shadow (port of
``versband_tpu/train/state.py``).

The parameters live in the ``nn.Module`` and are updated in place;
``TrainState`` holds the optimizer around them. The optimizer reproduces the
JAX chain ``optax.MultiSteps(chain(clip_by_global_norm, adamw))``:

* with ``accumulate_grad_batches = k > 1`` each micro-step's gradient goes
  into a running mean (``acc + (g - acc) / (n + 1)``), the parameters stay as
  they are, and every k-th micro-step applies the mean;
* the applied gradient is clipped by its global norm as optax does (scaled
  by ``max_norm / norm`` when ``norm >= max_norm``);
* AdamW is ``torch.optim.AdamW`` (the same update as ``optax.adamw``; weight
  decay 0 by default, as the JAX ``make_adamw``), its LR set before every
  applied update from the schedule at the count of earlier updates, as the
  optax schedule sees its count.

The EMA shadow ticks once per applied update with the decay
``min(decay, (1 + n) / (10 + n))`` (LitEma's warm-up), not per micro-step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

LearningRate = Union[float, Callable[[int], float]]


class EmaState:
    """EMA shadow of named parameters with update counting."""

    def __init__(self, named_params: Dict[str, torch.Tensor], decay: float = 0.9999,
                 use_num_updates: bool = True):
        self.decay = decay
        self.num_updates = 0 if use_num_updates else -1
        self.shadow = {k: p.detach().clone() for k, p in named_params.items()}

    @torch.no_grad()
    def update(self, named_params: Dict[str, torch.Tensor]) -> None:
        n = self.num_updates + (1 if self.num_updates >= 0 else 0)
        decay = self.decay
        if n >= 0:  # float32, as the JAX update computes it
            decay = min(np.float32(self.decay), (np.float32(1) + n) / (np.float32(10) + n))
        one_minus = float(np.float32(1) - np.float32(decay))
        for k, s in self.shadow.items():
            s.sub_(one_minus * (s - named_params[k].to(s.dtype)))
        self.num_updates = n

    def copy_to(self, named_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The shadow cast to the parameters' types (LitEma ``copy_to``)."""
        return {k: s.to(named_params[k].dtype) for k, s in self.shadow.items()}

    def state_dict(self) -> dict:
        return {"decay": self.decay, "num_updates": self.num_updates, "shadow": self.shadow}

    def load_state_dict(self, sd: dict) -> None:
        self.decay, self.num_updates = sd["decay"], int(sd["num_updates"])
        for k, s in self.shadow.items():
            s.copy_(sd["shadow"][k])


@dataclasses.dataclass(frozen=True)
class AdamW:
    """What ``make_adamw`` configures: AdamW, clipping and accumulation."""

    learning_rate: LearningRate
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 0.0
    eps: float = 1e-8
    grad_clip: Optional[float] = None
    accumulate_grad_batches: int = 1

    def lr_at(self, count: int) -> float:
        """The LR of the update that follows ``count`` applied updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)


def make_adamw(learning_rate: LearningRate, betas=(0.9, 0.999), weight_decay: float = 0.0,
               eps: float = 1e-8, grad_clip: Optional[float] = None,
               accumulate_grad_batches: int = 1) -> AdamW:
    """AdamW + optional global-norm clipping (the reference: ``torch.optim.AdamW``
    with Lightning ``gradient_clip_val`` 1.0), with Lightning's gradient
    accumulation as ``optax.MultiSteps`` defines it."""
    return AdamW(learning_rate, tuple(betas), weight_decay, eps, grad_clip,
                 max(1, int(accumulate_grad_batches)))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class TrainState:
    """Single-optimizer train state of a module whose trainable parameters
    (``requires_grad``) the optimizer updates in place.

    ``step`` counts micro-steps; ``updates`` counts applied optimizer updates.
    """

    def __init__(self, model: nn.Module, tx: AdamW, ema_decay: Optional[float] = None):
        self.model = model
        self.tx = tx
        self.named = {k: p for k, p in model.named_parameters() if p.requires_grad}
        self.params = list(self.named.values())
        self.optimizer = torch.optim.AdamW(self.params, lr=tx.lr_at(0), betas=tx.betas,
                                           eps=tx.eps, weight_decay=tx.weight_decay)
        self.step = 0
        self.updates = 0
        self.mini_step = 0
        self.acc_grads: Optional[List[torch.Tensor]] = None
        self.ema = EmaState(self.named, ema_decay) if ema_decay is not None else None

    def grads(self) -> List[torch.Tensor]:
        """The gradients in ``.grad`` (zeros where a parameter got none)."""
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]

    @torch.no_grad()
    def apply_gradients(self) -> bool:
        """Consume the gradients in ``.grad``: accumulate, and on an applying
        micro-step clip, step AdamW and tick the EMA. Returns whether the
        parameters moved."""
        grads = self.grads()
        k = self.tx.accumulate_grad_batches
        self.step += 1
        if k > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step = (n + 1) % k
            if self.mini_step:
                self.optimizer.zero_grad(set_to_none=True)
                return False
            grads = [acc.clone() for acc in self.acc_grads]
            for acc in self.acc_grads:
                acc.zero_()
        if self.tx.grad_clip is not None:
            norm = global_norm(grads)
            # optax: t / norm * max_norm where norm >= max_norm, else t (no host sync)
            grads = [torch.where(norm < self.tx.grad_clip, g,
                                 g / norm.to(g.dtype) * self.tx.grad_clip) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = self.tx.lr_at(self.updates)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1
        if self.ema is not None:
            self.ema.update(self.named)
        return True

    def state_dict(self) -> dict:
        return {"step": self.step, "updates": self.updates, "mini_step": self.mini_step,
                "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "acc_grads": self.acc_grads,
                "ema": None if self.ema is None else self.ema.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step, self.updates = int(sd["step"]), int(sd["updates"])
        self.mini_step = int(sd["mini_step"])
        self.acc_grads = None if sd["acc_grads"] is None else [
            a.to(p.device) for a, p in zip(sd["acc_grads"], self.params)]
        if self.ema is not None and sd.get("ema") is not None:
            self.ema.load_state_dict(sd["ema"])


@contextlib.contextmanager
def ema_scope(state: TrainState) -> Iterator[nn.Module]:
    """The module with its EMA weights swapped in for evaluation; the trained
    weights are restored on exit (LitEma's store / copy_to / restore)."""
    if state.ema is None:
        yield state.model
        return
    stored = {k: p.detach().clone() for k, p in state.named.items()}
    with torch.no_grad():
        for k, w in state.ema.copy_to(state.named).items():
            state.named[k].copy_(w)
    try:
        yield state.model
    finally:
        with torch.no_grad():
            for k, w in stored.items():
                state.named[k].copy_(w)
