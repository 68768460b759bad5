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

Around a module cut by ``parallel.sharding.shard_module_`` (tensor and
expert parallelism) AdamW and the EMA act on this rank's slices; the
gradients are averaged over the data group only, and the clip takes the
true global norm (the squares of the cut parameters summed over the model
group, each replicated one counted once), as ``optax.clip_by_global_norm``
sees the whole arrays. ``state_dict()`` is then whole, under the one-process
keys (every rank of the model group gathers), and ``load_state_dict`` takes
this rank's slices of a whole state, so a checkpoint resumes at any layout.

``make_radam`` configures ParallelWaveGAN's RAdam as the JAX
``make_radam`` chains it: L2 decay added to the gradient before
``optax.radam``'s update (:class:`RAdamOptimizer`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from versband_tpu_torch import parallel
from versband_tpu_torch.parallel import active as parallel_active, all_reduce_grads
from versband_tpu_torch.parallel.sharding import gather, gather_state_dict, load_whole_, local_part

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

    def make_optimizer(self, params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=self.lr_at(0), betas=self.betas, eps=self.eps,
                                 weight_decay=self.weight_decay)


@dataclasses.dataclass(frozen=True)
class RAdam(AdamW):
    """What ``make_radam`` configures: RAdam with L2 decay before it (no
    clipping, no accumulation)."""

    def make_optimizer(self, params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return RAdamOptimizer(params, lr=self.lr_at(0), betas=self.betas, eps=self.eps,
                              weight_decay=self.weight_decay)


def _pow_f32(b: float, t: int) -> np.float32:
    """``b ** t`` in float32 by binary exponentiation (how XLA raises a float
    to an integer power, rounding after every product)."""
    r, x = np.float32(1), np.float32(b)
    while t:
        if t & 1:
            r = np.float32(r * x)
        x = np.float32(x * x)
        t >>= 1
    return r


class RAdamOptimizer(torch.optim.Optimizer):
    """``optax.chain(add_decayed_weights(wd), radam(lr, b1, b2, eps))``.

    With ``g' = g + wd p``, ``m = b1 m + (1 - b1) g'``, ``v = b2 v + (1 - b2)
    g'^2`` and at step t ``rho_t = rho_inf - 2 t b2^t / (1 - b2^t)``: the
    update is ``r_t m_hat / (sqrt(v_hat) + eps)`` where ``rho_t >= 5``, else
    ``m_hat`` alone (``optax.scale_by_radam``; torch's ``RAdam`` places eps
    and the threshold otherwise). The step's scalars (``rho_t``, ``r_t``,
    the bias corrections) are computed in float32 as optax computes them,
    ``b^t`` by squaring: ``1 - b2^t`` cancels, and at t = 6, where the
    rectification starts, an ulp of ``b2^t`` moves ``r_t`` by 0.6%."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, threshold=threshold))

    @staticmethod
    def scalars(t: int, b1: float, b2: float) -> tuple:
        """(rectified, r_t, 1 - b1^t, 1 - b2^t) in float32."""
        f = np.float32
        b1t, b2t = _pow_f32(b1, t), _pow_f32(b2, t)
        ro_inf = f(2.0 / (1.0 - b2) - 1.0)
        ro = ro_inf - f(2 * t) * b2t / (f(1) - b2t)
        with np.errstate(invalid="ignore"):  # rho_t < 4 before the switch: r unused
            r = np.sqrt((ro - f(4)) * (ro - f(2)) * ro_inf
                        / (f((2.0 / (1.0 - b2) - 5.0) * (2.0 / (1.0 - b2) - 3.0)) * ro))
        return ro, f(r), f(1) - b1t, f(1) - b2t

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st["mu"].mul_(b1).add_(g, alpha=1 - b1)
                st["nu"].mul_(b2).add_(g * g, alpha=1 - b2)
                ro, r, c1, c2 = self.scalars(st["step"], b1, b2)
                m_hat = st["mu"] / float(c1)
                if ro >= group["threshold"]:
                    upd = float(r) * m_hat / (torch.sqrt(st["nu"] / float(c2)) + group["eps"])
                else:
                    upd = m_hat
                p.sub_(group["lr"] * upd)
        return None


def make_adamw(learning_rate: LearningRate, betas=(0.9, 0.999), weight_decay: float = 0.0,
               eps: float = 1e-8, grad_clip: Optional[float] = None,
               accumulate_grad_batches: int = 1) -> AdamW:
    """AdamW + optional global-norm clipping (the reference: ``torch.optim.AdamW``
    with Lightning ``gradient_clip_val`` 1.0), with Lightning's gradient
    accumulation as ``optax.MultiSteps`` defines it."""
    return AdamW(learning_rate, tuple(betas), weight_decay, eps, grad_clip,
                 max(1, int(accumulate_grad_batches)))


def make_adam(learning_rate: LearningRate, betas=(0.5, 0.9), eps: float = 1e-8,
              accumulate_grad_batches: int = 1) -> AdamW:
    """Adam with the GAN betas (0.5, 0.9) for stage 1's VAE/discriminator
    pair (JAX ``make_adam``: ``optax.adam``, no clipping, no decay, with
    ``optax.MultiSteps`` accumulation). It runs as ``torch.optim.AdamW`` with
    ``weight_decay=0``, which is ``torch.optim.Adam``'s update and optax's,
    ``m_hat / (sqrt(v_hat) + eps)``."""
    return AdamW(learning_rate, tuple(betas), 0.0, eps, None,
                 max(1, int(accumulate_grad_batches)))


def make_radam(learning_rate: LearningRate, betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0) -> RAdam:
    """RAdam, the ParallelWaveGAN trainer's optimizer
    (``vocoder/parallel_wavegan/optimizers/radam.py``), with classic L2
    decay: the decay term is added to the gradient before the adaptive
    update, as the JAX ``make_radam`` chains it."""
    return RAdam(learning_rate, tuple(betas), weight_decay, eps)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class TrainState:
    """Single-optimizer train state of a module whose trainable parameters
    (``requires_grad``) the optimizer updates in place. Under a process group
    the ``.grad`` it consumes is the global batch's (:meth:`reduce_gradients`),
    so every rank applies the same update. A module cut by
    ``parallel.sharding.shard_module_`` is cut before the state is made.

    ``step`` counts micro-steps; ``updates`` counts applied optimizer updates.
    """

    def __init__(self, model: nn.Module, tx: AdamW, ema_decay: Optional[float] = None):
        self.model = model
        self.tx = tx
        self.named = {k: p for k, p in model.named_parameters() if p.requires_grad}
        self.params = list(self.named.values())
        self.optimizer = tx.make_optimizer(self.params)
        self.step = 0
        self.updates = 0
        self.mini_step = 0
        self.acc_grads: Optional[List[torch.Tensor]] = None
        self.ema = EmaState(self.named, ema_decay) if ema_decay is not None else None
        self.layout = getattr(model, "tp_layout", None)  # set by shard_module_

    @property
    def data_group(self):
        """The group a gradient is averaged over (None: the whole group)."""
        return None if self.layout is None else self.layout.mesh.data_group

    @property
    def _model_split(self) -> bool:
        return self.layout is not None and self.layout.mesh.n_model > 1

    def reduce_gradients(self) -> None:
        """Average ``.grad`` over the ranks of the data group (nothing
        without a process group); the train steps call it once per
        micro-step, after the backward and before :meth:`apply_gradients`. A
        parameter without a gradient reduces :meth:`grads`'s zeros, so every
        rank reduces the same buffer."""
        if not parallel_active():
            return
        for p, g in zip(self.params, self.grads()):
            p.grad = g
        all_reduce_grads(self.params, self.data_group)

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads`` (one per trainable parameter) over
        the whole model: under a cut module, the cut parameters' squares
        summed over the model group and each replicated one counted once."""
        if not self._model_split:
            return global_norm(grads)
        zero = grads[0].new_zeros((), dtype=torch.float32)
        squares = [(self.layout.sharded(k), g.float().pow(2).sum())
                   for k, g in zip(self.named, grads)]
        cut = sum((sq for split, sq in squares if split), zero)
        kept = sum((sq for split, sq in squares if not split), zero)
        parallel.sum_([cut], self.layout.mesh.model_group)
        return torch.sqrt(cut + kept)

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
            norm = self.grad_norm(grads)
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
        sd = {"step": self.step, "updates": self.updates, "mini_step": self.mini_step,
              "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
              "acc_grads": self.acc_grads,
              "ema": None if self.ema is None else self.ema.state_dict()}
        return sd if self.layout is None else self._whole(sd)

    def load_state_dict(self, sd: dict) -> None:
        if self.layout is not None:
            sd = self._local(sd)
            load_whole_(self.model, sd.pop("model"))
        else:
            self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step, self.updates = int(sd["step"]), int(sd["updates"])
        self.mini_step = int(sd["mini_step"])
        self.acc_grads = None if sd["acc_grads"] is None else [
            a.to(p.device) for a, p in zip(sd["acc_grads"], self.params)]
        if self.ema is not None and sd.get("ema") is not None:
            self.ema.load_state_dict(sd["ema"])

    # --- whole <-> this rank's slices, under a cut module ---------------------
    def _whole_names(self) -> List[str]:
        return [k for k, trains in self.layout.params if trains]

    def _gather(self, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors for every trainable one-process name from this
        rank's ``local`` ones (collective over the model group)."""
        return gather(self.layout, {k: local.get(k) for k in self._whole_names()})

    def _whole(self, sd: dict) -> dict:
        """The one-process form of this rank's state dict ``sd``."""
        names, whole_names = list(self.named), self._whole_names()
        sd["model"] = gather_state_dict(self.model)
        opt = sd["optimizer"]
        if len(opt["param_groups"]) != 1:
            raise ValueError("a cut module's state takes one parameter group")
        state = {}
        if opt["state"]:
            first = opt["state"][0]
            per_param = [key for key, v in first.items()
                         if torch.is_tensor(v) and v.shape == self.params[0].shape]
            whole = {key: self._gather({k: opt["state"][i][key] for i, k in enumerate(names)})
                     for key in per_param}
            scalars = {key: v for key, v in first.items() if key not in per_param}
            state = {j: {**scalars, **{key: whole[key][k] for key in per_param}}
                     for j, k in enumerate(whole_names)}
        sd["optimizer"] = {"state": state, "param_groups": [
            {**opt["param_groups"][0], "params": list(range(len(whole_names)))}]}
        if self.acc_grads is not None:
            got = self._gather(dict(zip(names, self.acc_grads)))
            sd["acc_grads"] = [got[k] for k in whole_names]
        if self.ema is not None:
            sd["ema"] = {**sd["ema"], "shadow": self._gather(self.ema.shadow)}
        return sd

    def _local(self, sd: dict) -> dict:
        """This rank's part of the one-process state dict ``sd``."""
        names, whole_names = list(self.named), self._whole_names()
        at = {k: j for j, k in enumerate(whole_names)}
        shapes = {k: tuple(self.layout.whole[k]) for k in whole_names}
        opt = sd["optimizer"]

        def part(k, v):
            if torch.is_tensor(v) and tuple(v.shape) == shapes[k]:
                return local_part(self.layout, k, v)
            return v

        state = {i: {key: part(k, v) for key, v in opt["state"][at[k]].items()}
                 for i, k in enumerate(names) if at[k] in opt["state"]}
        out = {**sd, "optimizer": {"state": state, "param_groups": [
            {**opt["param_groups"][0], "params": list(range(len(names)))}]}}
        if sd["acc_grads"] is not None:
            out["acc_grads"] = [local_part(self.layout, k, sd["acc_grads"][at[k]])
                                for k in names]
        if sd.get("ema") is not None:
            out["ema"] = {**sd["ema"], "shadow": {
                k: local_part(self.layout, k, sd["ema"]["shadow"][k]) for k in names}}
        return out


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
