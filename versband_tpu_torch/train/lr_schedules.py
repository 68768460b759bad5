"""LR schedules of the reference's ``ldm/lr_scheduler.py`` (port of
``versband_tpu/train/lr_schedules.py``).

Each scheduler is a callable ``step -> multiplier`` on top of the base LR.
:class:`LambdaWarmUpCosineScheduler` and :class:`LambdaLinearScheduler`
compute in float32 as XLA compiles the JAX versions inside the jitted train
step: a Python float meets a float32 step and is rounded to float32 first, a
division by a constant becomes a product with its float32 reciprocal (or
with the folded constant ``c / cl``), and ``a * x + b`` is one rounding
(``_fma``). So the shipped config's 1e13-step cycle gives exactly 1.0 after
warm-up, as there.
:class:`LambdaWarmUpCosineScheduler2` is host arithmetic in float64, as there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

f32 = np.float32


def _fma(a, x, b) -> np.float32:
    """float32 a * x + b with one rounding (the product of two float32 values
    is exact in float64)."""
    return f32(float(f32(a)) * float(f32(x)) + float(f32(b)))


class LambdaWarmUpCosineScheduler:
    """Warm-up to lr_max, then cosine to lr_min over max_decay_steps."""

    def __init__(self, warm_up_steps, lr_min, lr_max, lr_start, max_decay_steps,
                 verbosity_interval: int = 0):
        self.warm_up_steps = int(warm_up_steps)
        self.lr_min = float(lr_min)
        self.lr_max = float(lr_max)
        self.lr_start = float(lr_start)
        self.max_decay_steps = int(max_decay_steps)

    def __call__(self, step) -> float:
        step = f32(step)
        warm = _fma((self.lr_max - self.lr_start) / max(self.warm_up_steps, 1), step,
                    self.lr_start)
        span = f32(max(self.max_decay_steps - self.warm_up_steps, 1))
        t = min((step - f32(self.warm_up_steps)) * (f32(1) / span), f32(1.0))
        cos = _fma(np.cos(t * f32(np.pi)) + f32(1), 0.5 * (self.lr_max - self.lr_min),
                   self.lr_min)
        return float(warm if step < self.warm_up_steps else cos)


class LambdaWarmUpCosineScheduler2:
    """Cyclic warm-up cosine over ``cycle_lengths``; past the last cycle the
    last cycle's parameters hold."""

    def __init__(self, warm_up_steps: Sequence[int], f_min, f_max, f_start,
                 cycle_lengths: Sequence[int], verbosity_interval: int = 0):
        def as_list(v):
            return [float(x) for x in (v if isinstance(v, (list, tuple)) else [v])]

        self.warm_up_steps = [int(w) for w in warm_up_steps]
        self.f_min, self.f_max, self.f_start = as_list(f_min), as_list(f_max), as_list(f_start)
        self.cycle_lengths = [int(c) for c in cycle_lengths]
        self.cum_cycles = np.concatenate([[0], np.cumsum(self.cycle_lengths)])

    def find_cycle(self, step: float) -> int:
        for i, cum in enumerate(self.cum_cycles[1:]):
            if step < cum:
                return i
        return len(self.cycle_lengths) - 1

    def __call__(self, step) -> float:
        s = float(step)
        c = self.find_cycle(s)
        s = s - self.cum_cycles[c]
        if s < self.warm_up_steps[c]:
            return (self.f_max[c] - self.f_start[c]) / self.warm_up_steps[c] * s \
                + self.f_start[c]
        t = min((s - self.warm_up_steps[c]) / (self.cycle_lengths[c] - self.warm_up_steps[c]),
                1.0)
        return float(self.f_min[c] + 0.5 * (self.f_max[c] - self.f_min[c])
                     * (1 + np.cos(t * np.pi)))


class LambdaLinearScheduler(LambdaWarmUpCosineScheduler2):
    """Linear warm-up, then linear decay over the first cycle (the shipped
    config has one cycle of 1e13 steps)."""

    def __call__(self, step) -> float:
        step = f32(step)
        w = max(self.warm_up_steps[0], 1)
        cl = f32(float(self.cycle_lengths[0]))
        warm = _fma((self.f_max[0] - self.f_start[0]) / w, step, self.f_start[0])
        decay = _fma(cl - step, f32(self.f_max[0] - self.f_min[0]) / cl, self.f_min[0])
        return float(warm if step < w else decay)


def scale_base_lr(base_lr: float, batch_size: int, num_devices: int,
                  accumulate_grad_batches: int = 1, scale: bool = True) -> float:
    """The reference's LR scaling rule ``lr = accum * ngpu * bs * base_lr``."""
    if not scale:
        return float(base_lr)
    return float(accumulate_grad_batches * num_devices * batch_size * base_lr)
