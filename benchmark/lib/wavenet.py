"""Parallel WaveGAN's work from the configuration's shapes: the bound of one
fused residual layer (K5) and the model FLOPs of the generator.

``layer_bound_ms`` is a frozen copy of ``chip_smoke.py::k5_bound_ms``,
taking shapes instead of tensors, so that a change to the program cannot
move the yardstick. Per sample of a layer it counts the products, 2 x (3R x
2G + A x 2G + G x S + G x R) FLOPs (the dilated gate conv, the aux 1x1, the
skip and out 1x1s), and the 2G of tanh and sigmoid; bytes: x, c and skip
read once, x' and skip' written once, skip in float32. At the published
widths over a 20 s take (``[1, 64, 481280]``, A 80, G 64, S 64) that is
0.2513 ms, bound by operations at the fp32 product's 165 TFLOP/s.

``generator_flops`` counts what model FLOP utilisation counts
(``benchmark/lib/flops.py``): 2 per multiply-add of every convolution of
the generator, elementwise work left out.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from benchmark.lib import arith
from benchmark.lib.flops import conv1d


def layer_bound_ms(batch: int, samples: int, residual: int, gate: int, skip: int, aux: int,
                   dtype: str = "float32") -> Tuple[float, str]:
    """One residual layer over ``[batch, residual, samples]``: its least time
    and what bounds it. ``gate`` is G, half the gate conv's outputs."""
    per_sample = 2 * (2 * gate * (3 * residual + aux) + (skip + residual) * gate) + 2 * gate
    nbytes = (2 * residual + aux) * arith.ELEMENT_BYTES[dtype] + 2 * skip * 4
    return arith.bound_ms(per_sample * batch * samples, nbytes * batch * samples, dtype,
                          products=True)


def request_bound_ms(cfg: Dict[str, Any], takes: int, t_mel: int,
                     dtype: str = "float32") -> float:
    """The bound of every residual layer of a request of ``takes`` takes of
    ``t_mel`` frames, each take vocoded in its own call."""
    samples = t_mel * math.prod(cfg["upsample_scales"])
    per_layer, _ = layer_bound_ms(1, samples, cfg["residual_channels"],
                                  cfg["gate_channels"] // 2, cfg["skip_channels"],
                                  cfg["aux_channels"], dtype)
    return per_layer * cfg["layers"] * takes


def generator_flops(cfg: Dict[str, Any], batch: int, t_mel: int) -> float:
    """The generator on ``batch`` mels of ``t_mel`` frames: the context conv,
    each upsampling scale's ``(1, 2s + 1)`` conv over every mel channel, the
    first 1x1, the residual layers and the two output 1x1s."""
    A, R = cfg["aux_channels"], cfg["residual_channels"]
    G2, S = cfg["gate_channels"], cfg["skip_channels"]
    k, w = cfg["kernel_size"], cfg["aux_context_window"]
    t = t_mel
    f = conv1d(batch, t, A, A, 2 * w + 1)
    for s in cfg["upsample_scales"]:
        t *= s
        f += conv1d(batch * A, t, 1, 1, 2 * s + 1)
    f += conv1d(batch, t, 1, R, 1)
    f += cfg["layers"] * (conv1d(batch, t, R, G2, k) + conv1d(batch, t, A, G2, 1)
                          + conv1d(batch, t, G2 // 2, S + R, 1))
    return f + conv1d(batch, t, S, S, 1) + conv1d(batch, t, S, 1, 1)
