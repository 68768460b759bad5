"""BigVGAN's work from the configuration's shapes: the model FLOPs of the
generator and the bound of its alias-free activations (K4).

``generator_flops`` counts what model FLOP utilisation counts
(``benchmark/lib/flops.py``): 2 per multiply-add of every convolution and
transposed convolution of the generator (``conv_pre``, each stage's
upsampler, the AMP blocks' two convolutions per dilation, ``conv_post``);
the activations' resampling taps and Snake are elementwise work and left
out, as HiFi-GAN's leaky ReLU is. At the published widths over a 20 s take
(T_mel 1504, hop 320) that is 3.3868 TFLOP.

``act_bound_ms`` is a frozen copy of ``chip_smoke.py::k4_bound_ms``, taking
a count of samples instead of a tensor, so that a change to the program
cannot move the yardstick: per input sample of an activation, 24
multiply-adds of the two 12-tap FIRs and 2 Snake evaluations (sin and 4
operations each), x read once and the output written once. HBM bounds it.
``activation_samples`` is what the program's counter
``vocoder.bigvgan.act_samples`` should count for one call: B x C x T of
every activation's input (109 activations a take at the published widths,
1,155,072,000 samples, 9.24 GB in float32: 2.758 ms).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from benchmark.lib import arith
from benchmark.lib.flops import conv1d


def _stages(cfg: Dict[str, Any], t_mel: int):
    """(input channels, output channels, rate, kernel, output samples) of
    each upsampling stage."""
    ch, t = cfg["upsample_initial_channel"], t_mel
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        out = cfg["upsample_initial_channel"] // 2 ** (i + 1)
        yield ch, out, u, k, t * u
        ch, t = out, t * u


def generator_flops(cfg: Dict[str, Any], batch: int, t_mel: int) -> float:
    """The generator on ``batch`` mels of ``t_mel`` frames."""
    f = conv1d(batch, t_mel, cfg["num_mels"], cfg["upsample_initial_channel"], 7)
    for c_in, ch, u, k, t in _stages(cfg, t_mel):
        f += conv1d(batch, t // u, c_in, ch, k)  # transposed: 2 x c_in x c_out x k per input
        for rk, rd in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            f += 2 * len(rd) * conv1d(batch, t, ch, ch, rk)
    return f + conv1d(batch, t, ch, 1, 7)


def activation_samples(cfg: Dict[str, Any], batch: int, t_mel: int) -> int:
    """B x C x T summed over every activation of one call: two a dilation
    of each AMP block, and the one before ``conv_post``."""
    n = ch = t = 0
    for _, ch, _, _, t in _stages(cfg, t_mel):
        n += sum(2 * len(rd) for rd in cfg["resblock_dilation_sizes"]) * ch * t
    return batch * (n + ch * t)


def act_bound_ms(samples: float, dtype: str = "float32") -> Tuple[float, str]:
    """The least time of activations over ``samples`` input samples in all,
    and what bounds it."""
    return arith.bound_ms((2 * 24 + 2 * 5) * samples,
                          2 * samples * arith.ELEMENT_BYTES[dtype], dtype)
