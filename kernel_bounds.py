#!/usr/bin/env python3
"""Least-time bounds on an H100 and launches per vocoder forward of the two
TPU kernels not ported yet, at the default shapes of their generators.

K4 (``versband_tpu/ops/fused_act1d.py::_act_kernel``): BigVGAN's
``Activation1d`` (2x kaiser-sinc up, Snake/SnakeBeta, 2x down) over
``[B, T, C]`` fp32; per output sample and channel 24 multiply-adds (the
closed form in the kernel's docstring) plus 2 Snake evaluations (sin and 4
arithmetic ops each); one read and one write of the tensor.
``BigVGANGenerator`` defaults (``vocoder/bigvgan.py``): 512 initial channels,
rates (5, 4, 4, 4), 3 AMPBlock1 of 3 dilations with 2 activations each per
stage, plus ``activation_post``.

K5 (``versband_tpu/ops/fused_wavenet.py::_layer_kernel``): one ParallelWaveGAN
residual layer per call over ``[B, T, *]`` fp32: the 3-tap dilated gate conv
(R -> 2G), the aux 1x1 (A -> 2G), tanh * sigmoid, the skip (G -> S) and
output (G -> R) 1x1s; reads x, c and the fp32 skip accumulator, writes x' and
skip'. ``ParallelWaveGANGenerator`` defaults (``vocoder/pwg.py``): 30 layers,
R 64, G 64 (gate 128), S 64, A 80; the fused path runs when
``fused_inference=True`` (default False).

Both at one 20 s clip at 24 kHz (B = 1, T_mel 1504, hop 320: 481,280
samples), the serving length of ``chip_smoke.py``, whose ``bound_ms`` (H100
SXM data-sheet peaks: fp32 FMA 67 TFLOP/s, HBM3 3.35 TB/s) turns FLOPs and
bytes into a bound. Arithmetic only: nothing here runs on a card.

Run:  python3 kernel_bounds.py
"""

from __future__ import annotations

from chip_smoke import HOP, T_MEL, bound_ms

B = 1


def k4_calls():
    """(C, T) of every Activation1d call of one BigVGAN forward, in order."""
    ch0, rates, resblocks, dilations = 512, (5, 4, 4, 4), 3, 3
    calls, T = [], T_MEL
    for i, r in enumerate(rates):
        C, T = ch0 // 2 ** (i + 1), T * r
        calls += [(C, T)] * (resblocks * dilations * 2)  # acts1 and acts2 per dilation
    calls.append((C, T))  # activation_post
    return calls


def k4():
    flop_per = 2 * 24 + 2 * 5  # 24 MACs + 2 Snake evaluations per output sample-channel
    per = [(flop_per * B * C * T, 2 * 4 * B * C * T) for C, T in k4_calls()]
    total = bound_ms(sum(f for f, _ in per), sum(b for _, b in per))
    largest = bound_ms(*max(per, key=lambda fb: fb[1]))
    return len(per), largest, total


def k5():
    R, G, S, A, layers = 64, 64, 64, 80, 30
    T = T_MEL * HOP
    macs = 2 * G * (3 * R + A) + (S + R) * G  # gate conv + aux, then skip + out 1x1s
    flops = (2 * macs + 2 * G) * B * T  # + tanh and sigmoid per gate unit
    nbytes = 4 * B * T * (R + A + 2 * S + R)  # x, c, skip read; x', skip' written
    return layers, bound_ms(flops, nbytes), bound_ms(layers * flops, layers * nbytes)


def main() -> None:
    n, (l_ms, l_by), (t_ms, t_by) = k4()
    print(f"K4 _act_kernel: {n} launches per BigVGAN forward (fp32, defaults); largest call "
          f"[1, {T_MEL * HOP}, 32] bound {l_ms:.4f} ms ({l_by}); all {n} calls {t_ms:.4f} ms "
          f"({t_by})")
    n, (l_ms, l_by), (t_ms, t_by) = k5()
    print(f"K5 _layer_kernel: {n} launches per PWG forward with fused_inference=True "
          f"(0 by default); per layer at T {T_MEL * HOP} bound {l_ms:.4f} ms ({l_by}); all {n} "
          f"layers {t_ms:.4f} ms ({t_by})")


if __name__ == "__main__":
    main()
