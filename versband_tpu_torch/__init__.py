"""PyTorch/CUDA port of ``versband_tpu`` for NVIDIA Hopper (H100).

The JAX package ``versband_tpu`` is the reference; this package holds its own
copies of everything it needs and never imports it. Ported so far: the 20 s
accompaniment serving path (Band-MoE DiT inside the CFG Euler sampler, VAE
decode, then HiFi-GAN, BigVGAN or ParallelWaveGAN through
``cli.generate.build_vocoder``), the CFM training step with its trainer, and
the inference CLI (``python -m versband_tpu_torch.cli.generate``) with its
own YAML reader, checkpoint loading and the frozen T5 caption tower.
Every Pallas kernel of the JAX package is a CUDA kernel written for
``sm_90a`` here (``ops/csrc/``): the flash-attention forward and backward,
BigVGAN's fused alias-free Snake and PWG's fused WaveNet layer.

Entry points build their models on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""

from versband_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
