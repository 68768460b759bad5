"""PyTorch/CUDA port of ``versband_tpu`` for NVIDIA Hopper (H100).

The JAX package ``versband_tpu`` is the reference; this package holds its own
copies of everything it needs and never imports it. The slice ported so far is
the 20 s accompaniment serving path: Band-MoE DiT inside the CFG Euler
sampler, VAE decode and HiFi-GAN, with the flash-attention forward as a CUDA
kernel written for ``sm_90a`` (``ops/csrc/flash_attn_fwd.cu``).

Entry points build their models on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""

from versband_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
