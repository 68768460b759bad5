"""Weights carried across, and the port's independence from JAX.

* Round trip: the port's state_dict -> the JAX package's converter ->
  ``state_dict_from_jax`` gives back the same keys and bit-identical values,
  for every family of the port (DiT, VAE, HiFi-GAN, BigVGAN, PWG).
* No file of ``versband_tpu_torch/`` and not ``chip_smoke.py`` imports
  ``jax``, ``flax`` or ``versband_tpu``, nor a package the card's machine
  lacks (``yaml``, ``pandas``, ``transformers``, ``tokenizers``,
  ``safetensors``).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from versband_tpu_torch.models.autoencoder import AutoencoderKL
from versband_tpu_torch.models.dit import BandMoeDiT
from versband_tpu_torch.utils.convert import state_dict_from_jax
from versband_tpu_torch.vocoder.bigvgan import BigVGANGenerator
from versband_tpu_torch.vocoder.hifigan import HifiGanGenerator
from versband_tpu_torch.vocoder.pwg import ParallelWaveGANGenerator
from torch_port_helpers import (BIGVGAN_TINY, DIT_TINY, PWG_TINY, VAE_TINY, VOC_TINY,
                                randomize_, to_jax)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "versband_tpu", "yaml", "pandas", "transformers", "tokenizers",
             "safetensors"}


@pytest.mark.parametrize("family,build,kw", [
    ("dit", lambda: BandMoeDiT(**{**DIT_TINY, "depth": 2, "num_experts": 4}), {}),
    ("vae", lambda: AutoencoderKL(**VAE_TINY), {}),
    ("hifigan", lambda: HifiGanGenerator(**{**VOC_TINY, "resblock_kernel_sizes": (3, 7, 11),
                                            "resblock_dilation_sizes": ((1, 3, 5),) * 3}),
     {"num_resblock_kernels": 3}),
    ("bigvgan", lambda: randomize_(BigVGANGenerator(**BIGVGAN_TINY), 1),
     {"num_resblock_kernels": 2}),
    ("pwg", lambda: ParallelWaveGANGenerator(**PWG_TINY), {}),
])
def test_state_dict_round_trip(family, build, kw):
    torch.manual_seed(0)
    module = build()
    sd = module.state_dict()
    back = state_dict_from_jax(to_jax(module, family, **kw), family)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    module.load_state_dict(back)  # strict


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="family"):
        state_dict_from_jax({}, "clap")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "versband_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    bad = {f"{f.relative_to(REPO)}: {root}" for f in files for root in _imported_roots(f)
           if root in FORBIDDEN}
    assert not bad, sorted(bad)
    # the check matches whole names: the port's own package is not caught
    assert "versband_tpu_torch" in set(_imported_roots(REPO / "chip_smoke.py"))
