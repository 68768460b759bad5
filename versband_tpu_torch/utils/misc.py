"""Small cross-cutting utilities (port of ``versband_tpu/utils/misc.py``,
after the reference's ``ldm/util.py``): ``count_params`` and ``checkpoint``,
the gradient-checkpointing helper (``torch.utils.checkpoint.checkpoint``).

Left out: ``download_checkpoint`` (it only downloads, and nothing calls it)
and ``log_txt_as_img`` (it needs matplotlib, and nothing calls it)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint  # noqa: F401 (the re-export)


def _leaves(tree: Any):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def count_params(params: Any, verbose: bool = False) -> int:
    """The number of elements of a module's parameters, or of the arrays of
    a state_dict or a nested dict (``ldm/util.py:97-101``)."""
    total = sum(int(np.prod(tuple(x.shape))) for x in _leaves(params))
    if verbose:
        print(f"{total * 1e-6:.2f} M params.")
    return total
