"""Weights made from the run's seed, on the device, in a few large draws.

A model's weights are a function of the seed, the model's name and its list
of ``(name, shape)``: the names are sorted, the elements drawn standard
normal from one ``torch.Generator`` in chunks of at most ``CHUNK`` elements,
and each tensor scaled by its kind:

* a matrix, convolution or embedding table: N(0, 1 / fan_in), fan_in being
  the product of every size but the first (for HiFi-GAN this is the rule
  that keeps its waveform following its mel, ``chip_smoke.scaled_conv_weights``);
* a vector named ``*weight`` (a norm's scale): 1 + N(0, 0.1^2); a norm's
  ``running_var``: 1 + |N(0, 0.1^2)|;
* any other vector (a bias, the attention's tanh gate): N(0, 0.1^2).

The program and the reference get the same values: the program copies
them into its modules, and the reference makes them again from the seed.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 26  # elements a draw: 256 MB in float32
Spec = List[Tuple[str, Tuple[int, ...]]]


def substream(seed: int, name: str) -> int:
    """A generator seed for ``name``'s draws under ``seed``."""
    h = 1469598103934665603
    for ch in f"{seed}/{name}".encode():
        h = ((h ^ ch) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def spec_of(module: torch.nn.Module) -> Spec:
    """The sorted ``(name, shape)`` of a module's parameters; a module with
    buffers in its state dict is refused (their values would be drawn too)."""
    params = dict(module.named_parameters())
    extra = set(module.state_dict()) - set(params)
    if extra:
        raise ValueError(f"state-dict entries that are not parameters: {sorted(extra)[:5]}")
    return sorted((k, tuple(v.shape)) for k, v in params.items())


def _scale(name: str, shape: Tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    if len(shape) >= 2:
        return x / math.sqrt(math.prod(shape[1:]))
    if name.endswith("running_var"):
        return 1.0 + 0.1 * x.abs()
    if name.endswith("weight"):
        return 1.0 + 0.1 * x
    return 0.1 * x


def chunks(spec: Spec, seed: int, model: str, device) -> Iterator[Dict[str, torch.Tensor]]:
    """float32 weights of ``spec`` for ``model`` under ``seed``, a draw at a time."""
    g = torch.Generator(device=device).manual_seed(substream(seed, model))
    group: Spec = []
    count = 0
    for name, shape in spec + [("", (CHUNK + 1,))]:
        n = math.prod(shape)
        if group and count + n > CHUNK:
            flat = torch.randn(count, generator=g, device=device, dtype=torch.float32)
            out, offset = {}, 0
            for gname, gshape in group:
                m = math.prod(gshape)
                out[gname] = _scale(gname, gshape, flat[offset:offset + m].view(gshape))
                offset += m
            del flat
            yield out
            group, count = [], 0
        group.append((name, shape))
        count += n


def make(spec: Spec, seed: int, model: str, device) -> Dict[str, torch.Tensor]:
    """float32 weights of ``spec`` for ``model`` under ``seed``."""
    out: Dict[str, torch.Tensor] = {}
    for part in chunks(spec, seed, model, device):
        out.update(part)
    return out


def fill(module: torch.nn.Module, spec: Spec, seed: int, model: str, device) -> None:
    """Copy ``model``'s weights under ``seed`` into ``module``'s parameters,
    each in its own type, a draw at a time."""
    params = dict(module.named_parameters())
    if sorted(params) != [n for n, _ in spec]:
        raise ValueError(f"{model}: the module's parameters are not its spec")
    with torch.no_grad():
        for part in chunks(spec, seed, model, device):
            for k, v in part.items():
                params[k].copy_(v)

