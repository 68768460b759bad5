"""The comparison that decides ``correct``: each number beside its limit."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float64 on the host; inf where ``got``
    is not finite or the shapes differ."""
    g = torch.as_tensor(np.asarray(got) if not torch.is_tensor(got) else got)
    w = torch.as_tensor(np.asarray(want) if not torch.is_tensor(want) else want)
    g, w = g.detach().double().cpu(), w.detach().double().cpu()
    if g.shape != w.shape or not torch.isfinite(g).all():
        return float("inf")
    return float((g - w).norm() / w.norm().clamp_min(1e-300))


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """Whether every number is within its limit, and one line per number.
    A number without a limit fails."""
    lines, ok = [], True
    for name, value in checks.items():
        limit = limits.get(name)
        good = limit is not None and value <= limit
        ok &= good
        lines.append(f"check {name} {value!r} limit {limit!r} {'ok' if good else 'FAILED'}")
    return ok, lines
