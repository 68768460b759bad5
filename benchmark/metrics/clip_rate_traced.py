"""Clips a second over the traced slice of a serving cell: the slice's
requests times their takes, over its wall time with the profiler on. It
stands in for ``clips_per_s`` where the host's drift leaves that rate
too wide for any bound."""


def read(t):
    n, w = t.get("requests"), t.get("window_s", 0.0)
    return n * t["takes"] / w if n and w > 0 and "takes" in t else None
