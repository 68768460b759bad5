"""Share of its roofline that the DiT's self-attention reaches: the bound of
every call from its shapes (``benchmark/lib/arith.py::k1_bound_ms``, summed
over the calls a request makes) over the device time of the kernels that ran
it (K1, ``flash_fwd``). The work counted is the same whatever implements the
attention; without such kernels in the trace it reads nothing."""

KERNEL = "flash_fwd"


def read(t):
    seconds = sum(o["seconds"] for name, o in t["ops"].items() if KERNEL in name)
    if seconds <= 0:
        return None
    return 100.0 * t["k1_bound_ms"] * t["requests"] / 1e3 / seconds
