"""Share of its roofline that the DiT's self-attention reaches in training:
the forward and backward bound of every call from its shapes
(``benchmark/lib/arith.py``: ``k1_bound_ms`` and ``bwd_bound_ms``, summed
over a step's calls) over the device time of the kernels that ran it (K1-K3,
``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``). Without such kernels in
the trace it reads nothing."""

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def read(t):
    seconds = sum(o["seconds"] for name, o in t["ops"].items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0 or not t.get("steps"):
        return None
    return 100.0 * t["attn_bound_ms"] * t["steps"] / 1e3 / seconds
