"""Share of its roofline that BigVGAN's alias-free activations reach: the
bound of a request's activations (``k4_bound_ms``, from the program's
counter ``vocoder.bigvgan.act_samples`` through
``benchmark/lib/bigvgan.py::act_bound_ms``: HBM bytes, one read and one
write a sample) over the device time of the program's span
``vocoder.bigvgan.act``, whatever implements the activation (K4 or the
unfused modules). Without that span or counter in the trace it reads
nothing."""


def read(t):
    s = t.get("program", {}).get("vocoder.bigvgan.act")
    if not s or s["busy_s"] <= 0 or not t.get("k4_bound_ms") or not t.get("requests"):
        return None
    return 100.0 * t["k4_bound_ms"] * t["requests"] / 1e3 / s["busy_s"]
