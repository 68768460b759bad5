"""Share of its roofline that Parallel WaveGAN's residual layers reach: the
bound of a request's layers from their shapes
(``benchmark/lib/wavenet.py::request_bound_ms``, 30 layers a take) over the
device time of the program's span ``vocoder.pwg.wavenet`` (the skip
accumulator, the layers and its cast back), whatever implements the
layers (K5 or the dense path). Without that span in the trace it reads
nothing."""


def read(t):
    s = t.get("program", {}).get("vocoder.pwg.wavenet")
    if not s or s["busy_s"] <= 0 or not t.get("k5_bound_ms") or not t.get("requests"):
        return None
    return 100.0 * t["k5_bound_ms"] * t["requests"] / 1e3 / s["busy_s"]
