"""Device-busy milliseconds a request's sampler work takes: the union of the
intervals of the device operations launched inside the sampler span."""


def read(t):
    s = t["spans"].get("models.cfm.sampler")
    return s["busy_s"] * 1e3 / t["requests"] if s and s["busy_s"] > 0 else None
