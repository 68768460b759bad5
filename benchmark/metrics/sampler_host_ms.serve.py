"""Host milliseconds a request spends in the sampler (``models.cfm``
``CFMSampler.sample_cfg`` -> ``euler_cfg_sample`` -> ``models.dit.BandMoeDiT``):
the enqueue cost of the DiT's kernels."""


def read(t):
    s = t["spans"].get("models.cfm.sampler")
    return s["host_s"] * 1e3 / t["requests"] if s and s["count"] else None
