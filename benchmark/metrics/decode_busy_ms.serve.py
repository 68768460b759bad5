"""Device-busy milliseconds of a request's VAE decode (``models.autoencoder``,
``decode_first_stage``), from the operations launched in its span."""


def read(t):
    s = t["spans"].get("models.autoencoder.decode")
    return s["busy_s"] * 1e3 / t["requests"] if s and s["busy_s"] > 0 else None
