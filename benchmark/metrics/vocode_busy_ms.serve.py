"""Device-busy milliseconds of a request's vocoding (``vocoder.hifigan``, the
``HifiGAN`` wrapper on each take), from the operations launched in its span."""


def read(t):
    s = t["spans"].get("vocoder.hifigan")
    return s["busy_s"] * 1e3 / t["requests"] if s and s["busy_s"] > 0 else None
