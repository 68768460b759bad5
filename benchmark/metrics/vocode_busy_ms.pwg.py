"""Device-busy milliseconds of a request's vocoding by Parallel WaveGAN (the
driver's ``vocoder.pwg`` span around the ``ParallelWaveGAN`` wrapper on
each take: the mel upsampler, the 30 residual layers, the output convs),
from the operations launched in its span."""


def read(t):
    s = t["spans"].get("vocoder.pwg")
    return s["busy_s"] * 1e3 / t["requests"] if s and s["busy_s"] > 0 else None
