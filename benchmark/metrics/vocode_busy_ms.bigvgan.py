"""Device-busy milliseconds of a request's vocoding by BigVGAN (the driver's
``vocoder.bigvgan`` span around the ``VocoderBigVGAN`` wrapper on each
take: ``conv_pre``, six upsampling stages of 3 AMP blocks each, the last
activation and ``conv_post``), from the operations launched in its span."""


def read(t):
    s = t["spans"].get("vocoder.bigvgan")
    return s["busy_s"] * 1e3 / t["requests"] if s and s["busy_s"] > 0 else None
