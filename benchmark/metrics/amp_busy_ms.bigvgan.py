"""Device-busy milliseconds a request spends in BigVGAN's AMP blocks outside
their activations: the program's span ``vocoder.bigvgan.amp`` in
``BigVGANGenerator.forward`` (each stage's 3 blocks, their dilated and plain
convolutions, the residual adds and the blocks' mean). An operation goes to
the innermost span open, so the activations inside the blocks count under
``vocoder.bigvgan.act`` (``k4_roofline.bigvgan``), not here. Without that
span in the trace it reads nothing."""


def read(t):
    s = t.get("program", {}).get("vocoder.bigvgan.amp")
    return s["busy_s"] * 1e3 / t["requests"] if s and s["busy_s"] > 0 else None
