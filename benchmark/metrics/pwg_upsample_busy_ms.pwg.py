"""Device-busy milliseconds a request spends in Parallel WaveGAN's mel
upsampler (the program's span ``vocoder.pwg.upsample`` in
``ParallelWaveGANGenerator.forward``: the context conv, then a nearest
stretch and a smoothing conv per scale), from the operations launched in
it. Without that span in the trace it reads nothing."""


def read(t):
    s = t.get("program", {}).get("vocoder.pwg.upsample")
    return s["busy_s"] * 1e3 / t["requests"] if s and s["busy_s"] > 0 else None
