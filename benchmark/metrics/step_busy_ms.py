"""Device-busy milliseconds a training step takes (``train.trainer``:
``CFMTrainer.fit`` -> ``train.step``, or ``VAETrainer.fit`` ->
``train.vae_step``): the union of the device operations' intervals over the
traced steps, per step."""


def read(t):
    return t["busy_s"] * 1e3 / t["steps"] if t.get("steps") and t["busy_s"] > 0 else None
