"""Model FLOP utilisation of the whole request or training step: the model
FLOPs of the traced slice, counted by its driver from the configuration's
shapes (``benchmark/lib/flops.py``; serving: the T5 tower twice, the DiT's
encode and forwards, the VAE decode, HiFi-GAN per take, per request;
training: ``benchmark/drivers/train.py::step_flops`` per step), over the
traced slice's length times the peak the configuration names."""


def read(t):
    if t["window_s"] <= 0 or not t.get("flops"):
        return None
    return 100.0 * t["flops"] / (t["window_s"] * t["peak_flops"])
