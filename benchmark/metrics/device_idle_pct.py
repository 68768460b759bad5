"""Share of the traced slice (requests or training steps) in which no
operation ran on the card. In the training cells it holds the loader's, the
caption tower's and the callbacks' host time until spans inside the program
split it."""


def read(t):
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] > 0 else None
