"""Host milliseconds a request spends in the caption tower (``text.embedders``
-> ``text.t5``, on the caption and on "" for CFG): the span around the two
``get_learned_conditioning`` calls."""


def read(t):
    s = t["spans"].get("text.t5")
    return s["host_s"] * 1e3 / t["requests"] if s and s["count"] else None
