"""The one generator of the benchmark's traffic, driven by a mix's data file
(``benchmark/traffic/<name>.json``).

``clips``: requests for accompaniment of one sung clip each. Every request
has the same size (``mel_frames`` padded up to ``frame_multiple``); what a
seed changes is the content, drawn per request from ``(seed, index)``:

* a caption ``"Style: <style> Musical: <template>"``, the template drawn
  from the reference's caption templates and its slots filled from ``fill``;
* a MIDI contour of held notes (lengths uniform in ``note_s``, pitches
  uniform in ``midi_range``, a ``rest_share`` of them rests at 0);
* a beat grid at a tempo uniform in ``tempo_bpm`` (1 on a beat's frame);
* a vocal mel of 20 bands (the CLI's ``acoustic``), and the seed of the
  request's start noise.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TRAFFIC_DIR = os.path.join(os.path.dirname(HERE), "traffic")


def load(name: str) -> Dict[str, Any]:
    with open(os.path.join(TRAFFIC_DIR, f"{name}.json")) as f:
        return json.load(f)


def frames(mix: Dict[str, Any]) -> int:
    m = mix["frame_multiple"]
    return int(math.ceil(mix["mel_frames"] / m) * m)


class Clips:
    """``Clips(mix, seed)[i]``: request ``i`` of the mix under ``seed``."""

    def __init__(self, mix: Dict[str, Any], seed: int):
        self.mix = mix
        self.seed = int(seed) % (1 << 63)
        with open(os.path.join(TRAFFIC_DIR, mix["templates"])) as f:
            self.templates = [t for group in json.load(f).values() for t in group]
        self.T = frames(mix)

    def caption(self, rng: np.random.Generator) -> str:
        mix = self.mix
        template = self.templates[int(rng.integers(len(self.templates)))]

        def fill(m):
            choices = mix["fill"][m.group(0)]
            return choices[int(rng.integers(len(choices)))]

        style = mix["styles"][int(rng.integers(len(mix["styles"])))]
        return f"Style: {style} Musical: {re.sub(r'\[[^\]]*\]', fill, template)}"

    def midi(self, rng: np.random.Generator) -> np.ndarray:
        mix, fps = self.mix, self.mix["frames_per_s"]
        out = np.zeros(self.T, np.int64)
        pos = 0
        lo, hi = mix["midi_range"]
        while pos < self.T:
            n = max(1, int(round(rng.uniform(*mix["note_s"]) * fps)))
            pitch = 0 if rng.random() < mix["rest_share"] else int(rng.integers(lo, hi + 1))
            out[pos:pos + n] = pitch
            pos += n
        return out

    def beats(self, rng: np.random.Generator) -> np.ndarray:
        fps = self.mix["frames_per_s"]
        bpm = rng.uniform(*self.mix["tempo_bpm"])
        period = 60.0 * fps / bpm
        out = np.zeros(self.T, np.int64)
        start = rng.uniform(0, period)
        out[np.round(np.arange(start, self.T, period)).astype(np.int64).clip(0, self.T - 1)] = 1
        return out

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rng = np.random.default_rng([self.seed, int(i)])
        return {"index": int(i), "caption": self.caption(rng),
                "midi": self.midi(rng)[None], "beats": self.beats(rng)[None],
                "vocal": rng.uniform(-6.0, 0.0, (20, self.T)).astype(np.float32),
                "noise_seed": int(rng.integers(1 << 62))}
