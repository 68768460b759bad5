"""Rule-based music-feature -> English prompt generator (the port's own copy of
``versband_tpu/text/caption_generator.py``, numpy only).

Melody features (key, average pitch, tempo, emotion list, duration) are
bucketed into phrase categories and slotted into sentence templates chosen
by a 4-bit presence code, with or without a duration clause
(``ldm/modules/encoders/caption_generator.py:55-838``). ``CaptionGenerator2``
inserts dead zones between buckets. ``templates='reference'`` uses the
reference's verbatim template banks (``reference_templates.json``, a copy of
the JAX package's) and its exact selection table, quirks included. With the
same ``np.random.default_rng(seed)`` the captions are the JAX package's.
"""

from __future__ import annotations

import json
import os
import random
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np


@lru_cache(maxsize=1)
def reference_banks() -> dict:
    """The reference's verbatim template/phrase banks
    (``caption_generator.py:67-610``), extracted as data."""
    path = os.path.join(os.path.dirname(__file__), "reference_templates.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)

_SHARPS = ["C", "G", "D", "A", "E", "B", "F#", "C#", "G#", "D#", "A#", "F"]
_NOTE_TO_PC = {"C": 0, "C#": 1, "D-": 1, "D": 2, "D#": 3, "E-": 3, "E": 4,
               "F": 5, "F#": 6, "G-": 6, "G": 7, "G#": 8, "A-": 8, "A": 9,
               "A#": 10, "B-": 10, "B": 11}
_PC_TO_NAME = {0: "C", 1: "C#", 2: "D", 3: "E-", 4: "E", 5: "F", 6: "F#",
               7: "G", 8: "G#", 9: "A", 10: "B-", 11: "B"}
_ACCIDENTAL_FULL = {"#": "sharp", "-": "flat"}


class SimpleKey:
    """Minimal stand-in for ``music21.key.Key``: tonic step/accidental, mode,
    relative-key computation (major <-> minor a minor third apart)."""

    def __init__(self, name: str):
        name = name.strip()
        if " " in name:
            tonic, mode = name.rsplit(" ", 1)
            mode = mode.lower()
        else:
            tonic, mode = name, ("minor" if name[0].islower() else "major")
        # only the ACCIDENTAL 'b' maps to '-': the first char may itself be
        # the note b (lowercase-minor spelling 'bb' = B-flat minor)
        if len(tonic) > 1:
            tonic = tonic[0] + tonic[1:].replace("b", "-")
        self.tonic = tonic[0].upper() + tonic[1:]
        self.mode = mode if mode in ("major", "minor") else "major"

    @property
    def pitch_class(self) -> int:
        return _NOTE_TO_PC.get(self.tonic, 0)

    @property
    def relative(self) -> "SimpleKey":
        if self.mode == "major":
            pc = (self.pitch_class + 9) % 12
            return SimpleKey(f"{_PC_TO_NAME[pc]} minor")
        pc = (self.pitch_class + 3) % 12
        return SimpleKey(f"{_PC_TO_NAME[pc]} major")

    @property
    def step(self) -> str:
        return self.tonic[0]

    @property
    def accidental(self) -> str:
        return self.tonic[1:] if len(self.tonic) > 1 else ""

    @property
    def full_name(self) -> str:
        acc = self.accidental
        if acc:
            return f"{self.step}-{_ACCIDENTAL_FULL.get(acc, acc)}"
        return self.step

    @property
    def name(self) -> str:
        tonic = self.tonic if self.mode == "major" else self.tonic.lower()
        return f"{tonic} {self.mode}"


class CaptionGenerator:
    """V1: hard bucket edges."""

    key_min_conf = 0.5
    tempo_min_conf = 0.3

    tempo_phrases = {
        "very low": ["very slow", "extremely slow"],
        "low": ["slow", "relaxed", "leisurely"],
        "medium": ["moderate", "medium", "steady"],
        "high": ["fast", "quick", "brisk"],
        "very high": ["very fast", "rapid"],
        "None": [None],
    }
    avg_pitch_phrases = {
        "low": ["low", "deep"],
        "medium": ["medium", "mid-range", "moderate"],
        "high": ["high", "elevated"],
        "very high": ["very high", "soaring"],
        "None": [None],
    }
    duration_phrases = {
        "short": ["a short period of time", "a brief stretch"],
        "medium": ["a medium period of time", "a moderate stretch"],
        "long": ["a long period of time", "an extended stretch"],
        "very long": ["a very long period of time"],
        "None": [None],
    }

    # clause banks for compositional templates -----------------------------
    _OPENERS = [
        "This melody", "The tune of this segment", "This song's melody",
        "The melody here", "This musical passage", "The segment's melody",
    ]
    _KEY_CLAUSES = [
        "set in {key}", "written in {key}", "rooted in the key of {key}",
        "in {key}",
    ]
    _PITCH_CLAUSES = [
        "with a {pitch} pitch", "sitting at a {pitch} pitch level",
        "carrying a {pitch} pitch",
    ]
    _TEMPO_CLAUSES = [
        "moving at a {tempo} tempo", "at a {tempo} pace",
        "keeping a {tempo} tempo",
    ]
    _DURATION_CLAUSES = [
        "lasting {duration}", "spanning {duration}", "running for {duration}",
    ]
    _EMOTION_CLAUSES = [
        "carries a {emotion} mood", "is filled with {emotion} feeling",
        "radiates {emotion} emotion", "breathes a {emotion} atmosphere",
    ]
    _CLOSERS = ["flows through the piece.", "shapes this passage.",
                "defines the section."]

    def __init__(self, rng: Optional[np.random.Generator] = None,
                 templates: str = "clause"):
        if templates not in ("clause", "reference"):
            raise ValueError(f"unknown templates mode {templates!r}")
        self.templates = templates
        self._seeded = rng is not None
        self.rng = rng or np.random.default_rng()
        if templates == "reference":
            banks = reference_banks()
            self.tempo_phrases = banks["tempo_phrases"]
            self.avg_pitch_phrases = banks["avg_pitch_phrases"]
            self.duration_phrases = banks["duration_phrases"]

    # --- feature preparation ----------------------------------------------
    def _choice(self, seq):
        """Draw one element. Reference mode with no explicit rng uses the
        GLOBAL np.random stream (same call order as the torch generator)."""
        if self.templates == "reference" and not self._seeded:
            out = np.random.choice(np.asarray(seq, dtype=object))
            return None if out is None else (str(out) if isinstance(out, (str, np.str_)) else out)
        return seq[int(self.rng.integers(len(seq)))]

    def _coin(self) -> float:
        if self.templates == "reference" and not self._seeded:
            return float(np.random.random(1)[0])
        return float(self.rng.random())

    def _shuffled(self, lst: List[str]) -> List[str]:
        if self.templates == "reference" and not self._seeded:
            return random.sample(lst, len(lst))
        order = list(self.rng.permutation(len(lst)))
        return [lst[i] for i in order]

    def prepare_key(self, key, key_conf) -> Optional[str]:
        if key is None or key == "None" or key_conf < self.key_min_conf:
            return None
        k = SimpleKey(key)
        if self._coin() > 0.5:
            k = k.relative
        if self.templates == "reference":
            # the reference's three spellings (:620-624), music21 strings:
            # tonic.fullName ('F-sharp'), tonic.accidental formatted into the
            # f-string (None -> 'None' for naturals — faithfully reproduced),
            # and key.name ('f# minor').
            acc = _ACCIDENTAL_FULL.get(k.accidental) if k.accidental else None
            spellings = [f"{k.full_name} {k.mode}",
                         f"{k.step} {acc} {k.mode}",
                         f"{k.name}"]
            return self._choice(spellings)
        spellings = [f"{k.full_name} {k.mode}"]
        if k.accidental:
            spellings.append(
                f"{k.step} {_ACCIDENTAL_FULL.get(k.accidental, k.accidental)} {k.mode}")
        spellings.append(k.name)
        return self._choice(spellings)

    def _bucket_tempo(self, tempo) -> str:
        if tempo < 70:
            return "very low"
        if tempo < 90:
            return "low"
        if tempo < 120:
            return "medium"
        if tempo < 160:
            return "high"
        return "very high"

    def prepare_tempo(self, tempo, tempo_conf) -> Optional[str]:
        if tempo is None or tempo <= 0 or tempo_conf < self.tempo_min_conf:
            return None
        return self._choice(self.tempo_phrases[self._bucket_tempo(tempo)])

    def _bucket_pitch(self, p) -> str:
        if p < 56:
            return "low"
        if p < 63:
            return "medium"
        if p < 78:
            return "high"
        return "very high"

    def prepare_avg_pitch(self, avg_pitch) -> Optional[str]:
        if avg_pitch is None or avg_pitch <= 0:
            return None
        return self._choice(self.avg_pitch_phrases[self._bucket_pitch(avg_pitch)])

    def prepare_emotion(self, emotion) -> Optional[str]:
        if emotion is None or len(emotion) == 0 or emotion == "None":
            return None
        if isinstance(emotion, str):
            return emotion
        emotion = list(emotion)
        if len(emotion) == 1:
            return emotion[0]
        shuffled = self._shuffled(emotion)
        if len(shuffled) == 2:
            return " and ".join(shuffled)
        return ", ".join(shuffled[:-1]) + ", and " + shuffled[-1]

    def _bucket_duration(self, d) -> str:
        if d < 5:
            return "short"
        if d < 10:
            return "medium"
        if d < 15:
            return "long"
        return "very long"

    def prepare_duration(self, duration) -> Optional[str]:
        if duration is None or duration <= 0:
            return None
        phrase = self._choice(self.duration_phrases[self._bucket_duration(duration)])
        exact = f"{round(duration)} seconds"
        if phrase is None:
            return self._choice([None, exact])
        return self._choice([phrase, exact])

    # --- sentence composition ---------------------------------------------
    _KEY_KW = "[Key]"
    _PITCH_KW = "[pitch level]"
    _TEMPO_KW = "[tempo]"
    _EMOTION_KW = "[emotional characteristics]"
    _DURATION_KW = "[duration]"

    def _transcribe_reference(self, key, avg_pitch, tempo, emotion,
                              duration) -> str:
        """The reference's exact bank-selection table (:689-778), quirks
        included (1110/0010 leave placeholders; 0011-with-duration reuses the
        no-duration bank)."""
        b = reference_banks()
        code = "".join(str(int(v is not None))
                       for v in (key, avg_pitch, tempo, emotion))

        def pick(bank):
            return str(self._choice(b[bank]))

        def sub(c, **kw):
            for kwname, val in kw.items():
                token = {"key": self._KEY_KW, "pitch": self._PITCH_KW,
                         "tempo": self._TEMPO_KW, "emotion": self._EMOTION_KW,
                         "duration": self._DURATION_KW}[kwname]
                c = c.replace(token, val)
            return c

        if duration is None:
            table = {
                "1111": ("full_factor_templates",
                         dict(key=key, pitch=avg_pitch, tempo=tempo,
                              emotion=emotion)),
                "0111": ("templates_wo_key",
                         dict(pitch=avg_pitch, tempo=tempo, emotion=emotion)),
                "1011": ("templates_wo_avg_pitch",
                         dict(key=key, tempo=tempo, emotion=emotion)),
                "1101": ("templates_wo_tempo",
                         dict(key=key, pitch=avg_pitch, emotion=emotion)),
                # reference quirk: 1110 uses the FULL bank, leaving the
                # [emotional characteristics] placeholder in place
                "1110": ("full_factor_templates",
                         dict(key=key, pitch=avg_pitch, tempo=tempo)),
                "0011": ("templates_wo_key_and_avg_pitch",
                         dict(tempo=tempo, emotion=emotion)),
                "0101": ("templates_wo_key_and_tempo",
                         dict(pitch=avg_pitch, emotion=emotion)),
                "0110": ("templates_wo_key_and_emotion",
                         dict(pitch=avg_pitch, tempo=tempo)),
                "1001": ("templates_wo_avg_pitch_and_tempo",
                         dict(key=key, emotion=emotion)),
                "1010": ("templates_wo_avg_pitch_and_emotion",
                         dict(key=key, tempo=tempo)),
                "1100": ("templates_wo_tempo_and_emotion",
                         dict(key=key, pitch=avg_pitch)),
                "0001": ("templates_wo_key_and_avg_pitch_and_tempo",
                         dict(emotion=emotion)),
                # quirk: tempo-only also draws from the FULL bank
                "0010": ("full_factor_templates", dict(tempo=tempo)),
            }
        else:
            table = {
                "1111": ("full_factor_templates_w_duration",
                         dict(key=key, pitch=avg_pitch, tempo=tempo,
                              emotion=emotion, duration=duration)),
                "0111": ("templates_wo_key_w_duration",
                         dict(pitch=avg_pitch, tempo=tempo, emotion=emotion,
                              duration=duration)),
                "1011": ("templates_wo_avg_pitch_w_duration",
                         dict(key=key, tempo=tempo, emotion=emotion,
                              duration=duration)),
                "1101": ("templates_wo_tempo_w_duration",
                         dict(key=key, pitch=avg_pitch, emotion=emotion,
                              duration=duration)),
                "1110": ("full_factor_templates_w_duration",
                         dict(key=key, pitch=avg_pitch, tempo=tempo,
                              duration=duration)),
                # quirk: the no-duration bank (duration replace is a no-op)
                "0011": ("templates_wo_key_and_avg_pitch",
                         dict(tempo=tempo, emotion=emotion,
                              duration=duration)),
                "0101": ("templates_wo_key_and_tempo_w_duration",
                         dict(pitch=avg_pitch, emotion=emotion,
                              duration=duration)),
                "0110": ("templates_wo_key_and_emotion_w_duration",
                         dict(pitch=avg_pitch, tempo=tempo,
                              duration=duration)),
                "1001": ("templates_wo_avg_pitch_and_tempo_w_duration",
                         dict(key=key, emotion=emotion, duration=duration)),
                "1010": ("templates_wo_avg_pitch_and_emotion_w_duration",
                         dict(key=key, tempo=tempo, duration=duration)),
                "1100": ("templates_wo_tempo_and_emotion_w_duration",
                         dict(key=key, pitch=avg_pitch, duration=duration)),
                "0001": ("templates_wo_key_and_avg_pitch_and_tempo_w_duration",
                         dict(emotion=emotion, duration=duration)),
                "0010": ("full_factor_templates_w_duration",
                         dict(tempo=tempo, duration=duration)),
            }
        if code not in table:
            return ""
        bank, repl = table[code]
        return sub(pick(bank), **repl)

    def transcribe(self, key=None, key_conf=0.0, avg_pitch=None, tempo=None,
                   tempo_conf=0.0, emotion=None, duration=None) -> str:
        key = self.prepare_key(key, key_conf)
        tempo = self.prepare_tempo(tempo, tempo_conf)
        avg_pitch = self.prepare_avg_pitch(avg_pitch)
        emotion = self.prepare_emotion(emotion)
        duration = self.prepare_duration(duration)

        if self.templates == "reference":
            return self._transcribe_reference(key, avg_pitch, tempo, emotion,
                                              duration)

        clauses: List[str] = []
        if key is not None:
            clauses.append(self._choice(self._KEY_CLAUSES).format(key=key))
        if avg_pitch is not None:
            clauses.append(self._choice(self._PITCH_CLAUSES).format(pitch=avg_pitch))
        if tempo is not None:
            clauses.append(self._choice(self._TEMPO_CLAUSES).format(tempo=tempo))
        if duration is not None:
            clauses.append(self._choice(self._DURATION_CLAUSES).format(duration=duration))
        if not clauses and emotion is None:
            return ""

        sentence = self._choice(self._OPENERS)
        if clauses:
            if len(clauses) == 1:
                sentence += f", {clauses[0]},"
            else:
                sentence += ", " + ", ".join(clauses[:-1]) + f" and {clauses[-1]},"
        if emotion is not None:
            sentence += " " + self._choice(self._EMOTION_CLAUSES).format(emotion=emotion)
        else:
            sentence = sentence.rstrip(",") + " " + self._choice(self._CLOSERS)[:-1]
        return sentence.strip() + ("." if not sentence.endswith(".") else "")


class CaptionGenerator2(CaptionGenerator):
    """V2: dead zones between buckets map to the 'None' phrase (-> feature
    dropped) so borderline values never mislead the model
    (``caption_generator.py:781-838``)."""

    def prepare_tempo(self, tempo, tempo_conf):
        if tempo is None or tempo <= 0 or tempo_conf < self.tempo_min_conf:
            return None
        if tempo < 69:
            b = "very low"
        elif 71 <= tempo < 89:
            b = "low"
        elif 91 <= tempo < 119:
            b = "medium"
        elif 121 <= tempo < 159:
            b = "high"
        elif tempo >= 161:
            b = "very high"
        else:
            b = "None"
        return self._choice(self.tempo_phrases[b])

    def prepare_avg_pitch(self, avg_pitch):
        if avg_pitch is None or avg_pitch <= 0:
            return None
        if avg_pitch < 53:
            b = "low"
        elif 56 <= avg_pitch < 62:
            b = "medium"
        elif 64 <= avg_pitch < 77:
            b = "high"
        elif avg_pitch >= 79:
            b = "very high"
        else:
            b = "None"
        return self._choice(self.avg_pitch_phrases[b])

    def prepare_duration(self, duration):
        if duration is None or duration <= 0:
            return None
        if duration < 4.5:
            b = "short"
        elif 5.5 <= duration < 9.5:
            b = "medium"
        elif 10.5 <= duration < 14.5:
            b = "long"
        elif duration >= 15.5:
            b = "very long"
        else:
            b = "None"
        phrase = self._choice(self.duration_phrases[b])
        exact = f"{round(duration)} seconds"
        if phrase is None:
            return self._choice([None, exact])
        return self._choice([phrase, exact])
