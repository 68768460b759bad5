"""The CFM training dataset: vocal-to-accompaniment pairs with prompts (port
of ``versband_tpu/data/vocal2accomp.py``; numpy, no pandas).

Per item, from a row of the manifest:

* ``image``: the accompaniment mel [80, T], a random ``spec_crop_len`` crop
  of a longer one;
* ``acoustic``: the vocal mel's first 20 bins [20, T]; ``midi`` [1, T]
  (pad 128) and ``beats`` [1, T] (pad 2) from the ``other_condition`` dicts,
  cropped in step with the mel;
* ``caption``: "Style: <one <psep> choice> " + "Musical: <prompt of
  CaptionGenerator2>", each half dropped with probability ``drop`` (CFG);
* the acoustic conditions are dropped (set to their pad values) with
  probability ``drop``, for a corrupt file, and where the vocal mel's length
  differs from the mel's by more than 5 frames;
* every length rounded up to a multiple of 8.

``collater`` pads a batch to its longest item within [``min_batch_len``,
``spec_crop_len``] (the floor wins), a multiple of 4. Randomness is a
per-dataset stream, thread-local per loader thread (``data/rng.py``);
``seed=None`` draws OS entropy, so such runs differ from run to run.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional

import numpy as np

from versband_tpu_torch.data.collate import collate_1d_or_2d, pad_or_cut_xd
from versband_tpu_torch.data.manifests import (argsort_column, load_manifest_dirs,
                                               split_dataset)
from versband_tpu_torch.data.rng import ThreadLocalRNG
from versband_tpu_torch.text.caption_generator import CaptionGenerator2

MIDI_PAD = 128  # pitch value of a frame with no MIDI note
BEATS_PAD = 2  # beat value of a frame with no beat annotation
_MISS = object()


class JoinManifestSpecs:
    def __init__(self, split: str, main_spec_dir_path: str,
                 other_spec_dir_path: str = "", mel_num: int = 80,
                 mode: str = "pad", spec_crop_len: int = 1248,
                 pad_value: float = -5.0, drop: float = 0.0,
                 max_tokens: int = 80000, other_condition: Optional[str] = None,
                 seed: Optional[int] = None, caption_templates: str = "clause",
                 min_batch_len: int = 375, **kwargs):
        assert mode in ("pad", "tile")
        self.split = split
        self.max_batch_len = spec_crop_len
        # a 5 s (375-frame) batch floor by default; collate applies it after
        # the crop length, so it wins when spec_crop_len < min_batch_len
        self.min_batch_len = min_batch_len
        self.min_factor = 4
        self.unit_frames_multiple = 2 * self.min_factor  # 8: latent is T/2, mel mult of 4
        self.mel_num = mel_num
        self.collate_mode = mode
        self.pad_value = pad_value
        self.drop = drop
        self.max_tokens = max_tokens
        self.rng = ThreadLocalRNG(seed)  # loader threads share the dataset
        self.caption_generator = CaptionGenerator2(rng=self.rng,
                                                    templates=caption_templates)

        self.df_main = load_manifest_dirs(main_spec_dir_path)
        self.dataset = split_dataset(self.df_main, split, valid_head=300)
        # npy files are opened once as memmaps (np.load re-parses the header
        # on every call), emotion strings parsed once
        self._rows = self.dataset.rows
        self._mmap_cache: dict = {}
        self._mmap_cap = 512  # bounds open fds on huge manifests
        self._mmap_lock = threading.Lock()  # dataset is loader-thread-shared
        self._emotion_cache: dict = {}

        self.midi_dict, self.beats_dict = {}, {}
        if other_condition:
            self.midi_dict = np.load(other_condition, allow_pickle=True).item()
            self.beats_dict = np.load(other_condition.replace("midi", "beats"),
                                      allow_pickle=True).item()

    def ordered_indices(self):
        return argsort_column(self.dataset, "duration")

    def _caption_for(self, data) -> str:
        caption = prompt = ""
        if self.rng.uniform() > self.drop:
            choices = str(data["caption"]).split("<psep>")
            caption = f"Style: {choices[int(self.rng.integers(len(choices)))]} "
        if self.rng.uniform() > self.drop:
            text = self.caption_generator.transcribe(
                key=data.get("key"),
                key_conf=float(data.get("key_confidence", 0.0)),
                avg_pitch=float(data.get("avg_pitch", 0.0)),
                tempo=float(data.get("tempo", 0.0)),
                tempo_conf=float(data.get("tempo_confidence", 0.0)),
                emotion=self._emotion_for(data.get("emotion")),
                duration=float(data.get("wav_len", 0.0)))
            prompt = f"Musical: {text}"
        return caption + prompt

    def _emotion_for(self, raw):
        """Memoized ``_parse_emotion``: each emotion string is parsed once."""
        if isinstance(raw, (list, tuple)):
            return list(raw)
        if raw is None or (isinstance(raw, float) and np.isnan(raw)):
            return None  # NaN != NaN would grow the cache one entry per row
        try:
            hit = self._emotion_cache.get(raw, _MISS)
        except TypeError:  # unhashable oddball — parse directly
            return self._parse_emotion(raw)
        if hit is _MISS:
            hit = self._parse_emotion(raw)
            self._emotion_cache[raw] = hit
        return hit

    def _load_npy(self, path: str) -> np.ndarray:
        """Memmap-open each npy once (header parse + fd reused across epochs);
        callers slice their crop and copy only that."""
        mm = self._mmap_cache.get(path)
        if mm is None:
            mm = np.load(path, mmap_mode="r")
            if os.path.getsize(path) < mm.offset + mm.nbytes:
                # truncated on disk: touching the memmap would SIGBUS the
                # loader thread; a full read raises a catchable error
                return np.load(path)
            with self._mmap_lock:  # evict+insert race: two threads popping
                if len(self._mmap_cache) >= self._mmap_cap:
                    first = next(iter(self._mmap_cache), None)
                    self._mmap_cache.pop(first, None)
                self._mmap_cache[path] = mm
        return mm

    @staticmethod
    def _parse_emotion(raw):
        if raw is None or (isinstance(raw, float) and np.isnan(raw)):
            return None
        if isinstance(raw, (list, tuple)):
            return list(raw)
        s = str(raw).strip()
        if s.startswith("["):  # "'['happy', 'sad']'" — literal list in the tsv
            import ast

            try:
                return list(ast.literal_eval(s))
            except Exception:
                return None
        return [s] if s and s != "None" else None

    def _pad_conditions(self, spec_len: int):
        T = math.ceil(spec_len)
        acoustic = np.full((20, T), self.pad_value, np.float32)
        midi = np.full((1, T), MIDI_PAD, np.float32)
        beats = np.full((1, T), BEATS_PAD, np.float32)
        return acoustic, midi, beats

    def __getitem__(self, idx: int) -> dict:
        idx = idx % len(self._rows)
        data = self._rows[idx]
        caption = self._caption_for(data)

        start = -1
        valid_spec = True
        try:
            mm = self._load_npy(data["mel_path"])  # [80, T]
            org_spec_len = mm.shape[1]
            if org_spec_len > self.max_batch_len:
                start = int(self.rng.integers(org_spec_len - self.max_batch_len))
                mm = mm[:, start: start + self.max_batch_len]
            spec = np.asarray(mm, np.float32)  # copy only the crop
        except Exception:
            print(f"corrupted: {data['mel_path']}")
            spec = np.full((self.mel_num, self.min_batch_len), self.pad_value,
                           np.float32)
            org_spec_len = self.min_batch_len
            start = 0
            valid_spec = False
        spec_len = spec.shape[1]

        try:
            acoustic = np.asarray(
                self._load_npy(data["vocal_mel_path"])[:20, :], np.float32)
            midi = np.asarray(self.midi_dict[data["name"]], np.float32)[None]
            beats = np.asarray(self.beats_dict[data["name"]], np.float32)[None]
        except Exception:
            acoustic, midi, beats = self._pad_conditions(spec_len)
            valid_spec = valid_spec and False

        # CFG dropout of the acoustic conditioning
        dropped = self.rng.uniform() < self.drop or not valid_spec
        if dropped:
            acoustic, midi, beats = self._pad_conditions(spec_len)

        # length-consistency guard: the full-length vocal mel against the
        # full-length accompaniment mel (org_spec_len is taken before the crop)
        if abs(acoustic.shape[1] - org_spec_len) > 5 and valid_spec \
                and not dropped:
            print(f"corrupted: {data.get('vocal_mel_path')}")
            acoustic, midi, beats = self._pad_conditions(spec_len)

        # crop the conditions in step with the mel crop
        if acoustic.shape[1] > self.max_batch_len:
            s = max(min(max(start, 0),
                        acoustic.shape[1] - self.max_batch_len - 1), 0)
            acoustic = acoustic[:, s: s + self.max_batch_len]
            midi = midi[:, s: s + self.max_batch_len]
            beats = beats[:, s: s + self.max_batch_len]

        # round everything to a multiple of 8
        T = int(math.ceil(acoustic.shape[1] / self.unit_frames_multiple)
                * self.unit_frames_multiple)
        acoustic = pad_or_cut_xd(acoustic, T, 1, self.pad_value)
        midi = pad_or_cut_xd(midi, T, 1, MIDI_PAD)
        beats = pad_or_cut_xd(beats, T, 1, BEATS_PAD)
        spec = pad_or_cut_xd(spec, T, 1, self.pad_value)

        item = {"image": spec, "acoustic": acoustic, "midi": midi,
                "beats": beats, "caption": caption, "name": data["name"]}
        if self.split == "test":
            item["f_name"] = data["name"]
        return item

    def collater(self, inputs) -> dict:
        cols = {k: [item[k] for item in inputs] for k in inputs[0]}
        kw = dict(min_len=self.min_batch_len, max_len=self.max_batch_len,
                  min_factor=self.min_factor)
        out = {
            "image": collate_1d_or_2d(cols["image"], self.pad_value, **kw),
            "acoustic": collate_1d_or_2d(cols["acoustic"], self.pad_value, **kw),
            "midi": collate_1d_or_2d(cols["midi"], MIDI_PAD, **kw).astype(np.int32),
            "beats": collate_1d_or_2d(cols["beats"], BEATS_PAD, **kw).astype(np.int32),
        }
        out["caption"] = {
            "caption": cols["caption"],
            "acoustic": {"acoustic": out["acoustic"], "midi": out["midi"],
                         "beats": out["beats"]},
            "name": cols["name"],
        }
        out["image"] = out["image"]
        out["name"] = cols["name"]
        return out

    def __len__(self) -> int:
        return len(self.dataset)


class JoinSpecsTrain(JoinManifestSpecs):
    def __init__(self, specs_dataset_cfg):
        super().__init__("train", **specs_dataset_cfg)


class JoinSpecsValidation(JoinManifestSpecs):
    def __init__(self, specs_dataset_cfg):
        super().__init__("valid", **specs_dataset_cfg)


class JoinSpecsTest(JoinManifestSpecs):
    def __init__(self, specs_dataset_cfg):
        super().__init__("test", **specs_dataset_cfg)
