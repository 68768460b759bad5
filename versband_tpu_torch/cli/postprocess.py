"""Post-processing CLI (port of ``versband_tpu/cli/postprocess.py``, the
reference's ``preprocess/postprocess.py``).

    python -m versband_tpu_torch.cli.postprocess --manifest music.tsv \\
        --notes notes.npy --beats beats_dict.npy --out_dir out/

Joins the audio manifest (a ``vocal_mel_path`` column per row) with per-item
MIDI notes ({'pitches', 'note_durs'}) and beat times, as FRAME-LEVEL arrays
at 75 fps (24 kHz / hop 320):

* note durations -> per-frame pitch ids 0..127 (``postprocess.py:272-301``),
  cut to ``--max_wav_len`` and padded or cut to the vocal mel's length; an
  item more than ``--frame_tolerance`` frames off that length is skipped;
* beat times -> 0/1 impulse frames (``postprocess.py:307-315``);
* the optional ``--music_feat`` TSV adds its key, tempo, pitch and emotion
  columns to the items it names; ``wav_len`` is the duration capped at
  ``--max_wav_len``.

Writes ``total.tsv`` (as ``pd.DataFrame(rows).to_csv(sep="\\t",
index=False)`` writes the rows: columns in first-seen order, a column's
missing cells empty and its integers widened to floats where it has floats or
missing cells) and ``midi.npy`` / ``beats.npy``, pickled dicts of int64
arrays keyed by item name in manifest order.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np

from versband_tpu_torch.data.manifests import read_tsv, write_tsv

SR = 24000
HOP = 320
FPS = SR / HOP
FEATURE_COLUMNS = ("key", "key_confidence", "tempo", "tempo_confidence", "avg_pitch",
                   "emotion")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("versband_tpu postprocess")
    p.add_argument("--manifest", required=True,
                   help="music.tsv with name/mel_path/vocal_mel_path/wav_len")
    p.add_argument("--notes", required=True,
                   help="npy dict: name -> {'pitches', 'note_durs'}")
    p.add_argument("--beats", required=True,
                   help="npy dict: name -> [[time_s, ...], ...]")
    p.add_argument("--music_feat", default=None,
                   help="optional music-feature tsv (key/tempo/emotion cols)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_wav_len", type=float, default=20.0)
    p.add_argument("--frame_tolerance", type=int, default=10)
    return p


def notes_to_frame_pitches(pitches, note_durs, fps: float = FPS) -> np.ndarray:
    frames = [round(float(d) * fps) for d in note_durs]
    out = []
    for pitch, n in zip(pitches, frames):
        out.extend([int(pitch)] * n)
    return np.asarray(out, np.int64)


def beats_to_frames(beats, n_frames: int, fps: float = FPS) -> np.ndarray:
    out = np.zeros(n_frames, np.int64)
    for beat in beats:
        t = beat[0] if hasattr(beat, "__len__") else beat
        frame = int(float(t) * fps)
        if frame < n_frames:
            out[frame] = 1
    return out


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and \
        not isinstance(v, (bool, np.bool_))


def frame_rows(rows: List[Dict[str, Any]]) -> tuple:
    """(columns, rows) of ``pd.DataFrame(rows)`` as ``to_csv`` writes it:
    columns in first-seen order, a missing cell NaN, and a column of numbers
    that holds a float or a NaN held as floats (so an integer there is written
    ``1.0``)."""
    columns: List[str] = []
    for r in rows:
        columns += [c for c in r if c not in columns]
    out = [{c: r.get(c, math.nan) for c in columns} for r in rows]
    for c in columns:
        vals = [r[c] for r in out]
        if all(_is_number(v) for v in vals) and not all(
                isinstance(v, (int, np.integer)) for v in vals):
            for r in out:
                r[c] = float(r[c])
    return columns, out


def main(argv: Optional[List[str]] = None) -> int:
    opt = get_parser().parse_args(argv)
    os.makedirs(opt.out_dir, exist_ok=True)
    table = read_tsv(opt.manifest)
    notes = np.load(opt.notes, allow_pickle=True).item()
    beats_dict = np.load(opt.beats, allow_pickle=True).item()
    feats = {}
    if opt.music_feat:
        feats = {r["item_name"]: r for r in read_tsv(opt.music_feat).rows}

    rows, midi_out, beats_out = [], {}, {}
    skip = 0
    for item in table.rows:
        name = item["name"]
        if name not in notes or name not in beats_dict:
            skip += 1
            continue
        try:
            mel = np.load(item["vocal_mel_path"], mmap_mode="r")
        except Exception:  # a missing, unreadable or NaN path: skipped
            skip += 1
            continue
        n_frames = mel.shape[1]

        fp = notes_to_frame_pitches(notes[name]["pitches"], notes[name]["note_durs"])
        midi_time = float(np.sum(list(notes[name]["note_durs"])))
        if midi_time > opt.max_wav_len:
            fp = fp[: int(opt.max_wav_len * FPS)]
        if abs(len(fp) - n_frames) > opt.frame_tolerance:
            print(f"| Skip {name}: midi frames {len(fp)} vs mel {n_frames}")
            skip += 1
            continue
        fp = fp[:n_frames]
        if len(fp) < n_frames:
            fp = np.pad(fp, (0, n_frames - len(fp)))
        if not ((fp >= 0).all() and (fp < 128).all()):
            raise ValueError(f"{name}: MIDI pitches outside 0..127")

        row = dict(item)
        if name in feats:
            for col in FEATURE_COLUMNS:
                if col in feats[name]:
                    row[col] = feats[name][col]
        row["wav_len"] = min(float(item.get("duration", n_frames / FPS)), opt.max_wav_len)
        rows.append(row)
        midi_out[name] = fp
        beats_out[name] = beats_to_frames(beats_dict[name], n_frames)

    write_tsv(os.path.join(opt.out_dir, "total.tsv"), *frame_rows(rows))
    np.save(os.path.join(opt.out_dir, "midi.npy"), midi_out, allow_pickle=True)
    np.save(os.path.join(opt.out_dir, "beats.npy"), beats_out, allow_pickle=True)
    print(f"wrote {len(rows)} items to {opt.out_dir} (skip {skip})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
