"""Batch mel extraction CLI (port of ``versband_tpu/cli/mel_extract.py``, the
reference's ``preprocess/mel_spec_24k.py``).

    python -m versband_tpu_torch.cli.mel_extract --tsv_path music.tsv \\
        [--rank 0 --world 1] [--max_wav_len 20] [--platform cpu]

``--mode extract`` (the default), per row of the TSV (column ``audio_path``):
load and resample to 24 kHz mono, skip clips under ``--min_wav_len`` seconds
and under -60 LUFS, normalise to ``--target_lufs`` with a +/-20 dB gain cap
(``mel_spec_24k.py:42-43``), cut to ``--max_wav_len`` seconds, zero-pad to a
hop multiple, and write the 80-bin log-mel (hop 320) of the port's
``dsp/mel.py::MelSpectrogram`` as float32 ``<audio>_mel.npy``. The mel runs
on the card unless ``--platform cpu`` is given; an existing file is kept
unless ``--overwrite``.

``--mode drop_bad_wavs`` drops the rows whose audio cannot be decoded and
``--mode addmel2tsv`` adds or refreshes the ``mel_path`` column and keeps
the rows whose mel exists (``mel_spec_24k.py:224-296``); both rewrite the TSV
as ``DataFrame.to_csv(sep="\\t", index=False)`` does
(``data/manifests.py::write_tsv``).

``--rank/--world`` strides the rows; ``--nproc N`` runs N such ranks as
processes (``utils/fanout.py``). ``--batch_frames`` is accepted and unused,
as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from versband_tpu_torch.data.manifests import Manifest, read_tsv, write_tsv
from versband_tpu_torch.dsp.audio_io import load_wav
from versband_tpu_torch.dsp.loudness import integrated_loudness, normalize_loudness

SR = 24000
HOP = 320


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("versband_tpu mel extraction")
    p.add_argument("--tsv_path", required=True)
    p.add_argument("--mode", default="extract",
                   choices=["extract", "drop_bad_wavs", "addmel2tsv"])
    p.add_argument("--max_wav_len", type=float, default=20.0)
    p.add_argument("--min_wav_len", type=float, default=1.0)
    p.add_argument("--target_lufs", type=float, default=-14.0)
    p.add_argument("--batch_frames", type=int, default=16,
                   help="clips per device batch (accepted, unused)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--nproc", type=int, default=1,
                   help="self-spawn N rank-strided workers (the mp.spawn "
                        "equivalent, mel_spec_24k.py:325-328); CPU-bound "
                        "decode/resample parallelizes across processes")
    p.add_argument("--platform", default=None,
                   help="'cpu' to run the mel on the CPU; default: the card (cuda)")
    p.add_argument("--overwrite", action="store_true")
    return p


def mel_path_for(audio_path: str) -> str:
    base, _ = os.path.splitext(audio_path)
    return base + "_mel.npy"


def _rewrite(path: str, read: Manifest, columns: List[str], rows: list) -> None:
    """``rows`` of the table ``read`` from ``path``, written back as pandas
    writes them. Where ``read`` has no rows, pandas selects by an empty list,
    which keeps no column either: the file is one empty line."""
    write_tsv(path, columns if read.rows else [], rows)


def extract(opt) -> int:
    from versband_tpu_torch.device import resolve_device
    from versband_tpu_torch.dsp.mel import DEFAULT_MEL_CONFIG, MelSpectrogram

    device = resolve_device(opt.platform)
    melnet = MelSpectrogram(DEFAULT_MEL_CONFIG)
    rows = read_tsv(opt.tsv_path).rows[opt.rank::opt.world]
    max_samples = int(opt.max_wav_len * SR)

    done = skipped = 0
    for row in rows:
        audio_path = row["audio_path"]
        out_path = mel_path_for(audio_path)
        if os.path.exists(out_path) and not opt.overwrite:
            continue
        try:
            wav, _ = load_wav(audio_path, SR)
        except Exception as e:  # any file that does not decode is dropped
            print(f"| drop {audio_path}: {type(e).__name__} {e}")
            skipped += 1
            continue
        if len(wav) < opt.min_wav_len * SR:
            print(f"| skip short {audio_path}")
            skipped += 1
            continue
        if integrated_loudness(wav, SR) < -60:
            print(f"| skip silent {audio_path}")
            skipped += 1
            continue
        wav = normalize_loudness(wav, opt.target_lufs, SR, max_gain_db=20.0)
        wav = wav[:max_samples]
        # pad to a hop multiple; mel frames = len/hop
        pad = (-len(wav)) % HOP
        if pad:
            wav = np.pad(wav, (0, pad))
        with torch.no_grad():
            mel = melnet(torch.from_numpy(np.ascontiguousarray(wav[None], np.float32))
                         .to(device))[0]  # [80, T]
        np.save(out_path, mel.cpu().numpy().astype(np.float32))
        done += 1
        if done % 100 == 0:
            print(f"[{opt.rank}] {done} done, {skipped} skipped")
    print(f"[{opt.rank}] finished: {done} extracted, {skipped} skipped")
    return 0


def drop_bad_wavs(opt) -> int:
    """Remove rows whose audio can't be decoded (``mel_spec_24k.py:234-261``)."""
    table = read_tsv(opt.tsv_path)
    keep: List[bool] = []
    for row in table.rows:
        try:
            load_wav(row["audio_path"], None)
            keep.append(True)
        except Exception:  # any file that does not decode is dropped
            print(f"| drop {row['audio_path']}")
            keep.append(False)
    out = table.where(keep)
    _rewrite(opt.tsv_path, table, table.columns, out.rows)
    print(f"kept {len(out)}/{len(table)} rows")
    return 0


def addmel2tsv(opt) -> int:
    """Add/refresh the ``mel_path`` column (``mel_spec_24k.py:264-296``)."""
    table = read_tsv(opt.tsv_path)
    columns = table.columns + ([] if "mel_path" in table else ["mel_path"])
    rows = [{**r, "mel_path": mel_path_for(r["audio_path"])} for r in table.rows]
    rows = [r for r in rows if os.path.exists(r["mel_path"])]
    _rewrite(opt.tsv_path, table, columns, rows)
    print(f"wrote mel_path for {len(rows)} rows")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    opt = get_parser().parse_args(argv)
    if opt.nproc > 1:
        from versband_tpu_torch.utils.fanout import spawn_ranks

        return spawn_ranks("versband_tpu_torch.cli.mel_extract",
                           argv if argv is not None else sys.argv[1:], opt.nproc)
    return {"extract": extract, "drop_bad_wavs": drop_bad_wavs,
            "addmel2tsv": addmel2tsv}[opt.mode](opt)


if __name__ == "__main__":
    raise SystemExit(main())
