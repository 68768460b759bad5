"""Manifest generation CLI (port of ``versband_tpu/cli/make_manifest.py``, the
reference's ``preprocess/preprocess.py``).

    python -m versband_tpu_torch.cli.make_manifest \\
        --prompts crawl_a.tsv crawl_b.tsv --data_root /data --out music.tsv

Each prompt row carries ``item_name`` (``<sep>``-separated source parts:
dataset, subset, name, index) and a ``caption`` literal list. A row whose
accompaniment wav (``--path_template``) and vocal wav (the same path with
``accomp`` replaced by ``vocal``) both exist gives TWO manifest rows, the
accompaniment's and the vocal's, with their mel paths, the accompaniment's
duration at 24 kHz and the ``<psep>``-joined caption (``str()`` of the cell
where it is no literal list of strings). The file is written without quoting
and with backslash escapes (``utils/tsv.py::save_df_to_tsv``), as the JAX
package writes it through pandas.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import List, Optional

from versband_tpu_torch.data.manifests import Manifest, read_tsv
from versband_tpu_torch.dsp.audio_io import get_wav_num_frames
from versband_tpu_torch.utils.tsv import save_df_to_tsv

MANIFEST_COLUMNS = ["name", "dataset", "audio_path", "mel_path", "duration", "caption"]


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("versband_tpu manifest generation")
    p.add_argument("--prompts", nargs="+", required=True,
                   help="crawled prompt TSVs with item_name + caption columns")
    p.add_argument("--data_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--path_template",
                   default="{root}/{ds}_sp_demix_24k/{sub}/[{idx}]{name}.accomp.wav",
                   help="wav path template with {root},{ds},{sub},{idx},{name}")
    p.add_argument("--sep", default="<sep>")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    opt = get_parser().parse_args(argv)
    rows = []
    skip = 0
    for prompts_tsv in opt.prompts:
        for item in read_tsv(prompts_tsv).rows:
            parts = str(item["item_name"]).split(opt.sep)
            if len(parts) < 4:
                skip += 1
                continue
            ds, sub, name, idx = parts[0], parts[1], parts[2], parts[3]
            wav_path = opt.path_template.format(root=opt.data_root, ds=ds, sub=sub, idx=idx,
                                                name=name)
            vocal_path = wav_path.replace("accomp", "vocal")
            if not (os.path.exists(wav_path) and os.path.exists(vocal_path)):
                skip += 1
                continue
            try:
                caption = "<psep>".join(ast.literal_eval(item["caption"]))
            except Exception:  # any cell that is no literal list of strings
                caption = str(item.get("caption", ""))
            dur = get_wav_num_frames(wav_path, 24000) / 24000.0
            for nm, ap in ((item["item_name"], wav_path),
                           (str(item["item_name"]) + "vocal", vocal_path)):
                rows.append({"name": str(nm), "dataset": ds, "audio_path": ap,
                             "mel_path": os.path.splitext(ap)[0] + "_mel.npy",
                             "duration": dur, "caption": caption})
    save_df_to_tsv(Manifest(list(MANIFEST_COLUMNS), rows), opt.out)
    print(f"wrote {len(rows)} rows to {opt.out} (skip {skip})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
