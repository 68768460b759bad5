"""The single-TSV test dataset (port of ``versband_tpu/data/tsvdataset.py``;
the reference names ``ldm.data.tsvdataset.TSVDatasetStruct`` in
``configs/vocal2music.yaml`` but does not ship it): rows with a mel path and
a caption (or an <ori, struct> caption pair), each mel cropped at a random
start to ``spec_crop_len``; an unreadable mel is all ``pad_value``. The TSV is
read with :func:`versband_tpu_torch.data.manifests.read_tsv` (the cells
``pandas.read_csv`` gives), not pandas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from versband_tpu_torch.data.manifests import read_tsv
from versband_tpu_torch.data.rng import ThreadLocalRNG


class TSVDataset:
    def __init__(self, tsv_path: str, spec_crop_len: int = 1500, mel_num: int = 80,
                 pad_value: float = -5.0, seed: Optional[int] = None, **kwargs):
        self.df = read_tsv(tsv_path)
        self.spec_crop_len = spec_crop_len
        self.mel_num = mel_num
        self.pad_value = pad_value
        self.rng = ThreadLocalRNG(seed)  # loader threads share the dataset

    def _load_mel(self, row) -> np.ndarray:
        try:
            mel = np.load(row["mel_path"]).astype(np.float32)
        except Exception:  # an unreadable mel generates from padding
            mel = np.full((self.mel_num, self.spec_crop_len), self.pad_value, np.float32)
        if mel.shape[1] > self.spec_crop_len:
            start = int(self.rng.integers(mel.shape[1] - self.spec_crop_len))
            mel = mel[:, start: start + self.spec_crop_len]
        return mel

    def __getitem__(self, idx: int) -> dict:
        row = self.df[idx]
        return {"image": self._load_mel(row), "caption": str(row.get("caption", "")),
                "name": row.get("name", str(idx)), "f_name": row.get("name", str(idx))}

    def __len__(self) -> int:
        return len(self.df)


class TSVDatasetStruct(TSVDataset):
    """The <ori_caption, struct_caption> pair variant."""

    def __getitem__(self, idx: int) -> dict:
        item = super().__getitem__(idx)
        row = self.df[idx]
        item["caption"] = {"ori_caption": str(row.get("ori_cap", row.get("caption", ""))),
                           "struct_caption": str(row.get("caption", ""))}
        return item
