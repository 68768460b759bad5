"""The fixed-length dataset of stage 1 (port of ``versband_tpu/data/fixed_len.py``;
reference ``ldm/data/joinaudiodataset_624.py``): each mel is tiled up to at
least ``spec_crop_len`` frames and then cropped at a random start to exactly
that length. Captions are not read (the VAE is unconditional).

* the first ``valid_head = 100`` manifest rows validate, the rest train; the
  test split takes every row;
* an unreadable mel file gives a zero mel (printed);
* ``load_batch``, the loader's batched path, reads a batch through the C++
  loader (:mod:`versband_tpu_torch.native`), which the dataset builds when it
  is made (in the parent, before any worker process starts); items shorter
  than the crop, and unreadable ones, take the per-item path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from versband_tpu_torch import native
from versband_tpu_torch.data.manifests import load_manifest_dirs, split_dataset
from versband_tpu_torch.data.rng import ThreadLocalRNG


class JoinManifestSpecs:
    def __init__(self, split: str, spec_dir_path: str, mel_num: int = 80,
                 spec_crop_len: int = 624, drop: float = 0.0, seed: Optional[int] = None,
                 **kwargs):
        self.split = split
        self.batch_max_length = spec_crop_len
        self.batch_min_length = 50
        self.mel_num = mel_num
        self.drop = drop
        self.rng = ThreadLocalRNG(seed)  # loader threads share the dataset
        self.dataset = split_dataset(load_manifest_dirs(spec_dir_path, recursive=True), split,
                                     valid_head=100)
        native.ensure_built()

    def __getitem__(self, idx: int) -> dict:
        data = self.dataset[idx]
        try:
            spec = np.load(data["mel_path"])
        except Exception:  # a corrupted file trains as silence, as in the reference
            print(f"corrupted:{data['mel_path']}")
            spec = np.zeros((self.mel_num, self.batch_max_length), np.float32)
        if spec.shape[1] < self.batch_max_length:
            spec = np.tile(spec, self.batch_max_length // spec.shape[1] + 1)
        if spec.shape[1] > self.batch_max_length:
            start = int(self.rng.integers(spec.shape[1] - self.batch_max_length))
            spec = spec[:, start: start + self.batch_max_length]
        item = {"image": spec[:, : self.batch_max_length].astype(np.float32)}
        if self.split == "test":
            item["f_name"] = data["name"]
        return item

    def collater(self, inputs) -> dict:
        out = {"image": np.stack([i["image"] for i in inputs])}
        if "f_name" in inputs[0]:
            out["f_name"] = [i["f_name"] for i in inputs]
        return out

    def load_batch(self, idxs) -> dict:
        """The batch of ``idxs`` through the C++ loader: one read at frame 0,
        a second read at a random start for the items longer than the crop
        (their starts drawn in batch order), the per-item path for the
        shorter or unreadable ones."""
        rows = [self.dataset[int(i)] for i in idxs]
        paths = [r["mel_path"] for r in rows]
        batch, lengths = native.load_mel_batch(paths, self.mel_num, self.batch_max_length)
        redo, starts = [], []
        for i, p in enumerate(paths):
            if lengths[i] > 0:
                full_len = np.load(p, mmap_mode="r").shape[1]
                if full_len > self.batch_max_length:
                    starts.append(int(self.rng.integers(full_len - self.batch_max_length)))
                    redo.append(i)
        if redo:
            sub, _ = native.load_mel_batch([paths[i] for i in redo], self.mel_num,
                                           self.batch_max_length, starts=starts)
            batch[redo] = sub
        for i in range(len(rows)):
            if lengths[i] < self.batch_max_length:
                batch[i] = self[int(idxs[i])]["image"]
        out = {"image": batch}
        if self.split == "test":
            out["f_name"] = [r["name"] for r in rows]
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
