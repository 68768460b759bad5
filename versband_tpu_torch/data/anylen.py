"""The any-length text-to-audio dataset (port of ``versband_tpu/data/anylen.py``;
reference ``ldm/data/joinaudiodataset_anylen.py``):

* a main manifest pool, split as the other datasets split (the first 100
  rows validate), and an optional other pool appended after it;
* each caption dropped to ``""`` with probability ``drop`` (CFG dropout);
* mels longer than ``spec_crop_len`` cropped at a random start; an
  unreadable one is ``min_batch_len`` frames of ``pad_value``;
* the collate pads (``mode: pad``) or tiles (``tile``) the batch to its
  longest item, within [64, ``spec_crop_len``] and a multiple of 4;
* ``ordered_indices`` sorts each pool by duration (pandas' sort order on
  ties), for the bucketed sampler.

``StructJoinManifestSpecs`` carries <ori_caption, struct_caption> pairs; its
other pool's items get ``<caption& all>`` struct captions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from versband_tpu_torch.data.collate import collate_1d_or_2d, collate_1d_or_2d_tile
from versband_tpu_torch.data.manifests import argsort_column, load_manifest_dirs, split_dataset
from versband_tpu_torch.data.rng import ThreadLocalRNG


class JoinManifestSpecs:
    def __init__(self, split: str, main_spec_dir_path: str, other_spec_dir_path: str = "",
                 mel_num: int = 80, mode: str = "pad", spec_crop_len: int = 1248,
                 pad_value: float = -5.0, drop: float = 0.0, seed: Optional[int] = None,
                 **kwargs):
        if mode not in ("pad", "tile"):
            raise ValueError(f"mode must be 'pad' or 'tile', not {mode!r}")
        self.split = split
        self.max_batch_len = spec_crop_len
        self.min_batch_len = 64
        self.min_factor = 4
        self.mel_num = mel_num
        self.collate_mode = mode
        self.pad_value = pad_value
        self.drop = drop
        self.rng = ThreadLocalRNG(seed)  # loader threads share the dataset
        self.df_other = load_manifest_dirs(other_spec_dir_path) if other_spec_dir_path else None
        self.dataset = split_dataset(load_manifest_dirs(main_spec_dir_path), split,
                                     valid_head=100)

    def ordered_indices(self):
        main = argsort_column(self.dataset, "duration")
        if self.df_other is None:
            return main
        offset = len(self.dataset)
        return main, [i + offset for i in argsort_column(self.df_other, "duration")]

    def _row(self, idx: int):
        """(row, from the other pool)."""
        if self.df_other is not None and idx >= len(self.dataset):
            return self.df_other[idx - len(self.dataset)], True
        return self.dataset[idx % len(self.dataset)], False

    def _load_spec(self, data) -> np.ndarray:
        try:
            spec = np.load(data["mel_path"]).astype(np.float32)
        except Exception:  # a corrupted file trains as padding, as in the reference
            print(f"corrupted:{data['mel_path']}")
            spec = np.full((self.mel_num, self.min_batch_len), self.pad_value, np.float32)
        if spec.shape[1] > self.max_batch_len:
            start = int(self.rng.integers(spec.shape[1] - self.max_batch_len))
            spec = spec[:, start: start + self.max_batch_len]
        return spec

    def __getitem__(self, idx: int) -> dict:
        data, _ = self._row(idx)
        caption = ""
        if self.rng.uniform() > self.drop:
            caption = str(data.get("caption", ""))
        item = {"image": self._load_spec(data), "caption": caption, "name": data.get("name")}
        if self.split == "test":
            item["f_name"] = data.get("name")
        return item

    def collater(self, inputs) -> dict:
        images = [i["image"] for i in inputs]
        kw = dict(min_len=self.min_batch_len, max_len=self.max_batch_len,
                  min_factor=self.min_factor)
        if self.collate_mode == "pad":
            image = collate_1d_or_2d(images, self.pad_value, **kw)
        else:
            image = collate_1d_or_2d_tile(images, **kw)
        return {"image": image, "caption": [i["caption"] for i in inputs],
                "name": [i.get("name") for i in inputs]}

    def __len__(self) -> int:
        return len(self.dataset) + (len(self.df_other) if self.df_other is not None else 0)


class JoinSpecsTrain(JoinManifestSpecs):
    def __init__(self, specs_dataset_cfg):
        super().__init__("train", **specs_dataset_cfg)


class JoinSpecsValidation(JoinManifestSpecs):
    def __init__(self, specs_dataset_cfg):
        super().__init__("valid", **specs_dataset_cfg)


class JoinSpecsTest(JoinManifestSpecs):
    def __init__(self, specs_dataset_cfg):
        super().__init__("test", **specs_dataset_cfg)


class StructJoinManifestSpecs(JoinManifestSpecs):
    """The dual-caption variant (reference
    ``joinaudiodataset_struct_sample_anylen.py``)."""

    def __getitem__(self, idx: int) -> dict:
        data, from_other = self._row(idx)
        if self.rng.uniform() > self.drop:
            if from_other:
                ori = str(data.get("caption", ""))
                struct = f"<{ori}& all>"
            else:
                ori = str(data.get("ori_cap", ""))
                struct = str(data.get("caption", ""))
        else:
            ori = struct = ""
        return {"image": self._load_spec(data),
                "caption": {"ori_caption": ori, "struct_caption": struct},
                "name": data.get("name")}

    def collater(self, inputs) -> dict:
        out = super().collater([{**i, "caption": ""} for i in inputs])
        out["caption"] = {"ori_caption": [i["caption"]["ori_caption"] for i in inputs],
                          "struct_caption": [i["caption"]["struct_caption"] for i in inputs]}
        return out
