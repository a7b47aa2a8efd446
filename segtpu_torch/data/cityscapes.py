"""CityScapes (fine and coarse), 19 train classes. Counterpart of
``segtpu/data/cityscapes.py``: raw label ids 0-33 go to the 19 official
train ids through a 256-entry lookup table, every other id to 255 (ignore);
label paths are derived from each ``*_leftImg8bit.png`` name.
"""

from __future__ import annotations

import os

import numpy as np

from segtpu_torch import palette
from segtpu_torch.data import manifest as mf

MEAN = [0.28689529, 0.32513294, 0.28389176]
STD = [0.17613647, 0.18099176, 0.17772235]

IGNORE = 255
# official trainId table: 19 kept classes, everything else ignored
_TRAIN_IDS = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
              22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16,
              32: 17, 33: 18}
_LUT = np.full(256, IGNORE, dtype=np.int32)
for _raw, _train in _TRAIN_IDS.items():
    _LUT[_raw] = _train

_SPLITS = {"fine": {"train", "val"}, "coarse": {"train", "train_extra", "val"}}


def _records_fn(mode: str):
    def records(root: str, split: str):
        if mode == "coarse":
            img_pack = ("leftImg8bit_trainextra" if split == "train_extra"
                        else "leftImg8bit_trainvaltest")
            gt = "gtCoarse"
            lbl_root = os.path.join(root, gt, gt, split)
        else:
            img_pack = "leftImg8bit_trainvaltest"
            gt = "gtFine"
            lbl_root = os.path.join(root, f"{gt}_trainvaltest", gt, split)
        img_glob = os.path.join(root, img_pack, "leftImg8bit", split,
                                "*", "*_leftImg8bit.png")
        recs = []
        for img in sorted(mf.glob(img_glob)):
            city = os.path.basename(os.path.dirname(img))
            name = os.path.basename(img).replace("_leftImg8bit.png",
                                                 f"_{gt}_labelIds.png")
            recs.append(mf.Record(img, os.path.join(lbl_root, city, name),
                                  mf.stem(img)))
        return recs

    return records


class CityScapes(mf.ManifestLoader):
    @staticmethod
    def manifest(split: str, mode: str = "fine") -> mf.Manifest:
        if mode not in _SPLITS:
            raise ValueError(f"unknown CityScapes mode {mode!r} "
                             f"(fine or coarse)")
        if split not in _SPLITS[mode]:
            raise mf.bad_split(split, f"CityScapes[{mode}]", _SPLITS[mode])
        return mf.Manifest(num_classes=19, mean=MEAN, std=STD,
                           palette=palette.CityScapes_palette,
                           records=_records_fn(mode),
                           read_label=mf.lut_png(_LUT))
