"""ADE20K SceneParsing, 150 classes. Counterpart of ``segtpu/data/ade20k.py``:
stored labels are class+1 with 0 = unlabeled, so the -1 shift maps
unlabeled to -1 (ADE20K configs use ``ignore_index: -1``).
"""

from __future__ import annotations

import os

from segtpu_torch import palette
from segtpu_torch.data import manifest as mf

MEAN = [0.48897059, 0.46548275, 0.4294]
STD = [0.22861765, 0.22948039, 0.24054667]

_SPLITS = {"training", "validation"}


def _records(root: str, split: str):
    return mf.glob_records(
        os.path.join(root, "images", split, "*.jpg"),
        label_tpl=os.path.join(root, "annotations", split, "{id}.png"))


class ADE20K(mf.ManifestLoader):
    @staticmethod
    def manifest(split: str) -> mf.Manifest:
        if split not in _SPLITS:
            raise mf.bad_split(split, "ADE20K", _SPLITS)
        return mf.Manifest(num_classes=150, mean=MEAN, std=STD,
                           palette=palette.ADE20K_palette,
                           records=_records,
                           read_label=mf.shifted_id_png(-1))
