"""DeepScene Freiburg Forest, 6 classes + void. Counterpart of
``segtpu/data/deepscene.py``: color-mask labels decoded to ids through the
palette; rgb/ and GT_color/ paired by position; ImageNet statistics.
"""

from __future__ import annotations

import os

from segtpu_torch import palette
from segtpu_torch.data import manifest as mf

MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]

# the on-disk tree names its two halves train/ and test/
_SPLIT_DIRS = {"training": "train", "validation": "test"}


def _records(root: str, split: str):
    sub = _SPLIT_DIRS[split]
    return mf.paired_dir_records(os.path.join(root, sub, "rgb"),
                                 os.path.join(root, sub, "GT_color"))


class DeepScene(mf.ManifestLoader):
    @staticmethod
    def manifest(split: str) -> mf.Manifest:
        if split not in _SPLIT_DIRS:
            raise mf.bad_split(split, "DeepScene", _SPLIT_DIRS)
        return mf.Manifest(
            num_classes=7, mean=MEAN, std=STD,
            palette=palette.DeepScene_palette,
            records=_records,
            read_label=mf.rgb_mask_decoder(palette.DeepScene_palette))
