"""Pascal VOC 2012 (and SBD-augmented ``*_aug`` splits), 21 classes.
Counterpart of ``segtpu/data/voc.py``: plain splits read id lists from
ImageSets/Segmentation; ``*_aug`` splits read "image label" path pairs
rooted at VOCdevkit/VOC2012.
"""

from __future__ import annotations

import os

from segtpu_torch import palette
from segtpu_torch.data import manifest as mf

MEAN = [0.45734706, 0.43338275, 0.40058118]
STD = [0.23965294, 0.23532275, 0.2398498]

_PLAIN = {"train", "trainval", "val", "test"}
_AUG = {"train_aug", "trainval_aug", "val_aug", "test_aug"}


def _records(root: str, split: str):
    base = os.path.join(root, "VOCdevkit/VOC2012")
    lines = mf.read_list(
        os.path.join(base, "ImageSets/Segmentation", f"{split}.txt"))
    if split in _PLAIN:
        return mf.id_records(
            lines,
            image_tpl=os.path.join(base, "JPEGImages", "{id}.jpg"),
            label_tpl=os.path.join(base, "SegmentationClass", "{id}.png"))
    # aug lists: "/img/x.jpg /cls/x.png" pairs relative to the VOC root
    recs = []
    for line in lines:
        img, lbl = line.split()
        recs.append(mf.Record(os.path.join(base, img.lstrip("/")),
                              os.path.join(base, lbl.lstrip("/")),
                              mf.stem(img)))
    return recs


class VOC(mf.ManifestLoader):
    @staticmethod
    def manifest(split: str) -> mf.Manifest:
        if split not in _PLAIN | _AUG:
            raise mf.bad_split(split, "VOC", _PLAIN | _AUG)
        return mf.Manifest(num_classes=21, mean=MEAN, std=STD,
                           palette=palette.get_voc_palette(21),
                           records=_records)
