"""COCO-Stuff, 182 classes: the 10k partition (.mat labels, an optional
513x513 warp) and the 164k partition (grayscale PNG labels). Counterpart of
``segtpu/data/coco.py`` without cv2: the warp's image resize is
``cv.resize_linear``, and the 164k labels decode as ``cv2.imread(path,
IMREAD_GRAYSCALE)`` does (``_gray_png``).
"""

from __future__ import annotations

import os

import numpy as np

from segtpu_torch import palette
from segtpu_torch.data import cv
from segtpu_torch.data import manifest as mf

MEAN = [0.43931922, 0.41310471, 0.37480941]
STD = [0.24272706, 0.23649098, 0.23429529]

_SPLITS_10K = {"train", "test", "all"}
_SPLITS_164K = {"train2017", "val2017"}


def _mat_label(path: str) -> np.ndarray:
    """10k ground truth ships as MATLAB ``S`` matrices: 0 = unlabeled, so
    shift to 0-based ids with unlabeled -> 255."""
    import scipy.io as sio

    label = np.asarray(sio.loadmat(path)["S"], np.int32) - 1
    return np.where(label < 0, 255, label)


def _warp_513(image: np.ndarray, label: np.ndarray):
    """10k's fixed-size warp: the image by linear resize, the label by PIL
    NEAREST of its uint8 values, as segtpu."""
    from PIL import Image

    image = cv.resize_linear(image, (513, 513))
    label = np.asarray(Image.fromarray(label.astype(np.uint8)).resize(
        (513, 513), resample=Image.NEAREST), dtype=np.int32)
    return image, label


def _gray_png(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` of a PNG: gray 8-bit as
    stored, 16-bit by its high byte, 1-bit as 0/255; color and palette PNGs
    through libpng's fixed-point ``(9797 R + 19234 G + 3737 B) >> 15``
    (alpha dropped)."""
    from PIL import Image

    img = Image.open(path)
    if img.mode in ("L", "LA", "1"):
        return np.asarray(img.convert("L"), np.int32)
    if img.mode.startswith("I;16"):
        return np.asarray(img, np.int32) >> 8
    rgb = np.asarray(img.convert("RGB"), np.int32)
    return (rgb[..., 0] * 9797 + rgb[..., 1] * 19234 + rgb[..., 2] * 3737) >> 15


def _records_10k(root: str, split: str):
    ids = mf.read_list(os.path.join(root, "imageLists", f"{split}.txt"))
    return mf.id_records(ids,
                         image_tpl=os.path.join(root, "images", "{id}.jpg"),
                         label_tpl=os.path.join(root, "annotations", "{id}.mat"))


def _records_164k(root: str, split: str):
    return mf.glob_records(
        os.path.join(root, "images", split, "*.jpg"),
        label_tpl=os.path.join(root, "annotations", split, "{id}.png"))


class COCO(mf.ManifestLoader):
    @staticmethod
    def manifest(split: str, partition: str = "CocoStuff164k",
                 warp_image: bool = True) -> mf.Manifest:
        common = dict(num_classes=182, mean=MEAN, std=STD,
                      palette=palette.COCO_palette)
        if partition == "CocoStuff10k":
            if split not in _SPLITS_10K:
                raise mf.bad_split(split, "CocoStuff10k", _SPLITS_10K)
            return mf.Manifest(records=_records_10k, read_label=_mat_label,
                               post=_warp_513 if warp_image else None, **common)
        if partition == "CocoStuff164k":
            if split not in _SPLITS_164K:
                raise mf.bad_split(split, "CocoStuff164k", _SPLITS_164K)
            return mf.Manifest(records=_records_164k, read_label=_gray_png, **common)
        raise ValueError(f"unknown COCO partition {partition!r} "
                         f"(CocoStuff10k or CocoStuff164k)")
