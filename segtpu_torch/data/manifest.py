"""Declarative dataset manifests. Counterpart of ``segtpu/data/manifest.py``.

Each dataset family is a :class:`Manifest`: class count, normalization
stats, palette, a record enumerator and image/label decoders, consumed by
one generic dataset (:class:`ManifestDataset`) and one loader with segtpu's
config surface (:class:`ManifestLoader`). Images and labels decode through
PIL, imported where a file is read.
"""

from __future__ import annotations

import dataclasses
import os
from glob import glob
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np

from segtpu_torch.data.base import BaseDataset, DataLoader


class Record(NamedTuple):
    image: str   # path of the input image
    label: str   # path of the ground-truth mask
    id: str      # sample id (for return_id / result filenames)


@dataclasses.dataclass(frozen=True)
class Manifest:
    num_classes: int
    mean: Sequence[float]
    std: Sequence[float]
    palette: Sequence[int]
    # (root, split) -> [Record]
    records: Callable[[str, str], List[Record]]
    read_image: Callable[[str], np.ndarray] = None  # default: read_rgb
    read_label: Callable[[str], np.ndarray] = None  # default: read_id_png
    # optional joint (image, label) hook after decode (COCO-10k's warp)
    post: Optional[Callable] = None


# ---------------------------------------------------------------------------
# Decoders

def _open(path: str):
    from PIL import Image

    return Image.open(path)


def read_rgb(path: str) -> np.ndarray:
    return np.asarray(_open(path).convert("RGB"), dtype=np.float32)


def read_id_png(path: str) -> np.ndarray:
    return np.asarray(_open(path), dtype=np.int32)


def shifted_id_png(delta: int) -> Callable[[str], np.ndarray]:
    """id PNG with a constant shift (ADE20K stores class+1; 0 = unlabeled)."""
    return lambda path: read_id_png(path) + delta


def lut_png(lut: np.ndarray) -> Callable[[str], np.ndarray]:
    """Raw-id PNG through a 256-entry lookup table (CityScapes 34->19)."""
    lut = np.asarray(lut, np.int32)

    def read(path: str) -> np.ndarray:
        raw = np.asarray(_open(path), dtype=np.int64)
        return lut[np.clip(raw, 0, len(lut) - 1)]

    return read


def rgb_mask_decoder(palette: Sequence[int]) -> Callable[[str], np.ndarray]:
    """Color-mask PNG -> class ids through a search over packed colors
    (DeepScene GT_color); colors outside the palette decode to class 0."""
    colors = np.asarray(palette, np.int64).reshape(-1, 3)
    packed = (colors[:, 0] << 16) | (colors[:, 1] << 8) | colors[:, 2]
    order = np.argsort(packed)
    sorted_packed = packed[order]

    def read(path: str) -> np.ndarray:
        rgb = np.asarray(_open(path).convert("RGB"), np.int64)
        key = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
        pos = np.clip(np.searchsorted(sorted_packed, key), 0, len(sorted_packed) - 1)
        return np.where(sorted_packed[pos] == key, order[pos], 0).astype(np.int32)

    return read


# ---------------------------------------------------------------------------
# Enumeration helpers

def stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def read_list(path: str) -> List[str]:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"split list file not found: {path}")
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def id_records(ids: Sequence[str], image_tpl: str, label_tpl: str) -> List[Record]:
    """Records from sample ids and path templates with ``{id}``."""
    return [Record(image_tpl.format(id=i), label_tpl.format(id=i),
                   os.path.basename(i)) for i in ids]


def glob_records(image_glob: str, label_tpl: str) -> List[Record]:
    """Records from an image glob; the label path derived from each stem."""
    return [Record(p, label_tpl.format(id=stem(p)), stem(p))
            for p in sorted(glob(image_glob))]


def alphanumeric_key(name: str):
    import re

    return [int(c) if c.isdigit() else c.lower() for c in re.split(r"([0-9]+)", name)]


def paired_dir_records(image_dir: str, label_dir: str) -> List[Record]:
    """Positional pairing of two directory listings in alphanumeric order
    (DeepScene's rgb/ and GT_color/ use different extensions)."""
    import logging

    imgs = sorted(os.listdir(image_dir), key=alphanumeric_key)
    lbls = sorted(os.listdir(label_dir), key=alphanumeric_key)
    if len(imgs) != len(lbls):
        logging.getLogger("segtpu_torch.data").warning(
            "%s and %s differ in file count (%d vs %d); pairing the common "
            "prefix", image_dir, label_dir, len(imgs), len(lbls))
    return [Record(os.path.join(image_dir, i), os.path.join(label_dir, l), stem(i))
            for i, l in zip(imgs, lbls)]


def bad_split(split: str, dataset: str, valid) -> ValueError:
    return ValueError(
        f"unknown split {split!r} for {dataset}; expected one of {sorted(valid)}")


# ---------------------------------------------------------------------------
# Generic dataset + loader

class ManifestDataset(BaseDataset):
    def __init__(self, manifest: Manifest, **kwargs):
        self.manifest = manifest
        self.num_classes = manifest.num_classes
        self.palette = list(manifest.palette)
        super().__init__(**kwargs)

    def _set_files(self):
        self.files = self.manifest.records(self.root, self.split)

    def _load_data(self, index: int):
        rec = self.files[index]
        image = (self.manifest.read_image or read_rgb)(rec.image)
        label = (self.manifest.read_label or read_id_png)(rec.label)
        if self.manifest.post is not None:
            image, label = self.manifest.post(image, label)
        return image, label, rec.id


class ManifestLoader(DataLoader):
    """segtpu's loader config surface (data_dir, batch_size, split, the
    augmentation flags) over a Manifest. Subclasses implement
    ``manifest(split, **extra) -> Manifest``."""

    @staticmethod
    def manifest(split: str, **extra) -> Manifest:
        raise NotImplementedError

    def __init__(self, data_dir, batch_size, split, crop_size=None,
                 base_size=None, scale=True, num_workers=1, val=False,
                 shuffle=False, flip=False, rotate=False, blur=False,
                 augment=False, val_split=None, return_id=False,
                 worker_type="thread", device_normalize=False, **extra):
        # a key that manifest() does not take (a typo, or another dataset's
        # option) raises here, naming the dataset and the key
        import inspect

        sig = inspect.signature(type(self).manifest)
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in sig.parameters.values()):
            allowed = set(sig.parameters) - {"split"}
            unknown = set(extra) - allowed
            if unknown:
                raise TypeError(
                    f"{type(self).__name__}: unknown loader arg(s) "
                    f"{sorted(unknown)}; this dataset accepts {sorted(allowed)} "
                    f"beyond the common loader args")
        m = type(self).manifest(split=split, **extra)
        self.MEAN, self.STD = list(m.mean), list(m.std)
        dataset = ManifestDataset(
            m, root=data_dir, split=split, mean=self.MEAN, std=self.STD,
            augment=augment, crop_size=crop_size, base_size=base_size,
            scale=scale, flip=flip, rotate=rotate, blur=blur, val=val,
            return_id=return_id, device_normalize=device_normalize)
        super().__init__(dataset, batch_size, shuffle, num_workers,
                         val_split or 0.0, worker_type=worker_type)
