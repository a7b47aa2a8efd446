"""Paired image and mask transforms (numpy), segtpu's
``utils/transforms.py``: Compose, DeNormalize, RandomCrop, CenterCrop,
RandomHorizontallyFlip, Scale, RandomSizedCrop, RandomRotate and
SlidingCrop.

Each takes and returns (image HWC float32 or uint8, mask HW int) arrays and
draws from an explicit ``random.Random`` with segtpu's calls in segtpu's
order, so a seed gives segtpu's crops, flips and angles. segtpu calls cv2;
these call ``segtpu_torch/data/cv.py`` in its place: ``resize_linear`` and
``warp_affine_linear`` for the images, ``resize_nearest`` and
``warp_affine_nearest`` (through float32, as segtpu casts) for the masks,
``rotation_matrix`` for ``getRotationMatrix2D``.

``cv.py`` reproduces OpenCV on float32 images (the resizes bit for bit,
the linear warp to its last float bits). OpenCV resizes a uint8 image in
fixed point; here a uint8 image is resized and warped in float32 and
rounded to the nearest level, within one level of OpenCV's.
"""

from __future__ import annotations

import math
import random as _random
from typing import Sequence, Tuple

import numpy as np

from segtpu_torch.data import cv

Pair = Tuple[np.ndarray, np.ndarray]


def _to_dtype(out: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def _resize(img, mask, hw) -> Pair:
    """``cv2.resize`` to ``hw``: INTER_LINEAR for the image, INTER_NEAREST
    for the mask."""
    out = cv.resize_linear(np.asarray(img, np.float32), hw)
    m = cv.resize_nearest(mask.astype(np.float32), hw).astype(mask.dtype)
    return _to_dtype(out, img.dtype), m


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, mask, rng=_random):
        assert img.shape[:2] == mask.shape[:2]
        for t in self.transforms:
            img, mask = t(img, mask, rng)
        return img, mask


class DeNormalize:
    """Inverts the loaders' normalization, for display."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, tensor_hwc: np.ndarray) -> np.ndarray:
        return tensor_hwc * self.std + self.mean


class RandomCrop:
    def __init__(self, size, padding: int = 0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img, mask, rng=_random) -> Pair:
        if self.padding > 0:
            p = self.padding
            img = np.pad(img, ((p, p), (p, p), (0, 0)))
            mask = np.pad(mask, ((p, p), (p, p)))
        h, w = mask.shape
        th, tw = self.size
        if w == tw and h == th:
            return img, mask
        if w < tw or h < th:
            return _resize(img, mask, (th, tw))
        x1 = rng.randint(0, w - tw)
        y1 = rng.randint(0, h - th)
        return img[y1:y1 + th, x1:x1 + tw], mask[y1:y1 + th, x1:x1 + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img, mask, rng=_random) -> Pair:
        h, w = mask.shape
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return img[y1:y1 + th, x1:x1 + tw], mask[y1:y1 + th, x1:x1 + tw]


class RandomHorizontallyFlip:
    def __call__(self, img, mask, rng=_random) -> Pair:
        if rng.random() < 0.5:
            return np.fliplr(img).copy(), np.fliplr(mask).copy()
        return img, mask


class Scale:
    """Resizes so that the longer side is ``size``."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, mask, rng=_random) -> Pair:
        h, w = mask.shape
        if (w >= h and w == self.size) or (h > w and h == self.size):
            return img, mask
        if w > h:
            ow, oh = self.size, int(self.size * h / w)
        else:
            oh, ow = self.size, int(self.size * w / h)
        return _resize(img, mask, (oh, ow))


class RandomSizedCrop:
    """A crop of 45-100% of the area at an aspect of 0.5-2, resized to
    ``size``; after ``attempts`` misses, Scale then CenterCrop."""

    def __init__(self, size: int, attempts: int = 10):
        self.size = size
        self.attempts = attempts

    def __call__(self, img, mask, rng=_random) -> Pair:
        h, w = mask.shape
        for _ in range(self.attempts):
            target_area = rng.uniform(0.45, 1.0) * h * w
            aspect = rng.uniform(0.5, 2.0)
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if rng.random() < 0.5:
                cw, ch = ch, cw
            if cw <= w and ch <= h:
                x1 = rng.randint(0, w - cw)
                y1 = rng.randint(0, h - ch)
                return _resize(img[y1:y1 + ch, x1:x1 + cw], mask[y1:y1 + ch, x1:x1 + cw],
                               (self.size, self.size))
        img, mask = Scale(self.size)(img, mask, rng)
        return CenterCrop(self.size)(img, mask, rng)


class RandomRotate:
    """A rotation about the centre by an angle uniform in [-degree,
    degree), zeros outside the frame."""

    def __init__(self, degree: float):
        self.degree = degree

    def __call__(self, img, mask, rng=_random) -> Pair:
        angle = rng.random() * 2 * self.degree - self.degree
        h, w = mask.shape
        rot = cv.rotation_matrix((w / 2, h / 2), angle, 1.0)
        out = cv.warp_affine_linear(np.asarray(img, np.float32), rot, (h, w))
        m = cv.warp_affine_nearest(mask.astype(np.float32), rot, (h, w)).astype(mask.dtype)
        return _to_dtype(out, img.dtype), m


class SlidingCrop:
    """Tiles an image into overlapping ``crop_size`` windows, padding a
    short window (image with 0, mask with ``ignore_label``); returns the
    lists of images, masks and (y, x, h, w) positions."""

    def __init__(self, crop_size: int, stride_rate: float, ignore_label: int):
        self.crop_size = crop_size
        self.stride_rate = stride_rate
        self.ignore_label = ignore_label

    def _pad(self, img, mask):
        h, w = mask.shape
        pad_h = max(self.crop_size - h, 0)
        pad_w = max(self.crop_size - w, 0)
        if pad_h > 0 or pad_w > 0:
            img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)))
            mask = np.pad(mask, ((0, pad_h), (0, pad_w)), constant_values=self.ignore_label)
        return img, mask, h, w

    def __call__(self, img, mask, rng=_random):
        h, w = mask.shape
        if max(h, w) <= self.crop_size:
            img, mask, ch, cw = self._pad(img, mask)
            return [img], [mask], [(0, 0, ch, cw)]
        stride = int(math.ceil(self.crop_size * self.stride_rate))
        num_h = int(math.ceil((h - self.crop_size) / stride)) + 1
        num_w = int(math.ceil((w - self.crop_size) / stride)) + 1
        imgs, masks, slices = [], [], []
        for yi in range(num_h):
            for xi in range(num_w):
                sy = min(yi * stride, max(h - self.crop_size, 0))
                sx = min(xi * stride, max(w - self.crop_size, 0))
                ci, cm, ch, cw = self._pad(img[sy:sy + self.crop_size, sx:sx + self.crop_size],
                                           mask[sy:sy + self.crop_size, sx:sx + self.crop_size])
                imgs.append(ci)
                masks.append(cm)
                slices.append((sy, sx, ch, cw))
        return imgs, masks, slices
