"""Base dataset and a threaded batching loader, numpy only.

Counterpart of ``segtpu/data/base.py``. The branches that need only numpy
come across with segtpu's semantics: the train random crop (zero-padded up
to the crop first), the horizontal flip, the val centre crop when no resize
is needed, and the normalization ``(x/255 - mean)/std``. Scale, rotate,
blur and the val resize need cv2 or PIL and raise ``NotImplementedError``
until the data slice of ROADMAP ports them.

Each sample's augmentation draws from a ``random.Random`` keyed on (seed,
epoch, index), so batches do not depend on the number of workers.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

_NEEDS_CV2 = ("needs cv2/PIL and is not ported yet: see ROADMAP, "
              "'data slice' (cv2 loader branches)")


def _sample_rng(seed: int, epoch: int, idx: int) -> random.Random:
    return random.Random(hash((seed, epoch, idx)))


class BaseDataset:
    """Abstract dataset. Subclasses set ``num_classes``/``palette`` before
    calling ``super().__init__`` and implement ``_set_files`` and
    ``_load_data(index) -> (image HWC float32 [0, 255], label HW int, id)``.
    """

    def __init__(self, root, split, mean, std, base_size=None, augment=True,
                 val=False, crop_size=321, flip=True, rotate=False, blur=False,
                 device_normalize=False):
        for name, on in (("base_size (random scale)", base_size and augment
                          and not val),
                         ("rotate", rotate and augment and not val),
                         ("blur", blur and augment and not val)):
            if on:
                raise NotImplementedError(f"{type(self).__name__}: {name} {_NEEDS_CV2}")
        self.root = root
        self.split = split
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.augment = augment
        self.crop_size = crop_size
        self.flip = flip
        self.val = val
        self.device_normalize = device_normalize
        self.files: List = []
        self._set_files()

    def _set_files(self):
        raise NotImplementedError

    def _load_data(self, index: int):
        raise NotImplementedError

    def _val_augmentation(self, image, label):
        """Centre crop to ``crop_size``. segtpu first resizes the shorter
        side to the crop; that is the identity only when it already is."""
        if self.crop_size:
            h, w = label.shape
            if min(h, w) != self.crop_size:
                raise NotImplementedError(
                    f"val resize of a {h}x{w} image to crop {self.crop_size} "
                    f"{_NEEDS_CV2}")
            start_h = (h - self.crop_size) // 2
            start_w = (w - self.crop_size) // 2
            image = image[start_h:start_h + self.crop_size,
                          start_w:start_w + self.crop_size]
            label = label[start_h:start_h + self.crop_size,
                          start_w:start_w + self.crop_size]
        return image, label

    def _train_augmentation(self, image, label, rng: random.Random):
        h, w, _ = image.shape
        if self.crop_size:
            pad_h = max(self.crop_size - h, 0)
            pad_w = max(self.crop_size - w, 0)
            if pad_h > 0 or pad_w > 0:
                image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)))
                label = np.pad(label, ((0, pad_h), (0, pad_w)))
            h, w = label.shape
            start_h = rng.randint(0, h - self.crop_size)
            start_w = rng.randint(0, w - self.crop_size)
            image = image[start_h:start_h + self.crop_size,
                          start_w:start_w + self.crop_size]
            label = label[start_h:start_h + self.crop_size,
                          start_w:start_w + self.crop_size]
        if self.flip and rng.random() > 0.5:
            image = np.fliplr(image).copy()
            label = np.fliplr(label).copy()
        return image, label

    def normalize(self, image: np.ndarray) -> np.ndarray:
        return (image.astype(np.float32) / 255.0 - self.mean) / self.std

    def __len__(self):
        return len(self.files)

    def get(self, index: int, rng: Optional[random.Random] = None):
        """(image HWC float32 normalized, or HWC uint8 raw pixels with
        ``device_normalize``; label HW int32)."""
        image, label, _ = self._load_data(index)
        label = np.asarray(label, np.int32)
        if self.val:
            image, label = self._val_augmentation(image, label)
        elif self.augment:
            image, label = self._train_augmentation(image, label, rng or random)
        # the augmented image is quantized to uint8, as the original repo
        # does before ToTensor
        image = np.asarray(image, np.float32).astype(np.uint8)
        if not self.device_normalize:
            image = self.normalize(image)
        return image, label

    def __getitem__(self, index):
        return self.get(index)


class DataLoader:
    """Threaded batching loader with fixed shapes. Train drops the ragged
    tail; val pads it with ignore-labeled (-100) samples."""

    def __init__(self, dataset: BaseDataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self._epoch = 0
        self._skip_next = 0

    def __len__(self):
        if self.dataset.val:
            return -(-len(self.dataset) // self.batch_size)
        return len(self.dataset) // self.batch_size

    def set_epoch(self, n: int):
        """The next ``__iter__`` gives training epoch ``n + 1``'s order (a
        fresh loader starts at 0): the resume hook."""
        self._epoch = n

    def skip_batches(self, k: int):
        """The next ``__iter__`` skips its first ``k`` batches without
        fetching them and yields the rest of that epoch's order: a
        mid-epoch resume continues where the interrupted run stopped."""
        self._skip_next = int(k)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self._epoch).shuffle(order)
        self._epoch += 1
        epoch, bs = self._epoch, self.batch_size
        skip, self._skip_next = self._skip_next, 0

        def fetch(idx):
            return self.dataset.get(int(idx), rng=_sample_rng(0, epoch, int(idx)))

        with ThreadPoolExecutor(self.num_workers) as pool:
            for b in range(skip, len(self)):
                samples = list(pool.map(fetch, order[b * bs:(b + 1) * bs]))
                images = np.stack([s[0] for s in samples])
                labels = np.stack([s[1] for s in samples])
                if len(samples) < bs:
                    pad = bs - len(samples)
                    images = np.concatenate(
                        [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
                    labels = np.concatenate(
                        [labels, np.full((pad,) + labels.shape[1:], -100, labels.dtype)])
                yield images, labels
