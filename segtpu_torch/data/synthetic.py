"""Synthetic in-memory dataset: deterministic images whose pixels carry a
learnable signal per class. Counterpart of ``segtpu/data/synthetic.py``,
sample for sample, with every augmentation flag acting."""

from __future__ import annotations

import numpy as np

from segtpu_torch import palette
from segtpu_torch.data.base import BaseDataset, DataLoader

MEAN = [0.5, 0.5, 0.5]
STD = [0.25, 0.25, 0.25]


class SyntheticDataset(BaseDataset):
    def __init__(self, num_classes=8, size=64, image_hw=96, **kwargs):
        self.num_classes = num_classes
        self.palette = palette.generated_palette(num_classes)
        self._size = size
        self._hw = image_hw
        super().__init__(**kwargs)

    def _set_files(self):
        self.files = list(range(self._size))

    def _load_data(self, index):
        rng = np.random.default_rng(index)
        hw = self._hw
        label = np.zeros((hw, hw), np.int32)
        # random rectangles of random classes over a random background class
        label[:] = rng.integers(0, self.num_classes)
        for _ in range(4):
            c = int(rng.integers(0, self.num_classes))
            y0, x0 = rng.integers(0, hw // 2, size=2)
            y1, x1 = y0 + rng.integers(8, hw // 2), x0 + rng.integers(8, hw // 2)
            label[y0:y1, x0:x1] = c
        image = (label[..., None].astype(np.float32) * (255.0 / self.num_classes)
                 + rng.normal(0, 8, size=(hw, hw, 3)).astype(np.float32))
        image = np.clip(image, 0, 255)
        return image, label, str(index)


class Synthetic(DataLoader):
    """Loader over :class:`SyntheticDataset` with segtpu's config keys."""

    def __init__(self, data_dir=None, batch_size=8, split="train",
                 crop_size=64, base_size=None, scale=False, num_workers=1,
                 val=False, shuffle=True, flip=False, rotate=False,
                 blur=False, augment=True, val_split=None, return_id=False,
                 num_classes=8, size=64, image_hw=96, worker_type="thread",
                 device_normalize=False):
        self.MEAN, self.STD = MEAN, STD
        dataset = SyntheticDataset(
            num_classes=num_classes, size=size, image_hw=image_hw,
            root=data_dir or "", split=split, mean=MEAN, std=STD,
            augment=augment, crop_size=crop_size, base_size=base_size,
            scale=scale, flip=flip, blur=blur, rotate=rotate,
            return_id=return_id, val=val, device_normalize=device_normalize)
        super().__init__(dataset, batch_size, shuffle, num_workers,
                         val_split or 0.0, worker_type=worker_type)
