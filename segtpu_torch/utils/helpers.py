"""Small host-side helpers: directories, mask colorization, image reading.

Counterpart of ``segtpu/utils/helpers.py``. PIL is imported where an image
is read or made, not when the module is imported: the trainer imports this
module and needs no image library.
"""

from __future__ import annotations

import os

import numpy as np


def dir_exists(path: str):
    if not os.path.exists(path):
        os.makedirs(path, exist_ok=True)


def colorize_mask(mask: np.ndarray, palette):
    """P-mode PIL image of an integer mask, its palette padded to 768 values
    (the original repo's ``utils/helpers.py:36-42``)."""
    from PIL import Image

    palette = list(palette)
    palette = palette + [0] * max(256 * 3 - len(palette), 0)
    new_mask = Image.fromarray(np.asarray(mask).astype(np.uint8)).convert("P")
    new_mask.putpalette(palette)
    return new_mask


def denormalize(image: np.ndarray, mean, std) -> np.ndarray:
    """Invert the loaders' normalization for display: HWC float in [0, 1]."""
    return np.clip(image * np.asarray(std) + np.asarray(mean), 0.0, 1.0)


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an image file."""
    from PIL import Image

    with Image.open(path) as image:
        return np.asarray(image.convert("RGB"))
