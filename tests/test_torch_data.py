"""The port's numpy versions of segtpu's cv2 calls (segtpu_torch/data/cv.py)
against cv2 itself, and the port's train and val augmentation against
segtpu's on the same inputs and ``random.Random`` seeds.

Images are uniform noise with integer values, as float32, so a coordinate
error shows as tens of levels; labels are random ids with 255 among them.
Tolerance: labels bit-equal; images, once quantized to uint8 as the loaders
do, at most 1 level apart on at most 1e-3 of the values (the warp's float
rounding is not OpenCV's; the resizes and the blur are bit-equal).
"""

import itertools
import random

import cv2
import numpy as np
import pytest

from segtpu.data.base import BaseDataset as SegtpuBase
from segtpu_torch.data import cv
from segtpu_torch.data.base import BaseDataset

cv2.setNumThreads(0)
MAX_SHARE = 1e-3


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.float32)


def _label(rng, h, w):
    label = rng.integers(0, 20, (h, w)).astype(np.int32)
    label[rng.random((h, w)) < 0.1] = 255
    return label


def _assert_image_close(got, want):
    g = np.asarray(got, np.float32).astype(np.uint8).astype(np.int16)
    w = np.asarray(want, np.float32).astype(np.uint8).astype(np.int16)
    assert g.shape == w.shape
    diff = np.abs(g - w)
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("src,dst", [((40, 50), (63, 77)), ((64, 64), (32, 32)),
                                     ((65, 33), (17, 65)), ((37, 53), (37, 53)),
                                     ((50, 40), (61, 41))],
                         ids=["up", "exact-2x-down", "mixed", "same", "near"])
def test_resize_matches_cv2(src, dst):
    """Bit for bit, for the whole frame and for a window of it."""
    rng = np.random.default_rng(0)
    image = _image(rng, *src) + rng.random(src + (3,)).astype(np.float32)
    label = _label(rng, *src).astype(np.float32)
    (h, w) = dst
    want = cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)
    want_l = cv2.resize(label, (w, h), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(cv.resize_linear(image, dst), want)
    np.testing.assert_array_equal(cv.resize_nearest(label, dst), want_l)
    rows, cols = (h // 4, h - h // 3), (w // 5, w - 1)
    np.testing.assert_array_equal(cv.resize_linear(image, dst, rows, cols),
                                  want[rows[0]:rows[1], cols[0]:cols[1]])
    np.testing.assert_array_equal(cv.resize_nearest(label, dst, rows, cols),
                                  want_l[rows[0]:rows[1], cols[0]:cols[1]])


@pytest.mark.parametrize("angle", [-10, 0, 10])
@pytest.mark.parametrize("hw", [(40, 50), (65, 33)])
def test_warp_affine_matches_cv2(hw, angle):
    """Labels bit for bit; images within a level; the window form equals
    the matching part of the whole warp."""
    rng = np.random.default_rng(angle + 20)
    h, w = hw
    image, label = _image(rng, h, w), _label(rng, h, w).astype(np.float32)
    rot = cv.rotation_matrix((w / 2, h / 2), angle, 1.0)
    np.testing.assert_array_equal(rot, cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0))
    want = cv2.warpAffine(image, rot, (w, h), flags=cv2.INTER_LINEAR)
    want_l = cv2.warpAffine(label, rot, (w, h), flags=cv2.INTER_NEAREST)
    got = cv.warp_affine_linear(image, rot, hw)
    _assert_image_close(got, want)
    np.testing.assert_array_equal(cv.warp_affine_nearest(label, rot, hw), want_l)
    rows, cols = (3, h - 5), (7, w - 2)
    y0, y1, x0, x1 = cv.warp_source_box(rot, hw, hw, rows, cols)
    np.testing.assert_array_equal(
        cv.warp_affine_linear(image[y0:y1, x0:x1], rot, hw, rows, cols, (y0, x0)),
        got[rows[0]:rows[1], cols[0]:cols[1]])
    np.testing.assert_array_equal(
        cv.warp_affine_nearest(label[y0:y1, x0:x1], rot, hw, rows, cols, (y0, x0)),
        want_l[rows[0]:rows[1], cols[0]:cols[1]])


@pytest.mark.parametrize("sigma", [0.2, 0.65, 0.95], ids=["ksize1", "ksize3", "ksize3-wide"])
@pytest.mark.parametrize("hw", [(40, 50), (65, 33)])
def test_gaussian_blur_matches_cv2(hw, sigma):
    """Bit for bit, for both kernel sizes that sigma in [0, 1) gives; odd
    row lengths included (OpenCV's last value of such a row)."""
    rng = np.random.default_rng(3)
    image = _image(rng, *hw) + rng.random(hw + (3,)).astype(np.float32)
    ksize = int(3.3 * sigma)
    ksize = ksize + 1 if ksize % 2 == 0 else ksize
    want = cv2.GaussianBlur(image, (ksize, ksize), sigmaX=sigma, sigmaY=sigma,
                            borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_array_equal(cv.gaussian_blur(image, ksize, sigma), want)


class _Port(BaseDataset):
    def _set_files(self):
        self.files = [0]


class _Segtpu(SegtpuBase):
    def _set_files(self):
        self.files = [0]


def _pair(**kwargs):
    args = dict(root="", split="train", mean=[0.5] * 3, std=[0.25] * 3, **kwargs)
    return _Port(**args), _Segtpu(**args)


FLAGS = list(itertools.product([None, 48], [True, False], [True, False], [True, False],
                               [True, False]))


@pytest.mark.parametrize("crop", [33, 65], ids=["crop-inside", "crop-padded"])
@pytest.mark.parametrize("base,scale,flip,rotate,blur", FLAGS,
                         ids=lambda v: str(v))
def test_train_augmentation_matches_segtpu(base, scale, flip, rotate, blur, crop):
    """Every flag combination, a crop inside the frame and one past it (zero
    padding, class 0), three seeds and both orientations."""
    port, seg = _pair(base_size=base, scale=scale, flip=flip, rotate=rotate,
                      blur=blur, crop_size=crop)
    rng = np.random.default_rng(11)
    for hw in ((40, 50), (61, 37)):
        image, label = _image(rng, *hw), _label(rng, *hw)
        for seed in range(3):
            got_i, got_l = port._train_augmentation(image, label, random.Random(seed))
            want_i, want_l = seg._train_augmentation(image, label, random.Random(seed))
            np.testing.assert_array_equal(got_l, want_l)
            _assert_image_close(got_i, want_i)


@pytest.mark.parametrize("hw", [(40, 50), (61, 37), (33, 33)], ids=["h<w", "h>w", "square"])
@pytest.mark.parametrize("crop", [17, 33])
def test_val_augmentation_matches_segtpu(hw, crop):
    port, seg = _pair(crop_size=crop, val=True)
    rng = np.random.default_rng(5)
    image, label = _image(rng, *hw), _label(rng, *hw)
    got_i, got_l = port._val_augmentation(image, label)
    want_i, want_l = seg._val_augmentation(image, label)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_i, want_i)


def test_get_matches_segtpu_with_return_id_and_both_transports():
    """``get``: quantized to uint8, normalized on the host or not, with the
    sample id; the chain with every flag on."""
    class Port(_Port):
        def _load_data(self, index):
            return image, label, "id0"

    class Seg(_Segtpu):
        def _load_data(self, index):
            return image, label, "id0"

    rng = np.random.default_rng(2)
    image, label = _image(rng, 45, 52), _label(rng, 45, 52)
    for dev_norm in (True, False):
        args = dict(root="", split="train", mean=[0.4, 0.5, 0.6], std=[0.2, 0.25, 0.3],
                    base_size=48, rotate=True, blur=True, crop_size=33,
                    return_id=True, device_normalize=dev_norm)
        got = Port(**args).get(0, rng=random.Random(4))
        want = Seg(**args).get(0, rng=random.Random(4))
        assert got[2] == want[2] == "id0" and got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1 / 255 / 0.2 + 1e-6)
