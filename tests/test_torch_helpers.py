"""The port's host-side helpers against segtpu's on the CPU.

``colorize_mask`` gives segtpu's palette image (the same indices and the
palette padded to 768 values); ``load_rgb`` reads PNGs of every colour type,
and other formats, to the RGB array segtpu's inference CLI decodes;
``denormalize`` inverts the loaders' normalization.
"""

import numpy as np
import pytest
from PIL import Image

from segtpu.utils import helpers as seg_helpers
from segtpu_torch.palette import generated_palette
from segtpu_torch.utils.helpers import colorize_mask, denormalize, load_rgb


@pytest.mark.parametrize("classes", [7, 19, 256])
def test_colorize_mask_is_segtpus(classes, tmp_path):
    mask = np.random.default_rng(classes).integers(0, classes, (33, 45))
    palette = generated_palette(classes)
    got, want = colorize_mask(mask, palette), seg_helpers.colorize_mask(mask, palette)
    assert got.mode == want.mode == "P"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.getpalette() == want.getpalette()
    assert len(got.getpalette()) == 768
    got.save(tmp_path / "port.png")
    with Image.open(tmp_path / "port.png") as back:
        np.testing.assert_array_equal(np.asarray(back), mask)
        assert back.getpalette()[:len(palette)] == palette


@pytest.mark.parametrize("mode,ext", [("L", "png"), ("RGB", "png"), ("RGBA", "png"),
                                      ("P", "png"), ("RGB", "bmp")])
def test_load_rgb_reads_what_segtpus_cli_reads(mode, ext, tmp_path):
    rng = np.random.default_rng(len(mode))
    shape = (12, 17) if mode in ("L", "P") else (12, 17, len(mode))
    image = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)
    if mode == "P":
        image.putpalette(generated_palette(256))
    path = tmp_path / f"a.{ext}"
    image.save(path)
    got = load_rgb(str(path))
    assert got.dtype == np.uint8 and got.shape == (12, 17, 3)
    with Image.open(path) as ref:
        np.testing.assert_array_equal(got, np.asarray(ref.convert("RGB")))


def test_denormalize_inverts_the_loaders_normalization():
    rgb = np.random.default_rng(5).random((6, 7, 3)).astype(np.float32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    x = (rgb - np.float32(mean)) / np.float32(std)
    np.testing.assert_allclose(denormalize(x, mean, std), rgb, atol=1e-6)
    np.testing.assert_allclose(denormalize(x * 10, mean, std),
                               seg_helpers.denormalize(x * 10, mean, std))
    assert denormalize(x * 10, mean, std).min() >= 0.0
    assert denormalize(x * 10, mean, std).max() <= 1.0
