"""The port's on-disk datasets and loaders against segtpu's, on tiny seeded
trees laid out as tests/test_datasets_on_disk.py lays them out: batches
(every augmentation on, and val), ``dataset_meta``, ``val_split``, thread
against process workers, the refusals, and the CPU side of the device
prefetcher. Tolerance as in tests/test_torch_data.py: labels bit-equal,
uint8 images at most 1 level apart on at most 1e-3 of the values."""

import numpy as np
import pytest
import scipy.io as sio
from PIL import Image

import segtpu.data as seg_data
import segtpu_torch.data as port_data
from segtpu import palette as seg_palette
from segtpu_torch.data import DevicePrefetcher, coco

HW = (40, 50)
AUG = dict(base_size=48, crop_size=33, augment=True, scale=True, flip=True,
           rotate=True, blur=True)


def _img(path, seed, hw=HW):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, hw + (3,)).astype(np.uint8)).save(path)


def _ids(path, seed, high, hw=HW):
    rng = np.random.default_rng(100 + seed)
    Image.fromarray(rng.integers(0, high, hw).astype(np.uint8)).save(path)


def _voc(root, aug):
    base = root / "VOCdevkit/VOC2012"
    (base / "ImageSets/Segmentation").mkdir(parents=True)
    lines = []
    for i in range(5):
        if aug:
            (base / "img").mkdir(exist_ok=True)
            (base / "cls").mkdir(exist_ok=True)
            _img(base / "img" / f"a{i}.jpg", i)
            _ids(base / "cls" / f"a{i}.png", i, 21)
            lines.append(f"/img/a{i}.jpg /cls/a{i}.png")
        else:
            (base / "JPEGImages").mkdir(exist_ok=True)
            (base / "SegmentationClass").mkdir(exist_ok=True)
            _img(base / "JPEGImages" / f"2007_{i:06d}.jpg", i)
            _ids(base / "SegmentationClass" / f"2007_{i:06d}.png", i, 21)
            lines.append(f"2007_{i:06d}")
    split = "train_aug" if aug else "train"
    (base / f"ImageSets/Segmentation/{split}.txt").write_text("\n".join(lines) + "\n")
    return dict(split=split)


def _cityscapes(root, mode):
    gt = "gtFine" if mode == "fine" else "gtCoarse"
    lbl = (root / f"{gt}_trainvaltest/{gt}/train/cityA" if mode == "fine"
           else root / f"{gt}/{gt}/train/cityA")
    img = root / "leftImg8bit_trainvaltest/leftImg8bit/train/cityA"
    img.mkdir(parents=True)
    lbl.mkdir(parents=True)
    for i in range(5):
        _img(img / f"cityA_{i:06d}_000019_leftImg8bit.png", i)
        _ids(lbl / f"cityA_{i:06d}_000019_{gt}_labelIds.png", i, 34)  # raw ids 0-33
    return dict(split="train", mode=mode)


def _ade20k(root):
    (root / "images/training").mkdir(parents=True)
    (root / "annotations/training").mkdir(parents=True)
    for i in range(5):
        _img(root / "images/training" / f"ADE_train_{i:08d}.jpg", i)
        _ids(root / "annotations/training" / f"ADE_train_{i:08d}.png", i, 151)
    return dict(split="training")


def _coco10k(root):
    for d in ("images", "annotations", "imageLists"):
        (root / d).mkdir(parents=True)
    ids = [f"COCO_train2014_{i:012d}" for i in range(5)]
    for i, name in enumerate(ids):
        _img(root / "images" / f"{name}.jpg", i)
        s = np.random.default_rng(i).integers(0, 183, size=HW).astype(np.int16)
        sio.savemat(root / "annotations" / f"{name}.mat", {"S": s})
    (root / "imageLists/train.txt").write_text("\n".join(ids) + "\n")
    return dict(split="train", partition="CocoStuff10k")


def _coco164k(root):
    (root / "images/train2017").mkdir(parents=True)
    (root / "annotations/train2017").mkdir(parents=True)
    for i in range(5):
        _img(root / "images/train2017" / f"{i:012d}.jpg", i)
        _ids(root / "annotations/train2017" / f"{i:012d}.png", i, 182)
    return dict(split="train2017", partition="CocoStuff164k")


def _deepscene(root):
    (root / "train/rgb").mkdir(parents=True)
    (root / "train/GT_color").mkdir(parents=True)
    colors = np.asarray(seg_palette.DeepScene_palette, np.uint8).reshape(-1, 3)
    for i in range(5):
        _img(root / "train/rgb" / f"b{i}.jpg", i)
        ids = np.random.default_rng(i).integers(0, len(colors), size=HW)
        Image.fromarray(colors[ids]).save(root / "train/GT_color" / f"b{i}.png")
    return dict(split="training")


TREES = {
    "VOC": ("VOC", lambda r: _voc(r, False)),
    "VOC-aug": ("VOC", lambda r: _voc(r, True)),
    "CityScapes-fine": ("CityScapes", lambda r: _cityscapes(r, "fine")),
    "CityScapes-coarse": ("CityScapes", lambda r: _cityscapes(r, "coarse")),
    "ADE20K": ("ADE20K", _ade20k),
    "COCO-10k": ("COCO", _coco10k),
    "COCO-164k": ("COCO", _coco164k),
    "DeepScene": ("DeepScene", _deepscene),
}


@pytest.fixture(scope="module", params=sorted(TREES))
def tree(request, tmp_path_factory):
    name, build = TREES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    return name, dict(data_dir=str(root), **build(root))


def _assert_batches_close(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gl, wl)
        diff = np.abs(gi.astype(np.int16) - wi.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_batches_match_segtpu(tree):
    """Train batches with every augmentation on (two epochs, shuffled), and
    val batches through the val resize with a padded tail."""
    name, args = tree
    train = dict(args, batch_size=2, shuffle=True, num_workers=2,
                 device_normalize=True, **AUG)
    port, seg = port_data.get_loader(name, **train), seg_data.get_loader(name, **train)
    for _ in range(2):
        _assert_batches_close(port, seg)
    val = dict(args, batch_size=2, crop_size=29, val=True, device_normalize=True)
    _assert_batches_close(port_data.get_loader(name, **val),
                          seg_data.get_loader(name, **val))


def test_dataset_meta_matches_segtpu(tree):
    """Without the data: the config's args minus data_dir."""
    name, args = tree
    cfg = {"train_loader": {"type": name, "args": {
        k: v for k, v in args.items() if k != "data_dir"}}}
    got, want = port_data.dataset_meta(cfg), seg_data.dataset_meta(cfg)
    assert [list(map(float, got[0])), list(map(float, got[1])), list(got[2]), got[3]] == \
        [list(map(float, want[0])), list(map(float, want[1])), list(want[2]), want[3]]


def test_val_split_matches_segtpu(tree):
    name, args = tree
    split = dict(args, batch_size=2, crop_size=33, augment=True, flip=True,
                 shuffle=False, val_split=0.4, device_normalize=True)
    port, seg = port_data.get_loader(name, **split), seg_data.get_loader(name, **split)
    np.testing.assert_array_equal(port.indices, seg.indices)
    port_val, seg_val = port.get_val_loader(), seg.get_val_loader()
    np.testing.assert_array_equal(port_val.indices, seg_val.indices)
    assert len(port_val) == len(seg_val) == 1 and len(port) == len(seg) == 1
    _assert_batches_close(port, seg)
    _assert_batches_close(port_val, seg_val)


def test_thread_and_process_workers_give_the_same_batches(tree):
    name, args = tree
    common = dict(args, batch_size=2, shuffle=True, device_normalize=False, **AUG)
    threads = port_data.get_loader(name, num_workers=3, **common)
    procs = port_data.get_loader(name, num_workers=2, worker_type="process", **common)
    try:
        assert procs._pool is not None  # forked at construction
        for _ in range(2):
            got, want = list(procs), list(threads)
            assert len(got) == len(want) == 2
            for (pi, pl), (ti, tl) in zip(got, want):
                np.testing.assert_array_equal(pi, ti)
                np.testing.assert_array_equal(pl, tl)
    finally:
        procs.close()
    assert procs._pool is None


@pytest.mark.parametrize("name,args,error", [
    ("VOC", dict(split="bogus"), ValueError),
    ("CityScapes", dict(split="train_extra"), ValueError),  # fine has no train_extra
    ("CityScapes", dict(split="train", mode="medium"), ValueError),
    ("ADE20K", dict(split="train"), ValueError),
    ("COCO", dict(split="train2017", partition="CocoStuff10k"), ValueError),
    ("COCO", dict(split="train", partition="Coco"), ValueError),
    ("DeepScene", dict(split="test"), ValueError),
    ("CityScapes", dict(split="train", crop_szie=33), TypeError),
    ("VOC", dict(split="train", mode="fine"), TypeError),
])
def test_bad_split_or_key_raises(tmp_path, name, args, error):
    with pytest.raises(error):
        port_data.get_loader(name, data_dir=str(tmp_path), batch_size=1, **args)
    with pytest.raises(KeyError):
        port_data.get_loader("Cityscapes", data_dir=str(tmp_path), batch_size=1)


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "I;16"])
def test_coco164k_label_decode_matches_cv2(tmp_path, mode):
    """segtpu reads COCO-164k labels with ``cv2.imread(GRAYSCALE)``."""
    import cv2

    rng = np.random.default_rng(0)
    path = str(tmp_path / "label.png")
    if mode == "RGB":
        Image.fromarray(rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)).save(path)
    elif mode == "P":
        img = Image.fromarray(rng.integers(0, 12, (20, 30)).astype(np.uint8), mode="P")
        img.putpalette([int(v) for v in rng.integers(0, 256, 36)])
        img.save(path)
    elif mode == "I;16":
        cv2.imwrite(path, rng.integers(0, 65536, (20, 30)).astype(np.uint16))
    else:
        Image.fromarray(rng.integers(0, 256, (20, 30)).astype(np.uint8)).save(path)
    np.testing.assert_array_equal(coco._gray_png(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(np.int32))


class _ListLoader:
    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at = batches, fail_at

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise OSError("worker failed")
            yield b


def _batches(n):
    rng = np.random.default_rng(1)
    return [(rng.integers(0, 256, (2, 5, 5, 3)).astype(np.uint8),
             rng.integers(0, 19, (2, 5, 5)).astype(np.int32)) for _ in range(n)]


def test_prefetcher_on_the_cpu_yields_the_batches_in_order():
    import torch

    batches = _batches(5)
    got = list(DevicePrefetcher(_ListLoader(batches), "cpu"))
    assert len(got) == 5 and len(DevicePrefetcher(_ListLoader(batches), "cpu")) == 5
    for (gi, gl), (wi, wl) in zip(got, batches):
        assert isinstance(gi, torch.Tensor) and gi.device.type == "cpu"
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl.numpy(), wl)


def test_prefetcher_raises_a_workers_error_and_stops_early():
    batches = _batches(4)
    it = iter(DevicePrefetcher(_ListLoader(batches, fail_at=2), "cpu"))
    next(it), next(it)
    with pytest.raises(OSError, match="worker failed"):
        next(it)
    # a consumer that leaves early lets the producer thread end
    it = iter(DevicePrefetcher(_ListLoader(_batches(6)), "cpu", depth=1))
    next(it)
    it.close()
    import threading

    assert not any(t.name == "DevicePrefetcher" and t.is_alive()
                   for t in threading.enumerate())
