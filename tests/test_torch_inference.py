"""The port's inference library and CLI against segtpu's on the CPU, fp32.

``sliding_predict`` and ``multi_scale_predict`` give segtpu's canvases on the
same weights (segtpu's PSPNet-R18 and UperNet-R18, BN moved off its init,
carried across by ``pspnet_state_dict_from_segtpu`` and
``upernet_state_dict_from_segtpu``) within 1e-4 of the canvas maximum; the
class maps agree wherever the top two logits are further apart than that.
The CLI, on a checkpoint written by the port's trainer, writes the class maps
of segtpu's library on the weights converted by ``MODEL_CONVERTERS``.
"""

import functools
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segtpu import inference_lib as seg_inf
from segtpu.data.synthetic import MEAN, STD
from segtpu.models.pspnet import PSPNet as SegtpuPSPNet
from segtpu.utils.weight_convert import MODEL_CONVERTERS
from segtpu_torch import inference as inference_cli
from segtpu_torch import inference_lib
from segtpu_torch.data import dataset_meta
from segtpu_torch.data.synthetic import Synthetic
from segtpu_torch.models import get_model
from segtpu_torch.ops.reductions import fast_argmax
from segtpu_torch.trainer import Trainer
from torch_parity import port_pspnet, port_upernet, segtpu_pspnet, segtpu_upernet

torch.set_num_threads(1)
CLASSES = 3
H, W = 40, 56  # tiles of 16 x 22: 20 boxes, 40 with the flip
# fp32 on both sides; the canvases sum tiles in the same order
TOL = 1e-4


@functools.cache
def _weights(arch):
    """segtpu's (model, params, batch_stats) and the port's model on the
    same weights."""
    if arch == "PSPNet":
        model, params, stats = segtpu_pspnet("resnet18", CLASSES, 33)
        return model, params, stats, port_pspnet(params, stats, "resnet18", CLASSES)
    model, params, stats = segtpu_upernet("resnet18", CLASSES, 33, 64)
    return model, params, stats, port_upernet(params, stats, "resnet18", CLASSES, 64)


@functools.cache
def _models(arch):
    """(segtpu predictor, port predictor) on the same weights."""
    model, params, stats, port = _weights(arch)
    return (seg_inf.make_predictor(model, params, stats),
            inference_lib.make_predictor(port, device="cpu"))


def _image(seed, h=H, w=W):
    return np.random.default_rng(seed).normal(size=(h, w, 3)).astype(np.float32)


def _assert_canvas_and_map(got_canvas, got_map, want_canvas):
    """Canvases within TOL of the largest logit; class maps equal wherever
    the top two logits of segtpu's canvas are more than that apart."""
    scale = np.abs(want_canvas).max()
    assert got_canvas.shape == want_canvas.shape
    assert np.abs(got_canvas - want_canvas).max() <= TOL * scale
    top2 = np.sort(want_canvas, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > TOL * scale
    assert got_map.dtype == np.int32 and got_map.shape == want_canvas.shape[:2]
    assert (got_map == want_canvas.argmax(-1))[clear].all()


def test_tile_boxes_match_segtpu():
    for h in (20, 40, 65, 97, 512, 1024):
        for w in (20, 56, 129, 700, 2048):
            for divisor, overlap in ((2.5, 1 / 3), (2.0, 0.5), (3.0, 0.25)):
                assert inference_lib._tile_boxes(h, w, divisor, overlap) == \
                    seg_inf._tile_boxes(h, w, divisor, overlap), (h, w, divisor)


@pytest.mark.parametrize("arch,flip,chunk", [
    ("PSPNet", True, 16),    # 40 tiles: chunks of 16, 16 and 8 padded to 16
    ("PSPNet", False, 16),   # 20 tiles: 16, then 4 padded to 16
    ("UperNet", True, 16),
])
def test_sliding_predict_matches_segtpu(arch, flip, chunk):
    seg_predict, port_predict = _models(arch)
    image = _image(1)
    seen = []

    def counting(x):
        seen.append(len(x))
        return port_predict(x)

    counting.device = port_predict.device
    want = seg_inf.sliding_predict(seg_predict, image, CLASSES, flip=flip,
                                   max_tile_batch=chunk)
    got = inference_lib.sliding_predict(counting, image, CLASSES, flip=flip,
                                        max_tile_batch=chunk)
    got_map = inference_lib.sliding_predict(port_predict, image, CLASSES, flip=flip,
                                            max_tile_batch=chunk, class_map=True)
    assert seen == [chunk] * (3 if flip else 2)
    _assert_canvas_and_map(got, got_map, want)


@pytest.mark.parametrize("flip", [False, True])
def test_multi_scale_predict_matches_segtpu(flip):
    seg_predict, port_predict = _models("PSPNet")
    image = _image(2)
    scales = [0.75, 1.0, 1.25]
    want = seg_inf.multi_scale_predict(seg_predict, image, scales, CLASSES, flip=flip)
    got = inference_lib.multi_scale_predict(port_predict, image, scales, CLASSES,
                                            flip=flip)
    got_map = inference_lib.multi_scale_predict(port_predict, image, scales, CLASSES,
                                                flip=flip, class_map=True)
    _assert_canvas_and_map(got, got_map, want)


def test_bucketed_predictor_crops_back():
    """Zero-padded up to multiples of 16 and cropped back: segtpu's bucketed
    logits, of the exact input's shape; bf16 autocast returns float32."""
    model, params, stats, port = _weights("PSPNet")
    x = _image(3)[None]
    want = np.asarray(seg_inf.make_predictor(model, params, stats, bucket=16)(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = inference_lib.make_predictor(port, bucket=16, device="cpu")(xt)
    exact = inference_lib.make_predictor(port, device="cpu")(xt)
    assert got.shape == exact.shape == (1, CLASSES, H, W)
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert not np.allclose(got, exact.permute(0, 2, 3, 1).numpy())  # padding is seen
    bf16 = inference_lib.make_predictor(port, compute_dtype=torch.bfloat16,
                                        device="cpu")(xt)
    assert bf16.dtype == torch.float32 and bf16.shape == exact.shape


def test_fast_argmax_takes_the_first_maximum():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0]])
    assert fast_argmax(x).tolist() == [1, 0]
    assert fast_argmax(x.t(), dim=0).tolist() == [1, 0]


def test_dataset_meta_builds_synthetic_and_refuses_on_disk_datasets():
    """Synthetic is built; the on-disk datasets answer without their data
    (tests/test_torch_datasets.py holds them against segtpu's), and refuse a
    split or a dataset they do not know."""
    cfg = {"train_loader": {"type": "Synthetic", "args": {"num_classes": 5, "size": 2}}}
    mean, std, palette, num_classes = dataset_meta(cfg)
    assert (list(mean), list(std), num_classes) == (MEAN, STD, 5)
    assert len(palette) == 15
    for name, classes in (("VOC", 21), ("COCO", 182), ("ADE20K", 150),
                          ("CityScapes", 19), ("DeepScene", 7)):
        split = {"ADE20K": "training", "DeepScene": "training",
                 "COCO": "train2017"}.get(name, "train")
        args = {"data_dir": "/nonexistent", "split": split}
        assert dataset_meta({"train_loader": {"type": name, "args": args}})[3] == classes
        with pytest.raises(ValueError, match="unknown split"):
            dataset_meta({"train_loader": {"type": name, "args": {"split": "bogus"}}})
    with pytest.raises(KeyError, match="unknown dataset"):
        dataset_meta({"train_loader": {"type": "Cityscapes", "args": {}}})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """best_model of one epoch of PSPNet-R18 by the port's trainer, and a
    directory of two RGB PNGs."""
    root = tmp_path_factory.mktemp("inference")
    synthetic = {"batch_size": 2, "num_classes": CLASSES, "crop_size": 33,
                 "num_workers": 1, "device_normalize": True}
    config = {
        "name": "TinyPSP", "seed": 0,
        "arch": {"type": "PSPNet",
                 "args": {"backbone": "resnet18", "pallas_stem_wgrad": True}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 4, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 2, "image_hw": 33, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "save_dir": str(root), "save_period": 1,
                    "log_dir": str(root / "runs"),
                    "monitor": "max Mean_IoU", "compute_dtype": "float32"},
    }
    model = get_model("PSPNet", device="cpu", num_classes=CLASSES,
                      **config["arch"]["args"])
    trainer = Trainer(model, "CrossEntropyLoss2d", config,
                      Synthetic(**config["train_loader"]["args"]),
                      Synthetic(**config["val_loader"]["args"]), device="cpu")
    trainer.train()
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(7)
    for name in ("a", "b"):
        pixels = np.clip(rng.normal(128, 60, (H, W, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(images / f"{name}.png")
    yield {"model": os.path.join(trainer.checkpoint_dir, "best_model"),
           "images": images, "palette": trainer.train_loader.dataset.palette}
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("mode", ["sliding", "multiscale"])
def test_cli_writes_segtpu_class_maps(mode, trained, tmp_path):
    out = tmp_path / "out"
    result = inference_cli.main([
        "--model", trained["model"], "--images", str(trained["images"]),
        "--output", str(out), "--extension", "png", "--mode", mode,
        "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in result["written"]) == ["a.png", "b.png"]
    sd = torch.load(os.path.join(trained["model"], "state.pt"),
                    weights_only=True)["model"]
    params, stats = MODEL_CONVERTERS["PSPNet"]({k: v.numpy() for k, v in sd.items()},
                                               arch="resnet18")
    seg_predict = seg_inf.make_predictor(
        SegtpuPSPNet(num_classes=CLASSES, backbone="resnet18"), params, stats)
    for name in ("a", "b"):
        with Image.open(trained["images"] / f"{name}.png") as image:
            rgb = np.asarray(image.convert("RGB"))
        image = (rgb.astype(np.float32) / 255.0 - np.float32(MEAN)) / np.float32(STD)
        if mode == "sliding":
            want = seg_inf.sliding_predict(seg_predict, image, CLASSES)
        else:
            want = seg_inf.multi_scale_predict(
                seg_predict, image, [0.75, 1.0, 1.25, 1.5, 1.75, 2.0], CLASSES)
        with Image.open(out / f"{name}.png") as written:
            assert written.mode == "P"
            assert written.getpalette() == \
                trained["palette"] + [0] * (768 - len(trained["palette"]))
            pixels = np.asarray(written)
        scale = np.abs(want).max()
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > TOL * scale
        assert (pixels == want.argmax(-1))[clear].all()


def test_cli_without_device_raises_without_cuda(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        inference_cli.main(["--model", trained["model"], "--images",
                            str(trained["images"]), "--output", str(tmp_path),
                            "--extension", "png"])
