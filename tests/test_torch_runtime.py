"""The rest of the trainer's runtime against segtpu's, on the CPU: the event
writer (``segtpu_torch/utils/tensorboard.py``), the Trainer's events and
val grid, ``profile``, ``Logger``, ``summary``, ``transforms`` and
``eval_metrics``.

* The writer: scalars and images written by the port and by tensorboardX's
  ``SummaryWriter`` for the same calls, read back by tensorboard's
  ``EventAccumulator`` (which checks the CRCs): the same tags, steps and
  values, and images that decode to the same pixels.
* The Trainer: one run of each framework's Trainer, PSPNet-R18 at 33 px,
  two iterations and one validation epoch of two batches, uint8
  transport, fp32, dropout the identity on both sides, on the same weights
  and batches. Poly's last rate is 0, so the second update leaves the
  weights as the first left them. The (tag, step) lists are equal; the
  learning rates within 1e-12; the losses within 1e-4 relative (the step
  parity tolerance of ``torch_zoo.py``); mIoU and pixel accuracy, which
  both frameworks round to 3 places, within one unit of that rounding. The
  grid has segtpu's size, its input and target columns are equal bit for
  bit, and its prediction column is equal where segtpu's top-two logit
  margin exceeds 1e-4 of its largest logit (the rule of
  ``test_torch_inference.py``).
* Transforms: each against segtpu's with the same ``random.Random(seed)``
  (the generators' states equal after the call). Masks and crops bit for
  bit; float32 images bit for bit through the resizes, and through the
  linear warp within one level once quantized to uint8 on at most 1e-3 of
  the values (``tests/test_torch_data.py``'s rule for ``cv.py``); uint8
  images, which OpenCV resizes in fixed point and the port in float32,
  within one level.
"""

import glob
import json
import os
import random
import signal
import sys
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segtpu import metrics as seg_metrics
from segtpu.data import Synthetic as SegtpuSynthetic
from segtpu.models import get_model as seg_get_model
from segtpu.models.pspnet import PSPNet as SegtpuPSPNet
from segtpu.trainer import Trainer as SegtpuTrainer
from segtpu.utils import logger as seg_logger
from segtpu.utils import summary as seg_summary
from segtpu.utils import transforms as ST
import segtpu.backbones.vgg as segtpu_vgg
from segtpu_torch import metrics
import segtpu_torch.backbones.vgg as port_vgg
from segtpu_torch.data import Synthetic
from segtpu_torch.models import get_model
from segtpu_torch.trainer import Trainer
from segtpu_torch.utils import logger, summary
from segtpu_torch.utils import tensorboard as tb
from segtpu_torch.utils import transforms as PT
from segtpu_torch.utils.weight_convert import pspnet_state_dict_from_segtpu
from torch_parity import IdentityDropout, no_dropout

torch.set_num_threads(1)

CLASSES, CROP = 3, 33
TOL = 1e-4
GRID_TAG = "val/inputs_targets_predictions"


def _accumulate(logdir):
    """tensorboard's reader over ``logdir``. The ``notf`` marker makes it
    read through its own record reader (which checks both CRCs of every
    record) rather than import TensorFlow."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(logdir, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    return acc


def _decode(png: bytes) -> np.ndarray:
    import io

    with Image.open(io.BytesIO(png)) as image:
        return np.asarray(image)


# -- the writer -------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 9, 1023, 8 * 1024 - 1, 8 * 1024, 50_001])
def test_crc32c_is_tensorboardxs(n):
    from tensorboardX.crc32c import crc32c

    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tb.crc32c(data) == crc32c(data)


def test_writer_round_trip_equals_tensorboardx(tmp_path):
    from tensorboardX import SummaryWriter as TensorboardX

    rng = np.random.default_rng(0)
    calls = [("scalar", "train/loss", 1.25, 1), ("scalar", "train/loss", 0.1, 2),
             ("scalar", "val/Mean_IoU", 0.0, 0), ("scalar", "lr", 3e-7, 123456789),
             ("image", "grid", rng.random((3, 40, 60)), 1),
             ("image", "grid", rng.random((3, 300, 200), dtype=np.float32), 2),
             ("image", "mask", rng.integers(0, 256, (3, 7, 5), np.uint8), 0)]
    for name, cls in (("port", tb.SummaryWriter), ("tbx", TensorboardX)):
        writer = cls(str(tmp_path / name))
        for kind, tag, value, step in calls:
            (writer.add_scalar if kind == "scalar" else writer.add_image)(tag, value, step)
        writer.close()
    port, tbx = _accumulate(str(tmp_path / "port")), _accumulate(str(tmp_path / "tbx"))
    assert port.Tags()["scalars"] == tbx.Tags()["scalars"] == ["train/loss", "val/Mean_IoU",
                                                               "lr"]
    assert port.Tags()["images"] == tbx.Tags()["images"] == ["grid", "mask"]
    for tag in port.Tags()["scalars"]:
        assert ([(e.step, e.value) for e in port.Scalars(tag)]
                == [(e.step, e.value) for e in tbx.Scalars(tag)])
    for tag in port.Tags()["images"]:
        got, want = port.Images(tag), tbx.Images(tag)
        assert [(e.step, e.height, e.width) for e in got] == [(e.step, e.height, e.width)
                                                              for e in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_decode(g.encoded_image_string),
                                          _decode(w.encoded_image_string))
    events = tb.read_events(glob.glob(str(tmp_path / "port" / "events.out.tfevents.*"))[0])
    assert events[0]["file_version"] == "brain.Event:2"
    assert [(v["tag"], e["step"]) for e in events[1:] for v in e["values"]] == [
        (tag, step) for _, tag, _, step in calls]


# -- the Trainer against segtpu's ---------------------------------------------

def _config(root, framework):
    synthetic = {"batch_size": 2, "num_classes": CLASSES, "crop_size": CROP,
                 "num_workers": 1, "device_normalize": True}
    trainer = {"epochs": 1, "log_per_iter": 1, "val": True, "save_period": 10,
               "monitor": "max Mean_IoU", "compute_dtype": "float32",
               "save_dir": str(root / framework / "saved"),
               "log_dir": str(root / framework / "runs")}
    if framework == "segtpu":
        trainer.update(devices=1, progress_bar=False)
    else:
        trainer.update(profile=2)
    return {
        "name": "TinyEvents", "seed": 0,
        "arch": {"type": "PSPNet", "args": {"backbone": "resnet18"}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 4, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 4, "image_hw": CROP, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": trainer,
    }


def _events(trainer_log_dir):
    path, = glob.glob(os.path.join(trainer_log_dir, "*", "*", "events.out.tfevents.*"))
    return os.path.dirname(path), tb.read_events(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("events")
    seg_cfg, port_cfg = _config(root, "segtpu"), _config(root, "port")
    seg_model = SegtpuPSPNet(num_classes=CLASSES, backbone="resnet18")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", IdentityDropout)
        seg = SegtpuTrainer(seg_model, "CrossEntropyLoss2d", seg_cfg,
                            SegtpuSynthetic(**seg_cfg["train_loader"]["args"]),
                            SegtpuSynthetic(**seg_cfg["val_loader"]["args"]))
        params, stats = jax.tree_util.tree_map(np.asarray, (seg.state.params,
                                                            seg.state.batch_stats))
        seg.train()
        seg.writer.close()  # segtpu leaves tensorboardX's writer open
    model = get_model("PSPNet", device="cpu", num_classes=CLASSES, backbone="resnet18")
    model.load_state_dict(pspnet_state_dict_from_segtpu(params, stats), strict=True)
    port = Trainer(no_dropout(model), "CrossEntropyLoss2d", port_cfg,
                   Synthetic(**port_cfg["train_loader"]["args"]),
                   Synthetic(**port_cfg["val_loader"]["args"]), device="cpu")
    port.train()
    # segtpu's logits for the grid's images, from its trained state
    val = SegtpuSynthetic(**seg_cfg["val_loader"]["args"])
    images = np.stack([batch[0][0] for batch in val])
    x = (images.astype(np.float32) / 255.0 - np.float32(val.dataset.mean)) / np.float32(
        val.dataset.std)
    logits = np.asarray(seg_model.apply({"params": seg.state.params,
                                         "batch_stats": seg.state.batch_stats},
                                        jnp.asarray(x), train=False)["out"])
    return {"segtpu": _events(seg_cfg["trainer"]["log_dir"]),
            "port": _events(port_cfg["trainer"]["log_dir"]), "logits": logits,
            "trainer": port}


def test_trainer_writes_segtpus_tags_at_segtpus_steps(runs):
    def tag_steps(events):
        return [(v["tag"], e["step"]) for e in events[1:] for v in e["values"]]

    want = tag_steps(runs["segtpu"][1])
    assert tag_steps(runs["port"][1]) == want
    assert want == [("train/loss", 1), ("train/loss", 2), ("train/Pixel_Accuracy", 2),
                    ("train/Mean_IoU", 2), ("train/Learning_rate_0", 2),
                    ("train/Learning_rate_1", 2), (GRID_TAG, 1), ("val/loss", 2),
                    ("val/Pixel_Accuracy", 2), ("val/Mean_IoU", 2)]


def test_trainer_scalars_match_segtpus(runs):
    """Read back by tensorboard's reader: the rates to 1e-12, the losses to
    the step tolerance, the rounded metrics within one unit of rounding."""
    port, seg = _accumulate(runs["port"][0]), _accumulate(runs["segtpu"][0])
    assert port.Tags()["scalars"] == seg.Tags()["scalars"]
    for tag in seg.Tags()["scalars"]:
        got, want = port.Scalars(tag), seg.Scalars(tag)
        assert [e.step for e in got] == [e.step for e in want]
        for g, w in zip(got, want):
            if "Learning_rate" in tag:
                assert abs(g.value - w.value) <= 1e-12, tag
            elif tag.endswith("loss"):
                assert abs(g.value - w.value) <= TOL * abs(w.value), tag
            else:
                assert abs(g.value - w.value) <= 1e-3 + 1e-7, tag


def test_val_grid_matches_segtpus(runs):
    port, seg = _accumulate(runs["port"][0]), _accumulate(runs["segtpu"][0])
    (got,), (want,) = port.Images(GRID_TAG), seg.Images(GRID_TAG)
    assert (got.step, got.height, got.width) == (want.step, want.height, want.width) == (
        1, 2 * CROP, 3 * CROP)
    got, want = _decode(got.encoded_image_string), _decode(want.encoded_image_string)
    np.testing.assert_array_equal(got[:, :2 * CROP], want[:, :2 * CROP])
    logits = runs["logits"]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > TOL * np.abs(logits).max()).reshape(-1, CROP)
    assert clear.mean() > 0.9
    pred_got, pred_want = got[:, 2 * CROP:], want[:, 2 * CROP:]
    assert (pred_got == pred_want).all(-1)[clear].all()


def test_profile_writes_a_chrome_trace(runs):
    path, = glob.glob(os.path.join(runs["trainer"].checkpoint_dir, "profile", "*.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_profile_trace_survives_a_sigterm_inside_the_traced_window(tmp_path):
    """A SIGTERM during the second of three traced steps: the run stops
    after writing checkpoint-latest, and the trace is whole JSON."""
    cfg = _config(tmp_path, "port")
    cfg["trainer"].update(tensorboard=False, profile=3, val=False)
    cfg["train_loader"]["args"]["size"] = 8
    trainer = Trainer(get_model("PSPNet", device="cpu", num_classes=CLASSES,
                                backbone="resnet18"), "CrossEntropyLoss2d", cfg,
                      Synthetic(**cfg["train_loader"]["args"]), device="cpu")
    step, calls = trainer.train_step, []

    def killed_step(*args):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*args)

    trainer.train_step = killed_step
    trainer.train()
    assert trainer.preempted is not None and len(calls) == 2
    path, = glob.glob(os.path.join(trainer.checkpoint_dir, "profile", "*.json"))
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv" in n for n in names)
    assert os.path.isdir(os.path.join(trainer.checkpoint_dir, "checkpoint-latest"))


def test_grid_of_normalized_images_is_segtpus():
    """The denormalize path (no uint8 transport), through both trainers'
    own grid methods on the same batch."""
    rng = np.random.default_rng(3)
    dataset = Synthetic(batch_size=2, size=2, num_classes=CLASSES, crop_size=CROP,
                        image_hw=CROP, val=True, augment=False).dataset
    viz = [(rng.normal(size=(CROP, CROP, 3)).astype(np.float32),
            np.where(rng.random((CROP, CROP)) < 0.1, -100,
                     rng.integers(0, CLASSES, (CROP, CROP))),
            rng.integers(0, CLASSES, (CROP, CROP))) for _ in range(2)]
    grids = []
    for cls in (SegtpuTrainer, Trainer):
        written = []
        fake = types.SimpleNamespace(
            val_loader=types.SimpleNamespace(dataset=dataset),
            writer=types.SimpleNamespace(add_image=lambda *a: written.append(a)))
        cls._write_val_grid(fake, viz, 4)
        grids.append(written)
    (tag_g, grid_g, step_g), = grids[1]
    (tag_w, grid_w, step_w), = grids[0]
    assert (tag_g, step_g) == (tag_w, step_w) and grid_g.dtype == grid_w.dtype
    np.testing.assert_array_equal(grid_g, grid_w)


# -- Logger, summary, eval_metrics ------------------------------------------------

def test_logger_is_segtpus():
    entries = [{"epoch": 1, "loss": 0.5, "Class_IoU": {0: np.float64(0.25)}},
               {"epoch": 2, "val_loss": np.float32(1.5), "note": object.__name__}]
    got, want = logger.Logger(), seg_logger.Logger()
    for e in entries:
        got.add_entry(e)
        want.add_entry(e)
    assert str(got) == str(want) and got.entries == want.entries


SUMMARY_MODELS = {"PSPNet": {"backbone": "resnet18"}, "ENet": {}, "UNet": {},
                  "UperNet": {"backbone": "resnet18", "fpn_out": 16}, "FCN8": {}}


@pytest.mark.parametrize("name", sorted(SUMMARY_MODELS))
def test_summary_totals_are_segtpus(name, monkeypatch):
    """The parameter total and the BN statistics' count equal segtpu's on
    the same model (its variables' shapes from tracing its init, as
    zeros); FCN8 on narrowed VGG stages, its fixed upsampling kernels
    counted nowhere."""
    if name == "FCN8":
        narrow = ((8, 8), (8, 8), (16, 16, 16), (16, 16, 16), (16, 16, 16))
        monkeypatch.setattr(segtpu_vgg, "VGG16_STAGES", narrow)
        monkeypatch.setattr(port_vgg, "VGG16_STAGES", narrow)
    model = get_model(name, device="cpu", num_classes=CLASSES, **SUMMARY_MODELS[name])
    seg_model = seg_get_model(name, num_classes=CLASSES, **SUMMARY_MODELS[name])
    shapes = jax.eval_shape(lambda k, x: seg_model.init({"params": k, "dropout": k}, x,
                                                        train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params, stats = (jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                            shapes.get(k, {}))
                     for k in ("params", "batch_stats"))
    assert summary.count_params(model) == seg_summary.count_params(params)
    assert summary.count_bn_stats(model) == seg_summary.count_params(stats)
    got, want = summary.summary(model), seg_summary.summary(params, stats)
    assert got.split("Trainable params")[1] == want.split("Trainable params")[1]
    assert summary.describe(model) == seg_summary.describe(seg_model, params)


def test_eval_metrics_is_segtpus():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 4, 9, 11)).astype(np.float32)
    target = rng.integers(0, 4, (2, 9, 11)).astype(np.int32)
    target[:, :2] = 255
    got = metrics.eval_metrics(torch.from_numpy(logits), torch.from_numpy(target), 4)
    want = seg_metrics.eval_metrics(jnp.asarray(logits.transpose(0, 2, 3, 1)),
                                    jnp.asarray(target), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- transforms ---------------------------------------------------------------------

def _pair(dtype, h=40, w=60, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    else:
        img = (rng.integers(0, 256, (h, w, 3)) + rng.random((h, w, 3))).astype(np.float32)
    mask = rng.integers(0, 5, (h, w)).astype(np.int32)
    mask[rng.random((h, w)) < 0.1] = 255
    return img, mask


def _assert_image(got, want, dtype, exact):
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact and dtype == np.float32:
        np.testing.assert_array_equal(got, want)
        return
    g = np.asarray(got, np.float32).astype(np.uint8).astype(np.int16)
    w = np.asarray(want, np.float32).astype(np.uint8).astype(np.int16)
    diff = np.abs(g - w)
    assert diff.max() <= 1, diff.max()
    if dtype == np.float32:
        assert (diff > 0).mean() <= 1e-3


TRANSFORMS = {
    # name: (the transform from a module, float32 images bit for bit, size)
    "compose-crop-flip": (lambda T: T.Compose([T.RandomCrop(32), T.RandomHorizontallyFlip()]),
                          True, (40, 60)),
    "crop-padded": (lambda T: T.RandomCrop((30, 50), padding=3), True, (40, 60)),
    "crop-upscale": (lambda T: T.RandomCrop(64), True, (40, 60)),
    "center-crop": (lambda T: T.CenterCrop((21, 30)), True, (40, 60)),
    "flip": (lambda T: T.RandomHorizontallyFlip(), True, (40, 60)),
    "scale-wide": (lambda T: T.Scale(45), True, (40, 60)),
    "scale-tall": (lambda T: T.Scale(50), True, (60, 37)),
    "sized-crop": (lambda T: T.RandomSizedCrop(24), True, (40, 60)),
    "sized-crop-fallback": (lambda T: T.RandomSizedCrop(24, attempts=0), True, (40, 60)),
    "rotate": (lambda T: T.RandomRotate(10), False, (40, 60)),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_is_segtpus(name, dtype):
    build, exact, (h, w) = TRANSFORMS[name]
    for seed in range(4):
        img, mask = _pair(dtype, h, w, seed)
        r_got, r_want = random.Random(seed), random.Random(seed)
        gi, gm = build(PT)(img, mask, r_got)
        wi, wm = build(ST)(img, mask, r_want)
        assert r_got.getstate() == r_want.getstate()
        assert gm.dtype == wm.dtype
        np.testing.assert_array_equal(gm, wm)
        _assert_image(gi, wi, dtype, exact)


def test_sliding_crop_and_denormalize_are_segtpus():
    img, mask = _pair(np.float32, 70, 90)
    got, want = PT.SlidingCrop(32, 2 / 3., 255)(img, mask), ST.SlidingCrop(32, 2 / 3., 255)(
        img, mask)
    assert got[2] == want[2]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
    small = PT.SlidingCrop(64, 0.5, 255)(img[:40, :50], mask[:40, :50])
    np.testing.assert_array_equal(small[1][0], ST.SlidingCrop(64, 0.5, 255)(
        img[:40, :50], mask[:40, :50])[1][0])
    mean, std = (0.4, 0.45, 0.5), (0.2, 0.25, 0.3)
    np.testing.assert_array_equal(PT.DeNormalize(mean, std)(img),
                                  ST.DeNormalize(mean, std)(img))
