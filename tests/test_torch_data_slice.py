"""The data slice as a whole, on the CPU: two SGD steps of PSPNet-ResNet18
fed by segtpu's CityScapes loader and by the port's from one tiny tree
(scale, rotate, blur and flip on), from one seed's weights through the
converter; and the port's training CLI on a CityScapes tree, then its
inference CLI on the checkpoint that run wrote.

Tolerance as tests/test_torch_step.py: every parameter, running stat and
the loss within 1e-4 relative. The two steps run in float64 on both sides:
in float32 the frameworks' first updates agree to 1e-5, and on these
CityScapes-like labels the second update amplifies that to 1.4e-4 to 1.1e-3
at batch 4, 8 or 16, on identical batches too (the port's own second update
moves 2e-2 when its first is perturbed by 1e-5), so float32 would test the
conditioning of two steps of SGD, not the loaders.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segtpu import losses as seg_losses
from segtpu.core import state as seg_state
from segtpu.core.steps import make_train_step as seg_make_train_step
from segtpu.data import CityScapes as SegtpuCityScapes
from segtpu.utils.weight_convert import convert_pspnet
from segtpu_torch import inference as inference_cli
from segtpu_torch import losses
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_train_step
from segtpu_torch.data import CityScapes
from torch_parity import IdentityDropout, no_dropout, port_pspnet, rel_max, segtpu_pspnet

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CLASSES, CROP, BATCH, STEPS = 5, 65, 4, 2
OPT = dict(lr=0.01, num_epochs=1, iters_per_epoch=10)
TOL = 1e-4
# raw CityScapes ids: 7, 8, 11, 12 and 13 are train ids 0-4, the rest of
# 0-6 are ignored (255), so five classes suffice
RAW_IDS = np.array([0, 1, 4, 6, 7, 8, 11, 12, 13])


def cityscapes_tree(root, frames, hw=(60, 80), block=10, split="train"):
    """A CityScapes fine tree of ``frames`` seeded frames: RGB noise over
    ``block``-pixel squares of raw label ids."""
    img_dir = root / "leftImg8bit_trainvaltest/leftImg8bit" / split / "cityA"
    lbl_dir = root / "gtFine_trainvaltest/gtFine" / split / "cityA"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)
    for i in range(frames):
        rng = np.random.default_rng(i)
        blocks = RAW_IDS[rng.integers(0, len(RAW_IDS), (hw[0] // block, hw[1] // block))]
        raw = np.repeat(np.repeat(blocks, block, 0), block, 1).astype(np.uint8)
        rgb = np.clip(raw[..., None] * 15.0 + rng.normal(0, 30, hw + (3,)), 0, 255)
        Image.fromarray(rgb.astype(np.uint8)).save(
            img_dir / f"cityA_{i:06d}_000019_leftImg8bit.png")
        Image.fromarray(raw).save(lbl_dir / f"cityA_{i:06d}_000019_gtFine_labelIds.png")
    return root


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """Snapshots after each update: segtpu's step on segtpu's batches, the
    port's step on the port's batches."""
    root = cityscapes_tree(tmp_path_factory.mktemp("cs"), BATCH * STEPS)
    args = dict(data_dir=str(root), batch_size=BATCH, split="train", base_size=72,
                crop_size=CROP, augment=True, scale=True, flip=True, rotate=True,
                blur=True, shuffle=True, num_workers=2, device_normalize=True)
    seg_loader, port_loader = SegtpuCityScapes(**args), CityScapes(**args)
    norm = (seg_loader.MEAN, seg_loader.STD)
    seg_batches, port_batches = list(seg_loader), list(port_loader)
    assert len(seg_batches) == len(port_batches) == STEPS
    model, params, stats = segtpu_pspnet("resnet18", CLASSES, CROP, seed=3)
    port = no_dropout(port_pspnet(params, stats, "resnet18", CLASSES)).double()
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, "Dropout", IdentityDropout)
            params, stats = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), (params, stats))
            tx = seg_state.make_optimizer(**OPT)
            jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                          batch_stats=stats, opt_state=tx.init(params),
                                          tx=tx)
            jstep = seg_make_train_step(model, seg_losses.cross_entropy, CLASSES,
                                        compute_dtype=jnp.float64, norm_stats=norm)
            # the state the step returns, cast as it returns it, so that
            # both steps run one compiled program
            out = jax.eval_shape(jstep, jstate, *seg_batches[0], jax.random.PRNGKey(0))[0]
            jstate = jax.tree_util.tree_map(lambda a, o: jnp.asarray(a, o.dtype),
                                            jstate, out)
            seg_snaps = []
            for images, labels in seg_batches:
                jstate, loss, _ = jstep(jstate, jnp.asarray(images),
                                        jnp.asarray(labels), jax.random.PRNGKey(0))
                seg_snaps.append(jax.tree_util.tree_map(
                    np.asarray, (loss, jstate.params, jstate.batch_stats)))
    finally:
        jax.config.update("jax_enable_x64", x64)
    opt, scheds = make_optimizer(port, **OPT)
    state = TrainState(port, opt, scheds)
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float64,
                           norm_stats=(port_loader.MEAN, port_loader.STD))
    port_snaps = []
    for images, labels in port_batches:
        loss, _ = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
        port_snaps.append((loss.numpy(),) + convert_pspnet(sd, arch="resnet18"))
    return seg_batches, port_batches, seg_snaps, port_snaps


def test_the_two_loaders_give_the_same_batches(trajectories):
    seg_batches, port_batches, _, _ = trajectories
    for (si, sl), (pi, pl) in zip(seg_batches, port_batches):
        np.testing.assert_array_equal(pl, sl)
        assert set(np.unique(pl)) <= set(range(CLASSES)) | {255}
        diff = np.abs(pi.astype(np.int16) - si.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_steps_fed_by_the_two_loaders_match(trajectories, n_steps):
    _, _, seg_snaps, port_snaps = trajectories
    w_loss, w_params, w_stats = seg_snaps[n_steps - 1]
    g_loss, g_params, g_stats = port_snaps[n_steps - 1]
    assert rel_max(g_loss, w_loss) < TOL
    for want, got in ((w_params, g_params), (w_stats, g_stats)):
        flat_w = flax.traverse_util.flatten_dict(want)
        flat_g = flax.traverse_util.flatten_dict(got)
        assert set(flat_w) == set(flat_g)
        for k in flat_w:
            assert rel_max(flat_g[k], flat_w[k]) < TOL, k


def test_cli_trains_from_a_cityscapes_tree_and_infers(tmp_path):
    """``python -m segtpu_torch.train --device cpu`` on a CityScapes tree,
    its val loader taken from ``val_split``; then the inference CLI on the
    run's best_model, whose config names CityScapes."""
    root = cityscapes_tree(tmp_path / "cs", 4)
    config = {
        "name": "TinyCityScapes", "seed": 0,
        "arch": {"type": "PSPNet", "args": {"backbone": "resnet18"}},
        "train_loader": {"type": "CityScapes", "args": {
            "data_dir": str(root), "batch_size": 2, "split": "train",
            "base_size": 40, "crop_size": 33, "augment": True, "scale": True,
            "flip": True, "rotate": True, "blur": True, "shuffle": True,
            "num_workers": 2, "val_split": 0.5, "worker_type": "process"}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "save_dir": str(tmp_path / "saved"), "save_period": 1,
                    "monitor": "max Mean_IoU", "compute_dtype": "float32",
                    "log_per_iter": 1},
    }
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    res = subprocess.run([sys.executable, "-m", "segtpu_torch.train", "--config",
                          str(cfg), "--device", "cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "TRAIN epoch 1" in res.stderr and "VAL   epoch 1" in res.stderr
    (best,) = (tmp_path / "saved" / "TinyCityScapes").glob("*/best_model")
    images = root / "leftImg8bit_trainvaltest/leftImg8bit/train/cityA"
    result = inference_cli.main([
        "--model", str(best), "--images", str(images), "--output",
        str(tmp_path / "out"), "--extension", "png", "--mode", "sliding",
        "--device", "cpu"])
    assert len(result["written"]) == 4
    with Image.open(result["written"][0]) as written:
        assert written.mode == "P" and written.size == (80, 60)
        assert np.asarray(written).max() < 19
