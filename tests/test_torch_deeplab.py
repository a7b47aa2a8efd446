"""The port's DeepLabV3+ against segtpu's on the same weights and inputs, on
the CPU: Xception (segtpu's default backbone, full width and depth: segtpu
has no depth knob) and ResNet-18/50, output stride 8 and 16, 33 px, batch 4.

* forward in eval mode, fp32, 1e-4 relative. In train mode in float64,
  1e-8: in fp32 the BN variance formulas (E[x^2] - mean^2 in segtpu) move
  Xception's train-mode logits by 1.4e-4, and ASPP's image-pool BN
  normalizes the batch alone (ROADMAP queue 3). Xception trains at output
  stride 16 here and at 8 through its step;
* strict loading, and segtpu's ``convert_deeplab_xception`` /
  ``convert_deeplab_resnet`` giving the variables back bit for bit;
* 1 and 3 steps of AdamW under OneCycle with ``CE_DiceLoss``: parameters and
  running statistics within 1e-4 relative. The steps run in float64 on both
  sides (``segtpu_float64``): an Adam update takes about ``lr * sign(g)``
  per element, so in fp32 an element whose gradient is at the noise level
  may flip sign and move by ``2 lr``;
* ``freeze_bn``: train-mode logits are segtpu's with ``freeze_bn``, and no
  running statistic moves;
* the training CLI on Synthetic with ``"arch": {"type": "DeepLab"}``.
"""

import functools

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu import losses as seg_losses
from segtpu.core import state as seg_state
from segtpu.core.steps import make_train_step as seg_make_train_step
from segtpu.models.deeplabv3_plus import DeepLab as SegtpuDeepLab
from segtpu.utils.weight_convert import convert_deeplab_resnet, convert_deeplab_xception
from segtpu_torch import losses
from segtpu_torch import train as train_cli
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_train_step
from segtpu_torch.models import get_model
from segtpu_torch.models.deeplabv3_plus import DeepLab
from segtpu_torch.utils.weight_convert import deeplab_state_dict_from_segtpu
from torch_parity import (IdentityDropout, _init_segtpu, nchw, nhwc, no_dropout, rel_max,
                          segtpu_float64, state_dict64)

torch.set_num_threads(1)

CLASSES, HW, BATCH = 5, 33, 4
TOL = 1e-4
# the float64 runs: the same arithmetic in other orders
TOL64 = 1e-8
VARIANTS = [("xception", 16), ("xception", 8), ("resnet18", 16), ("resnet18", 8),
            ("resnet50", 16)]


@functools.cache
def _weights(backbone):
    """segtpu DeepLab variables ``(params, batch_stats)``, BN moved off its
    init; one draw per backbone, which every output stride shares (the
    stride changes no shape)."""
    _, params, stats = _init_segtpu(
        SegtpuDeepLab(num_classes=CLASSES, backbone=backbone), HW, 0)
    return params, stats


def _segtpu(backbone, output_stride, freeze_bn=False):
    """(segtpu DeepLab, params, batch_stats)."""
    return (SegtpuDeepLab(num_classes=CLASSES, backbone=backbone,
                          output_stride=output_stride, freeze_bn=freeze_bn),
            *_weights(backbone))


def _port(params, stats, backbone, output_stride, **kw):
    model = DeepLab(CLASSES, backbone=backbone, output_stride=output_stride, **kw)
    model.load_state_dict(deeplab_state_dict_from_segtpu(params, stats), strict=True)
    return model


def _sd64(params, stats):
    return state_dict64(deeplab_state_dict_from_segtpu, params, stats)


def _images(seed, hw=HW, batch=BATCH):
    return np.random.default_rng(seed).normal(size=(batch, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("backbone,output_stride", VARIANTS)
def test_eval_logits_match_segtpu(backbone, output_stride):
    model, params, stats = _segtpu(backbone, output_stride)
    x = _images(0)
    want = jax.jit(functools.partial(model.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = _port(params, stats, backbone, output_stride).eval()
    with torch.no_grad():
        got = port(nchw(x))
    assert set(got) == {"out"} and got["out"].shape == (BATCH, CLASSES, HW, HW)
    assert rel_max(nhwc(got["out"]), want["out"]) < TOL


@pytest.mark.parametrize("backbone,output_stride",
                         [v for v in VARIANTS if v != ("xception", 8)])
def test_train_logits_and_running_stats_match_segtpu(backbone, output_stride):
    """float64 on both sides: in fp32, Xception's 65 train-mode BNs, each
    taking its variance as E[x^2] - mean^2 in segtpu, move the logits by
    1.4e-4 of their largest at batch 4. Xception at output stride 8 trains
    in ``test_xception_step_matches_segtpu`` (its loss, running statistics
    and parameters), which keeps this file's JAX compiles few."""
    model, params, stats = _segtpu(backbone, output_stride)
    x = _images(1).astype(np.float64)
    with segtpu_float64():
        want, mutated = jax.jit(functools.partial(
            model.apply, train=True, mutable=["batch_stats"]))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   {"params": params, "batch_stats": stats}),
            jnp.asarray(x))
        want, mutated = jax.tree_util.tree_map(np.asarray, (want, mutated))
    port = no_dropout(_port(params, stats, backbone, output_stride)).double().train()
    got = port(nchw(x))["out"].detach().numpy().transpose(0, 2, 3, 1)
    assert rel_max(got, want["out"]) < TOL64
    want_sd = _sd64(params, mutated["batch_stats"])
    for k, v in port.state_dict().items():
        if "running_" in k:
            assert rel_max(v.numpy(), want_sd[k].numpy()) < TOL64, k


@pytest.mark.parametrize("backbone,output_stride", [("xception", 16), ("resnet18", 8),
                                                    ("resnet50", 16)])
def test_weights_load_strict_and_round_trip_through_segtpus_converter(
        backbone, output_stride):
    _, params, stats = _segtpu(backbone, output_stride)
    model = _port(params, stats, backbone, output_stride)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if backbone == "xception":
        assert "backbone.block1.rep.0.conv1.weight" in sd  # no leading ReLU
        assert "backbone.block2.rep.1.conv1.weight" in sd
        got_p, got_s = convert_deeplab_xception(sd)
    else:
        assert "backbone.layer0.0.weight" in sd
        got_p, got_s = convert_deeplab_resnet(sd, arch=backbone)
    assert {"ASSP.avg_pool.1.weight", "ASSP.conv1.weight", "decoder.output.7.bias"} <= set(sd)
    for want, got in ((params, got_p), (stats, got_s)):
        flat_w = flax.traverse_util.flatten_dict(want)
        flat_g = flax.traverse_util.flatten_dict(got)
        assert set(flat_w) == set(flat_g)
        for k in flat_w:
            np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=str(k))


def test_xception_skip_reads_the_relu_of_its_input():
    """The original's in-place first ReLU: the middle flow's identity skip
    adds relu(x), not x."""
    from segtpu_torch.backbones.xception import XceptionBlock

    block = XceptionBlock(8, 8).eval()
    x = torch.randn(1, 8, 5, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = block(x)
        rep = block.rep[1:](torch.relu(x))
    torch.testing.assert_close(y, rep + torch.relu(x), rtol=0, atol=0)
    assert block.skip is None and isinstance(block.rep[0], torch.nn.ReLU)


def test_freeze_bn_uses_and_keeps_the_running_stats(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", IdentityDropout)
    model, params, stats = _segtpu("resnet18", 16, freeze_bn=True)
    x = _images(2)
    want, mutated = model.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
    port = no_dropout(_port(params, stats, "resnet18", 16, freeze_bn=True)).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = port(nchw(x))
    assert rel_max(nhwc(got["out"]), want["out"]) < TOL
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert port.training and not any(
        m.training for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d))


def test_segtpu_freeze_bn_also_turns_dropout_off():
    """segtpu passes ``train and not freeze_bn`` to its dropouts too
    (segtpu/models/deeplabv3_plus.py:61), so two dropout keys give one
    output; the port keeps the original's ``freeze_bn()``, which freezes the
    BatchNorms only (ROADMAP queue 3)."""
    model, params, stats = _segtpu("resnet18", 16, freeze_bn=True)
    x = jnp.asarray(_images(3))
    outs = [model.apply({"params": params, "batch_stats": stats}, x, train=True,
                        rngs={"dropout": jax.random.PRNGKey(k)},
                        mutable=["batch_stats"])[0]["out"] for k in (0, 1)]
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
    port = _port(params, stats, "resnet18", 16, freeze_bn=True).train()
    got = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        with torch.no_grad():
            got.append(port(nchw(_images(3)))["out"])
    assert not torch.equal(got[0], got[1])


STEPS = 3
OPT = dict(optimizer_type="AdamW", lr=0.01, weight_decay=1e-2, scheduler_type="OneCycle",
           num_epochs=1, iters_per_epoch=10)


def _batches(steps):
    """Normalized float64 images: segtpu's jitted step divides uint8 pixels
    by 255 as XLA rewrites it, one float32 ulp off the port's division at
    some pixels, and the Adam update, about ``lr * g / (|g| + eps)``,
    magnifies the gradients' difference by up to ``lr / eps`` where a
    gradient is near 0."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        images = rng.normal(size=(BATCH, HW, HW, 3))
        labels = rng.integers(0, CLASSES, size=(BATCH, HW, HW)).astype(np.int32)
        labels[:, :5, :5] = 255
        out.append((images, labels))
    return out


def _trajectories(backbone, output_stride, steps):
    """segtpu's and the port's parameters and statistics after each update,
    both in the port's layout, as float64 numpy."""
    batches = _batches(steps)
    model, params, stats = _segtpu(backbone, output_stride)
    port = no_dropout(_port(params, stats, backbone, output_stride)).double()
    with segtpu_float64():
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), (params, stats))
        tx, _ = seg_state.make_optimizer_with_schedules(**OPT)
        jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=stats, opt_state=tx.init(params), tx=tx)
        jstep = seg_make_train_step(model, seg_losses.ce_dice_loss, CLASSES,
                                    compute_dtype=jnp.float64)
        seg_snaps = []
        for images, labels in batches:
            jstate, loss, _ = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                                    jax.random.PRNGKey(0))
            p, s = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
            seg_snaps.append((np.asarray(loss), _sd64(p, s)))
    opt, scheds = make_optimizer(port, **OPT)
    state = TrainState(port, opt, scheds)
    step = make_train_step(losses.ce_dice_loss, compute_dtype=torch.float64)
    port_snaps = []
    for images, labels in batches:
        loss, _ = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        port_snaps.append((loss.numpy(), {k: v.clone() for k, v in
                                          port.state_dict().items()}))
    return seg_snaps, port_snaps


@pytest.fixture(scope="module")
def resnet_trajectories():
    return _trajectories("resnet18", 8, STEPS)


def _assert_step_matches(seg_snap, port_snap):
    (w_loss, w_sd), (g_loss, g_sd) = seg_snap, port_snap
    assert rel_max(g_loss, w_loss) < TOL
    assert set(g_sd) == set(w_sd)
    for k, v in g_sd.items():
        if not k.endswith("num_batches_tracked"):
            assert rel_max(v.numpy(), w_sd[k].numpy()) < TOL, k


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_resnet_steps_match_segtpu(resnet_trajectories, n_steps):
    seg_snaps, port_snaps = resnet_trajectories
    _assert_step_matches(seg_snaps[n_steps - 1], port_snaps[n_steps - 1])


def test_xception_step_matches_segtpu():
    seg_snaps, port_snaps = _trajectories("xception", 8, 1)
    _assert_step_matches(seg_snaps[0], port_snaps[0])


@pytest.mark.parametrize("backbone", ["xception", "resnet18"])
def test_training_cli_trains_deeplab_on_cpu(backbone, tmp_path):
    synthetic = {"batch_size": 2, "num_classes": 3, "crop_size": 33,
                 "num_workers": 1, "device_normalize": True}
    config = {
        "name": "TinyDeepLab", "seed": 0,
        "arch": {"type": "DeepLab", "args": {"backbone": backbone, "output_stride": 16,
                                             "freeze_bn": False}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 4, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 2, "image_hw": 33, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "AdamW", "differential_lr": True,
                      "args": {"lr": 0.001, "weight_decay": 1e-2, "betas": [0.9, 0.99]}},
        "loss": "CE_DiceLoss", "ignore_index": 255,
        "lr_scheduler": {"type": "OneCycle", "args": {}},
        "trainer": {"epochs": 1, "log_per_iter": 1, "val": True,
                    "monitor": "max Mean_IoU", "compute_dtype": "float32",
                    "save_dir": str(tmp_path)},
    }
    trainer = train_cli.main(config, "cpu")
    assert isinstance(trainer.model, DeepLab) and trainer.state.step == 2
    log = trainer.history[-1]
    assert np.isfinite(log["loss"]) and np.isfinite(log["val_loss"])
    assert 0.0 <= log["Mean_IoU"] <= 1.0


def test_get_model_builds_deeplab_from_a_seed():
    a = get_model("DeepLab", device="cpu", seed=3, num_classes=3, backbone="resnet18")
    b = get_model("DeepLab", device="cpu", seed=3, num_classes=3, backbone="resnet18")
    assert a.backbone_modules == ("backbone",)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeepLab(3, pretrained=True)
