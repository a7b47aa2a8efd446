"""segtpu's memory and stem knobs in the port, on the CPU, one process:

* ``trainer.remat`` (the whole forward under ``torch.utils.checkpoint``)
  and PSPNet's ``remat_backbone`` (each residual block) leave the float64
  gradients, the loss and every running statistic as they are without
  them (REMAT_TOL relative to each tensor's largest value), and the
  recompute counts no second BN update;
* ``s2d_stem_conv`` against segtpu's for k 3 and 7 at odd and even sizes
  (``tests/test_s2d.py``'s cases), forward and both gradients, float64 on
  both sides (S2D_TOL); with explicit H padding, each band of an image is
  the whole conv's rows; ``PSPNet(s2d_stem=True)`` gives the plain model's
  logits on the same weights, and the Trainer's config reaches it;
* ``multi_grid``: the dilation plan against segtpu's ``_layer_plan``, and
  ``ResNetFeatures(multi_grid=True)``'s eval-mode stage outputs against
  segtpu's on the same weights (float64, TOL64);
* the stem kernel's plain version with explicit padding: the dW of an
  image's bands, each with its halo rows, sum to the whole image's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segtpu.backbones import resnet as seg_resnet
from segtpu.ops.s2d import s2d_stem_conv as seg_s2d_stem_conv
from segtpu.utils.weight_convert import MODEL_CONVERTERS
from segtpu_torch import losses
from segtpu_torch.backbones.resnet import ResNetFeatures, _layer_plan
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_train_step
from segtpu_torch.models import get_model
from segtpu_torch.ops import conv_wgrad as cw
from segtpu_torch.ops.s2d import s2d_stem_conv
from torch_parity import nchw, no_dropout, rel_max, segtpu_float64
from torch_zoo import SGD, TOL64, batches

torch.set_num_threads(1)
# float64, the same arithmetic in other orders (remat recomputes the same
# ops, so it is exact in practice; the bound leaves room for a reordering)
REMAT_TOL = 1e-10
S2D_TOL = 1e-12
CLASSES = 5


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW torch -> NHWC numpy, in the tensor's own dtype."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _grads_and_buffers(model, x, y, remat=False):
    """One float64 SGD step: (loss, every gradient, every buffer)."""
    opt, scheds = make_optimizer(model, **SGD)
    state = TrainState(model, opt, scheds)
    grads = {}
    for n, p in model.named_parameters():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float64, remat=remat)
    loss, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
    return float(loss), grads, {k: v.clone() for k, v in model.named_buffers()}


def _pspnet(**kw):
    return no_dropout(get_model("PSPNet", device="cpu", seed=1, num_classes=CLASSES,
                                backbone="resnet18", **kw)).double()


@pytest.mark.parametrize("knobs", [{"remat": True}, {"remat_backbone": True},
                                   {"remat": True, "remat_backbone": True}],
                         ids=["trainer.remat", "remat_backbone", "both"])
def test_remat_changes_neither_gradients_nor_running_stats(knobs):
    (x, y), = batches(1, 33, 2, CLASSES)
    loss, grads, buffers = _grads_and_buffers(_pspnet(), x, y)
    model = _pspnet(remat_backbone=knobs.get("remat_backbone", False))
    assert model.layer1[0].remat == knobs.get("remat_backbone", False)
    r_loss, r_grads, r_buffers = _grads_and_buffers(model, x, y, knobs.get("remat", False))
    assert abs(r_loss - loss) <= REMAT_TOL * abs(loss)
    assert set(grads) == set(r_grads) and len(grads) > 0
    for n, g in grads.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((r_grads[n] - g).abs().max()) <= REMAT_TOL * scale, n
    for n, b in buffers.items():
        if n.endswith("num_batches_tracked"):  # one update, not one a replay
            assert int(r_buffers[n]) == int(b) == 1, n
        else:
            scale = max(float(b.abs().max()), 1e-30)
            assert float((r_buffers[n] - b).abs().max()) <= REMAT_TOL * scale, n


def test_remat_keeps_dropout_masks():
    """The recompute draws dropout's masks again from the saved generator
    state: with dropout on, remat's gradients are those without it."""
    (x, y), = batches(1, 33, 2, CLASSES)
    out = []
    for remat in (False, True):
        model = get_model("PSPNet", device="cpu", seed=1, num_classes=CLASSES,
                          backbone="resnet18").double()
        torch.manual_seed(3)
        out.append(_grads_and_buffers(model, x, y, remat)[1])
    for n, g in out[0].items():
        assert float((out[1][n] - g).abs().max()) <= REMAT_TOL * float(g.abs().max()), n


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("hw", [(64, 64), (65, 63), (33, 34)])
def test_s2d_stem_conv_matches_segtpus(k, hw):
    h, w = hw
    rng = np.random.default_rng(k * 100 + h)
    x = rng.standard_normal((2, h, w, 3))
    kern = rng.standard_normal((k, k, 3, 16))
    with segtpu_float64():
        def seg_loss(xx, ww):
            return jnp.sum(jnp.sin(seg_s2d_stem_conv(xx, ww, padding=k // 2)))

        want = seg_s2d_stem_conv(jnp.asarray(x), jnp.asarray(kern), padding=k // 2)
        want_gx, want_gw = jax.grad(seg_loss, argnums=(0, 1))(jnp.asarray(x),
                                                             jnp.asarray(kern))
    xt = nchw(x).requires_grad_()
    wt = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()).requires_grad_()
    got = s2d_stem_conv(xt, wt, k // 2)
    torch.sin(got).sum().backward()
    assert rel_max(nhwc(got), np.asarray(want)) < S2D_TOL
    assert rel_max(nhwc(xt.grad), np.asarray(want_gx)) < S2D_TOL
    assert rel_max(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(want_gw)) < S2D_TOL
    # the stride-2 conv itself, and two bands with their halo rows
    assert rel_max(got.detach(), F.conv2d(xt.detach(), wt.detach(), stride=2,
                                          padding=k // 2)) < S2D_TOL
    p, ho = k // 2, got.shape[2]
    bands = []
    for o0, o1 in ((0, ho // 2), (ho // 2, ho)):
        a, b = 2 * o0 - p, 2 * (o1 - 1) - p + k
        bands.append(s2d_stem_conv(xt.detach()[:, :, max(a, 0):min(b, h)], wt.detach(), p,
                                   (max(0, -a), max(0, b - h))))
    assert rel_max(torch.cat(bands, 2), got.detach()) < S2D_TOL


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_pspnet_s2d_stem_gives_the_plain_logits(backbone):
    plain = _pspnet() if backbone == "resnet18" else no_dropout(get_model(
        "PSPNet", device="cpu", seed=1, num_classes=CLASSES, backbone=backbone)).double()
    s2d = no_dropout(get_model("PSPNet", device="cpu", seed=1, num_classes=CLASSES,
                               backbone=backbone, s2d_stem=True)).double()
    assert type(s2d.initial[0] if backbone == "resnet18" else s2d.initial[0][0]
                ).__name__ == "S2DStemConv2d"
    s2d.load_state_dict(plain.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 33, 35)))
    with torch.no_grad():
        assert rel_max(s2d.eval()(x)["out"], plain.eval()(x)["out"]) < S2D_TOL
    # the stem kernel wins over s2d_stem, as in segtpu
    both = get_model("PSPNet", device="cpu", num_classes=CLASSES, backbone=backbone,
                     s2d_stem=True, pallas_stem_wgrad=True)
    first = both.initial[0] if backbone == "resnet18" else both.initial[0][0]
    assert type(first).__name__ == "StemConv2d"


@pytest.mark.parametrize("arch", ["resnet50", "resnet101"])
@pytest.mark.parametrize("multi_grid", [False, True])
def test_multi_grid_plan_is_segtpus(arch, multi_grid):
    for style in ("encoding", "torchvision"):
        for os_ in (8, 16):
            got = _layer_plan(arch, style, os_, multi_grid, None)
            want = seg_resnet._layer_plan(arch, style, os_, multi_grid, None)
            assert got[0] == tuple(want[0]) and got[1] == [list(d) for d in want[1]]
    if multi_grid:
        assert _layer_plan(arch, "encoding", 8, True, None)[1][3] == [4, 8, 16]


def test_multi_grid_forward_matches_segtpu():
    """ResNet-50 (encoding style) with multi-grid, eval mode, float64: the
    four stage outputs against segtpu's on the weights of a PSPNet-R50
    converted by segtpu's converter."""
    port = get_model("PSPNet", device="cpu", seed=4, num_classes=CLASSES,
                     backbone="resnet50").double()
    params, stats = MODEL_CONVERTERS["PSPNet"](
        {k: v.numpy() for k, v in port.state_dict().items()}, arch="resnet50")
    feats = ResNetFeatures(arch="resnet50", style="encoding", multi_grid=True).double()
    keys = {k: v for k, v in port.state_dict().items() if k.split(".")[0] in
            ("initial", "layer1", "layer2", "layer3", "layer4")}
    feats.load_state_dict(keys, strict=True)
    assert [b.conv2.dilation[0] for b in feats.layer4] == [4, 8, 16]
    x = np.random.default_rng(6).normal(size=(1, 33, 33, 3))
    with segtpu_float64():
        seg = seg_resnet.ResNetFeatures(arch="resnet50", style="encoding", multi_grid=True)
        to64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        want = seg.apply({"params": to64(params["backbone"]),
                          "batch_stats": to64(stats["backbone"])},
                         jnp.asarray(x), train=False)
    with torch.no_grad():
        got = feats.eval()(nchw(x))
    assert len(got) == len(want) == 4
    for g, wv in zip(got, want):
        assert rel_max(nhwc(g), np.asarray(wv)) < TOL64


@pytest.mark.parametrize("k", [3, 7])
def test_stem_plain_with_explicit_padding_sums_over_bands(k):
    """Three bands of an image (boundaries at even rows), each with its halo
    rows and the image's zero padding only at its top and bottom: their dW
    sum to the whole image's, and a band's forward is the whole conv's
    rows."""
    rng = np.random.default_rng(k)
    n, h, w, c, co = 2, 41, 23, 3, 8
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
    ho = (h + 2 * (k // 2) - k) // 2 + 1
    dy = torch.from_numpy(rng.normal(size=(n, ho, (w + 2 * (k // 2) - k) // 2 + 1, co))
                          .astype(np.float32))
    whole = cw.stem_conv_wgrad_plain(x, dy, k)
    p, total = k // 2, torch.zeros_like(whole)
    for o0, o1 in ((0, 6), (6, 13), (13, ho)):
        a, b = 2 * o0 - p, 2 * (o1 - 1) - p + k
        band = x[:, max(a, 0):min(b, h)]
        pad = (max(0, -a), max(0, b - h))
        total += cw.stem_conv_wgrad(band, dy[:, o0:o1], k, pad_h=pad)
        weight = torch.from_numpy(rng.normal(size=(co, c, k, k)).astype(np.float32))
        y_band = cw.StemConv.apply(band.permute(0, 3, 1, 2), weight, k, pad)
        y_whole = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=2, padding=p)
        assert torch.allclose(y_band, y_whole[:, :, o0:o1], atol=1e-5)
    assert float((total - whole).abs().max()) <= 1e-5 * float(whole.abs().max())
    with pytest.raises(ValueError, match="does not match"):
        cw.stem_conv_wgrad(x[:, :10], dy[:, :6], k, pad_h=(p, 0))
