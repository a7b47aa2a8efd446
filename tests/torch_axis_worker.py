"""The ranks' side of tests/test_torch_model_axis.py: every case, run by
``segtpu_torch.core.mesh.launch`` on 4 gloo ranks on the CPU, each writing
its results to ``<out>/<case>-rank<r>.pt``. Imports torch, numpy and
segtpu_torch only (the ranks never load JAX); the test process holds the
results against segtpu and against the single-process port.

Inputs are made with numpy from seeds that the test process repeats. With a
model axis of 2 the 4 ranks form segtpu's 2 x 2 mesh: rank r has data index
``r // 2`` and model index ``r % 2``; data index d takes images
``[d*b/2, (d+1)*b/2)`` of a global batch of b, and under spatial sharding
model index m takes its band of rows.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from segtpu_torch import losses
from segtpu_torch.core import mesh, spatial, tensor_parallel
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_eval_step, make_train_step
from segtpu_torch.nn.layers import GlobalBatchNorm2d, convert_global_bn

import torch_dist_worker as dw

CLASSES = dw.CLASSES
SGD = dw.SGD
WORLD, MP = 4, 2
# the halo ops: a 13-row map split 6 / 7 (a boundary at an even row, so
# stride-2 windows start on it); every dilation's halo up to 12 rows
OP_H, OP_W, OP_BOUNDS = 13, 11, ((0, 6), (6, 13))
CONV_CASES = [(k, d, s) for k in (1, 3, 5, 7) for d in (1, 2, 4) for s in (1, 2)
              if k > 1 or d == 1]
POOL_CASES = [(3, 2, 1, False), (2, 2, 0, True), (3, 2, 0, True), (3, 1, 1, False),
              (2, 2, 0, False)]
# (target rows, target columns, align_corners, replicated source rows or None);
# 13 x 11 is the source's size in another layout (7 / 6 rows)
RESIZE_CASES = [(h, w, ac, None) for h, w in ((26, 22), (7, 9), (13, 17), (25, 11), (13, 11))
                for ac in (False, True)] + [(13, 11, ac, 6) for ac in (False, True)]
BINS = (1, 2, 3, 6)
BINS_SHORT = (1, 2, 4, 6)  # UperNet's, on a map of fewer rows than bins
# the stem convs on a band: (class name, k)
STEM_CASES = [("StemConv2d", 3), ("StemConv2d", 7), ("S2DStemConv2d", 3),
              ("S2DStemConv2d", 7)]
# the TP step: PSPNet-R18 as tests/test_torch_distributed.py's step
STEP_HW, STEP_BATCH, STEP_STEPS = dw.STEP_HW, dw.STEP_BATCH, dw.STEP_STEPS
# the spatial steps: (model, H) at uneven and even splits (PSPNet at 40: 24 /
# 16 rows; UNet at 33: 32 / 1, odd maps and the decoder's resizes; at 48:
# 32 / 16), every model at tests/torch_dist_worker.py's small configuration:
# UperNet and DeepLab at 48 (32 / 16); PSPDenseNet at 72 (40 / 32), its
# padding-0 stem leaving rank 1 fewer rows at each conv; DeepLab_DUC_HDC at
# 65 (40 / 25), both crops cutting rank 1's rows; SegNet at 33 (32 / 1), the
# ceil-mode partial windows on rank 1; SegResNet at 65 (64 / 1), its stem
# pool's indices crossing the boundary and its centre crop's odd trims, and
# at 128 (64 / 64: at 64 its float64 steps part from any other summation
# order by 4e-4 of the update within 3 steps); UNetResnet at 40 (24 / 16),
# its overlapping up-convs and its resizes down onto the stride-8 skips;
# ENet at 33 (24 / 9), every pad-or-crop cutting or padding a row across the
# boundary and the last crop cutting rank 1's rows; GCN (transposed-conv
# decoder) at 65 (64 / 1), its pad-or-crops cutting a row at every level and
# three rows at the end; FCN8 at 65 (64 / 1), the first conv's padding
# leaving rank 1 199 of its 263 rows and the crops at 5, 9 and 31 reading
# across the boundary
SPATIAL_CASES = [("PSPNet", 40), ("PSPNet", 32), ("UNet", 33), ("UNet", 48), ("UNet", 32),
                 ("UperNet", 48), ("UperNet", 32), ("PSPDenseNet", 72), ("PSPDenseNet", 64),
                 ("DeepLab", 48), ("DeepLab", 32), ("DeepLab_DUC_HDC", 65),
                 ("DeepLab_DUC_HDC", 64), ("SegNet", 33), ("SegNet", 64), ("SegResNet", 65),
                 ("SegResNet", 128), ("UNetResnet", 40), ("ENet", 33), ("GCN", 65),
                 ("FCN8", 65)]
# PSPDenseNet with remat_backbone: one spatial step, whose recompute runs
# under the same layouts (against the one-process step without remat)
REMAT_CASE = ("PSPDenseNet", 64)
# the spatial cases held against segtpu's spatial step on its 2 x 2 mesh,
# at sizes where it agrees with its unsharded one (tests/test_torch_model_axis.py);
# segtpu cannot split an odd H, so ENet, GCN and FCN8 are held at another
# size, one step each (SEG_ONLY)
SEG_ONLY = [("ENet", 48), ("GCN", 384), ("FCN8", 64)]
SEG_CASES = [("PSPNet", 40), ("UNet", 48), ("UperNet", 48), ("PSPDenseNet", 72),
             ("DeepLab", 48), ("DeepLab_DUC_HDC", 64), ("SegNet", 64), ("SegResNet", 128),
             ("UNetResnet", 40), *SEG_ONLY]
SPATIAL_BATCH, SPATIAL_STEPS = 2, 3
# the spatial cases' constructor args beside tests/torch_dist_worker.py's:
# GCN with its transposed-conv decoder
SPATIAL_ARGS = {"GCN": {"use_deconv": True}}
# FCN8's FC6 and FC7 in the port-against-port cases; segtpu hard-codes them
# 4096 wide, so its case (SEG_ONLY) takes that width
FCN_FC_NARROW, SEG_FC_WIDTH = 32, 4096
# each spatial model's map whose rows a test counts: (module, its stride)
PROBES = {"PSPNet": ("layer4", 8), "UNet": ("middle_conv", 16),
          "UperNet": ("backbone.layer4", 16), "PSPDenseNet": ("block4", 8),
          "DeepLab": ("backbone.layer4", 16), "DeepLab_DUC_HDC": ("backbone.layer4", 8),
          "SegNet": ("stage5_encoder", 16), "SegResNet": ("encoder", 32),
          "UNetResnet": ("layer4", 8), "ENet": ("bottleneck31", 8),
          "GCN": ("backbone.layer4", 32), "FCN8": ("pool3", 8)}
# the zoo under TP: convs of 16 or more channels sharded, so each model
# shards some (FCN8's narrowed VGG included)
ZOO_MIN_CHANNELS = 16
LOSS_SHAPE = (4, CLASSES, 9, 11)
LOSS_BOUNDS = ((0, 4), (4, 9))


def save(out, case, obj):
    torch.save(obj, os.path.join(out, f"{case}-rank{mesh.rank()}.pt"))


def images_of(a):
    """This data index's images of a global batch."""
    per = len(a) // mesh.data_size()
    return a[mesh.data_index() * per:(mesh.data_index() + 1) * per]


def band(a, bounds, dim):
    lo, hi = bounds[mesh.model_index()]
    return a.narrow(dim, lo, hi - lo) if torch.is_tensor(a) else np.take(
        a, np.arange(lo, hi), axis=dim)


def gathered(model, opt=None):
    """The model's (and optimizer's) state in the one-device layout (a
    collective)."""
    sd = model.state_dict()
    osd = opt.state_dict() if opt is not None else {"state": {}}
    if tensor_parallel.sharded_dims(model):
        sd, osd = tensor_parallel.gather_state(model, opt, sd, osd)
    return {k: v.clone() for k, v in sd.items()}, osd


def rank_spread(sd):
    """The largest |this rank - rank 0| over every tensor of ``sd`` (one
    broadcast of them all, in float64)."""
    mine = torch.cat([v.double().reshape(-1) for v in sd.values()])
    ref = mine.clone()
    dist.broadcast(ref, 0)
    return float((mine - ref).abs().max())


# -- inputs, shared with the test process --------------------------------------------

def op_inputs(kind, i):
    """(x, weight, bias, upstream gradient's seed) of halo op case i."""
    rng = np.random.default_rng(100 * ["conv", "pool", "resize", "pool_bins", "stem"].index(kind)
                                + i)
    x = rng.normal(size=(2, 3, OP_H, OP_W))
    return x, rng.normal(size=(4, 3, 7, 7)), rng.normal(size=4), rng


def stem_module(name, k, weight):
    """The stem's first conv (3 -> 4 channels, k x k, stride 2) of class
    ``name`` with ``weight``'s first taps, in float64, in its halo class."""
    from segtpu_torch.ops.conv_wgrad import StemConv2d
    from segtpu_torch.ops.s2d import S2DStemConv2d

    cls = {"StemConv2d": StemConv2d, "S2DStemConv2d": S2DStemConv2d}[name]
    m = cls(3, 4, k, lambda t, g: None).double()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(weight[:, :, :k, :k]))
    assert spatial.shard_windows(m) == 1
    return m


def conv_module(k, d, s, weight=None, bias=None):
    conv = nn.Conv2d(3, 4, k, s, d * (k - 1) // 2, d).double()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(weight[:, :, :k, :k]))
        conv.bias.copy_(torch.from_numpy(bias))
    return conv


def loss_inputs(binary):
    rng = np.random.default_rng(15)
    b, c, h, w = LOSS_SHAPE
    logits = rng.normal(size=(b, h, w) if binary else LOSS_SHAPE) * 2
    labels = rng.integers(0, 2 if binary else c, size=(b, h, w))
    labels[:, :2, :3] = 255
    labels[b // 2:, 6:, :] = 255  # the bands' counts of valid pixels differ
    return torch.tensor(logits, dtype=torch.float64), torch.tensor(labels)


def spatial_batches(hw):
    rng = np.random.default_rng(21 + hw)
    out = []
    for _ in range(SPATIAL_STEPS + 1):  # the last one for the eval step
        imgs = rng.normal(size=(SPATIAL_BATCH, hw, hw, 3))
        labels = rng.integers(0, CLASSES, size=(SPATIAL_BATCH, hw, hw)).astype(np.int32)
        labels[:, :5, :5] = 255
        out.append((imgs, labels))
    return out


_BUILD = threading.Lock()


def spatial_model(name, fc_width=FCN_FC_NARROW, **kwargs):
    """The spatial cases' model (float64, no dropout): tests/torch_dist_worker.py's
    small configuration with SPATIAL_ARGS; FCN8's VGG stages narrowed and
    its FC6 and FC7 ``fc_width`` wide."""
    from segtpu_torch.backbones import vgg
    from segtpu_torch.models import fcn, get_model

    # the one-process reference builds its model in a thread beside the
    # ranks' (case_spatial): one build at a time, or one would see the
    # other's widths
    with _BUILD:
        prev = vgg.VGG16_STAGES, fcn.FC_WIDTH
        if name == "FCN8":
            vgg.VGG16_STAGES, fcn.FC_WIDTH = dw.FCN_NARROW, fc_width
        try:
            model = get_model(name, device="cpu", seed=1, num_classes=CLASSES,
                              **dw.ZOO[name][0], **SPATIAL_ARGS.get(name, {}), **kwargs)
        finally:
            vgg.VGG16_STAGES, fcn.FC_WIDTH = prev
    return dw.no_dropout(model).double()


def seg_case_model(name):
    """The model of a SEG_CASES case: FCN8's FC6 and FC7 at segtpu's
    hard-coded width."""
    return spatial_model(name, fc_width=SEG_FC_WIDTH)


# -- the cases -------------------------------------------------------------------------

def case_layout(out):
    res = {}
    for mp in (2, 4):
        mesh.set_model_axis(mp)
        res[mp] = {"data_index": mesh.data_index(), "model_index": mesh.model_index(),
                   "data_ranks": dist.get_process_group_ranks(mesh.data_group()),
                   "model_ranks": dist.get_process_group_ranks(mesh.model_group()),
                   "local_rows": mesh.local_rows(8)}
    res["errors"] = []
    for mp, sp in ((3, False), (1, True)):
        try:
            mesh.set_model_axis(mp, sp)
        except ValueError as e:
            res["errors"].append(str(e))
    mesh.set_model_axis(1)
    res["none"] = (mesh.model_size(), mesh.data_group(), mesh.pixel_group())
    save(out, "layout", res)


def _run_op(x_np, rows, fn, g_np, params=()):
    """``fn`` on this rank's band of ``x_np`` under ``rows``: (y, dx, the
    params' gradients), the upstream gradient this rank's rows of
    ``g_np``."""
    x = band(torch.from_numpy(x_np), rows.bounds, 2).clone().requires_grad_()
    with spatial.sharded(x, rows):
        y, out_rows = fn(x)
        lo, hi = out_rows.mine if out_rows != spatial.REPLICATED else (0, y.shape[2])
        g = torch.from_numpy(g_np(tuple(y.shape[:2]) + (out_rows_size(out_rows, y),)
                                  + tuple(y.shape[3:])))[:, :, lo:hi]
        (y * g).sum().backward()
    return y.detach(), x.grad, [p.grad for p in params]


def _resize_replicated(x, dst, w, ac, rep, rng):
    """A resize from a replicated source (the top-left rep x rep of ``x``,
    as the PSP bins) onto this rank's rows of ``dst``: (y, the source's
    gradient, which each model rank holds a part of)."""
    src = torch.from_numpy(x[:, :, :rep, :rep]).clone().requires_grad_()
    lo, hi = dst.mine
    with spatial.sharded(torch.empty(0, 0, hi - lo, w), dst):
        spatial.register(src, spatial.REPLICATED)
        y = spatial.resize_bilinear(src, (hi - lo, w), ac)
        g = torch.from_numpy(rng.normal(size=(2, 3, dst.size, w)))[:, :, lo:hi]
        (y * g).sum().backward()
    return y.detach(), src.grad, []


def out_rows_size(rows, y):
    return y.shape[2] if rows == spatial.REPLICATED else rows.size


def case_ops(out):
    mesh.set_model_axis(MP, spatial=True)
    rows = spatial.Rows(OP_BOUNDS, OP_H)
    res = {}
    for i, (k, d, s) in enumerate(CONV_CASES):
        x, w, b, rng = op_inputs("conv", i)
        conv = conv_module(k, d, s, w, b)
        conv.__class__ = spatial.HaloConv2d

        def fn(t, conv=conv):
            y = conv(t)
            return y, spatial.rows_of(y)

        res[("conv", k, d, s)] = _run_op(x, rows, fn, lambda shape, rng=rng: rng.normal(
            size=shape), [conv.weight, conv.bias])
    for i, (name, k) in enumerate(STEM_CASES):
        x, wt, _, rng = op_inputs("stem", i)
        stem = stem_module(name, k, wt)

        def stem_fn(t, stem=stem):
            y = stem(t)
            return y, spatial.rows_of(y)

        res[("stem", name, k)] = _run_op(x, rows, stem_fn, lambda shape, rng=rng: rng.normal(
            size=shape), [stem.weight])
    for i, (k, s, p, ceil) in enumerate(POOL_CASES):
        x, _, _, rng = op_inputs("pool", i)

        def fn(t, k=k, s=s, p=p, ceil=ceil):
            y = spatial.max_pool(t, k, s, p, ceil)
            return y, spatial.rows_of(y)

        res[("pool", k, s, p, ceil)] = _run_op(x, rows, fn, lambda shape, rng=rng: rng.normal(
            size=shape))
    for i, (h, w, ac, rep) in enumerate(RESIZE_CASES):
        x, _, _, rng = op_inputs("resize", i)
        dst = spatial.split(h, 1, MP)
        if rep is not None:
            res[("resize", h, w, ac, rep)] = _resize_replicated(x, dst, w, ac, rep, rng)
            continue

        def fn(t, w=w, ac=ac, dst=dst):
            lo, hi = dst.mine
            spatial.register(torch.empty(0, 0, hi - lo, w), dst)
            return spatial.resize_bilinear(t, (hi - lo, w), ac), dst

        res[("resize", h, w, ac, rep)] = _run_op(x, rows, fn, lambda shape, rng=rng:
                                                 rng.normal(size=shape))
    x, _, _, rng = op_inputs("pool_bins", 0)

    def bins_fn(t):
        pooled = spatial.adaptive_avg_pool_multi(t, BINS)
        flat = torch.cat([p.flatten(2) for p in pooled], 2)
        return flat.unsqueeze(-1), spatial.REPLICATED

    g_bins = rng.normal(size=(2, 3, sum(s * s for s in BINS), 1))
    # each model rank carries a part of the replicated bins' gradient
    part = 0.25 if mesh.model_index() == 0 else 0.75
    res["bins"] = _run_op(x, rows, bins_fn, lambda shape: g_bins * part)
    # the bins of a 3-row map split 2 / 1: the ranks' partial sums come out
    # of the einsum in other layouts, which the all-reduce must not mix
    x, _, _, rng = op_inputs("pool_bins", 1)
    x = x[:, :, :3, :3].copy()
    g_short = rng.normal(size=(2, 3, sum(s * s for s in BINS_SHORT), 1))
    res["bins_short"] = _run_op(x, spatial.Rows(((0, 2), (2, 3)), 3), lambda t: (
        torch.cat([p.flatten(2) for p in spatial.adaptive_avg_pool_multi(t, BINS_SHORT)],
                  2).unsqueeze(-1), spatial.REPLICATED), lambda shape: g_short * part)
    for name in BAND_OPS:
        x, extra, rng = band_op_inputs(name)
        module = band_op_module(name)
        params = list(module.parameters()) if module is not None else []
        if module is not None:
            convert_global_bn(module)
            spatial.shard_windows(module)

        def band_fn(t, name=name, module=module, extra=extra):
            y = band_op_apply(name, t, module, True, extra)
            return y, spatial.rows_of(y)

        if name == "image_pool":  # replicated: each model rank carries a part
            g_img = rng.normal(size=(2, 3, 1, 1))
            res[name] = _run_op(x, rows, band_fn, lambda shape, g=g_img: g * part)
        else:
            res[name] = _run_op(x, rows, band_fn, lambda shape, rng=rng: rng.normal(
                size=shape), params)
    for case in TCONV_CASES:
        for split, (h, bounds) in TCONV_SPLITS.items():
            x, m, rng = tconv_inputs(case, split)
            assert spatial.shard_windows(m) == 1

            def tconv_fn(t, m=m):
                y = m(t)
                return y, spatial.rows_of(y)

            res[("tconv", *case, split)] = _run_op(x, spatial.Rows(bounds, h), tconv_fn,
                                                   lambda shape, rng=rng: rng.normal(size=shape),
                                                   [m.weight, m.bias])
    # column parallel: each rank's slices gathered whole (each holds the
    # model group's summed gradient)
    x, m, rng = tp_tconv_inputs()
    holder = nn.Sequential(m)
    assert tensor_parallel.shard_model(holder, 2) == ["0"]
    assert type(m) is tensor_parallel.HaloColumnConvTranspose2d

    def tp_fn(t):
        y = holder(t)
        return y, spatial.rows_of(y)

    y, dx, _ = _run_op(x, rows, tp_fn, lambda shape: rng.normal(size=shape))
    dims = tensor_parallel.sharded_dims(holder)
    res["tconv_tp"] = (y, dx, {n: tensor_parallel._gather_dim(p.grad, dims[n])
                               for n, p in holder.named_parameters()})
    save(out, "ops", res)


# the ops of this slice's models on the 13-row map: depthwise convs, the
# DenseNet's transition and stem pools, ASPP's image pool, the DUC's pixel
# shuffle, global-row crops (from row 0 with rank 1's band cut short, as
# DeepLab_DUC_HDC's; and shifted, as SegResNet's centre crop), SegNet's and
# SegResNet's argmax pool and unpool pairs, and two narrow Xception blocks
# (a strided one and a dilated one)
BAND_OPS = ["depthwise-k3-d1-s1", "depthwise-k3-d2-s1", "depthwise-k3-d1-s2", "avg_pool",
            "module_max_pool", "image_pool", "pixel_shuffle", "crop_top", "crop_shift",
            "argmax_pool", "argmax_pool_flat", "xception", "pad_or_crop+1", "pad_or_crop-1"]
# the top-left pad-or-crops (ENet's and GCN's): dh = dw, and the target's
# bands, which start a row away from the source's 6 / 7 (rank 1's first row
# is rank 0's last at +1; rank 0's last is rank 1's first at -1). ENet's
# last crop, from row 0 onto the input's layout with rank 1's band cut
# short, is ``crop_top``
PAD_OR_CROP = {"pad_or_crop+1": (1, ((0, 6), (6, 14))),
               "pad_or_crop-1": (-1, ((0, 6), (6, 12)))}
# the crops: (top, left, rows, columns, the target's bands); both cut
# columns too, as the models' crops do (the layouts are kept by local shape)
CROPS = {"crop_top": (0, 0, 12, 10, ((0, 6), (6, 12))),
         "crop_shift": (2, 1, 9, 8, ((0, 5), (5, 9)))}


def band_op_inputs(name):
    """(x, the argmax pairs' factors for the pooled values or None, the
    generator) of band op ``name``. SegResNet's pair: values on
    a half grid, so windows tie, and row 5 (rank 0's) the maximum of the
    windows of pooled rows 2 (rank 0's) and 3 (rank 1's), so an index of
    rank 1 names a row that rank 0 owns and the two ranks' indices repeat
    there; its canvas (14 x 12, the pool's input 11 wide) puts those
    writes in rank 0's canvas rows."""
    rng = np.random.default_rng(500 + BAND_OPS.index(name))
    channels = 8 if name in ("pixel_shuffle", "xception") else 3
    x = rng.normal(size=(2, channels, OP_H, OP_W))
    if name == "argmax_pool_flat":
        x = np.round(x * 2) / 2
        x[:, :, 5, :] = 10.0
    if not name.startswith("argmax"):
        return x, None, rng
    rows = -(-OP_H // 2) if name == "argmax_pool" else (OP_H - 1) // 2 + 1
    cols = -(-OP_W // 2) if name == "argmax_pool" else (OP_W - 1) // 2 + 1
    return x, rng.normal(size=(2, channels, rows, cols)), rng


def band_op_module(name):
    """Band op ``name``'s module (float64), built from a fixed seed; None
    for the functional ops."""
    from segtpu_torch.backbones.xception import XceptionBlock

    torch.manual_seed(9)
    if name.startswith("depthwise"):
        k, d, s = (int(part[1:]) for part in name.split("-")[1:])
        return nn.Conv2d(3, 3, k, s, d * (k - 1) // 2, d, groups=3).double()
    if name == "avg_pool":
        return nn.AvgPool2d(2, 2)
    if name == "module_max_pool":
        return nn.MaxPool2d(3, 2, 1)
    if name == "xception":
        return nn.Sequential(XceptionBlock(8, 16, stride=2),
                             XceptionBlock(16, 16, dilation=2)).double()
    return None


def band_op_apply(name, t, module, sharded, extra=None):
    """Band op ``name`` on ``t`` (this rank's rows with ``sharded``, else
    the whole map); the argmax pairs unpool the pooled values times
    ``extra``."""
    from segtpu_torch.ops import pooling, shape

    if module is not None:
        return module(t)
    if name == "image_pool":
        return (spatial.image_mean if sharded else pooling.image_mean)(t)
    if name == "pixel_shuffle":
        return (spatial.pixel_shuffle if sharded else torch.nn.functional.pixel_shuffle)(t, 2)
    if name in PAD_OR_CROP:
        d, bounds = PAD_OR_CROP[name]
        n, cols = OP_H + d, OP_W + d
        if not sharded:
            return shape.pad_or_crop_tl(t, n, cols)
        dst = spatial.Rows(bounds, n)
        lo, hi = dst.mine
        spatial.register(torch.empty(0, 0, hi - lo, cols), dst)
        return spatial.pad_or_crop(t, hi - lo, cols)
    if name in CROPS:
        top, left, n, cols, bounds = CROPS[name]
        if not sharded:
            return shape.crop(t, top, left, (n, cols))
        dst = spatial.Rows(bounds, n)
        lo, hi = dst.mine
        spatial.register(torch.empty(0, 0, hi - lo, cols), dst)
        return spatial.crop(t, top, left, (hi - lo, cols))
    scale = torch.from_numpy(extra)
    if name == "argmax_pool":
        pool, unpool = ((spatial.max_pool_argmax, spatial.max_unpool) if sharded else
                        (pooling.max_pool_argmax, pooling.max_unpool))
        y, idx = pool(t)
        if sharded:
            scale = band(scale, spatial.rows_of(y).bounds, 2)
        return unpool(y * scale, idx, t.shape[-2:])
    pool, unpool = ((spatial.max_pool_argmax_flat, spatial.max_unpool_flat) if sharded else
                    (pooling.max_pool_argmax_flat, pooling.max_unpool_flat))
    y, idx = pool(t)
    if sharded:
        scale = band(scale, spatial.rows_of(y).bounds, 2)
    return unpool(y * scale, idx, (2 * y.shape[-2], 2 * y.shape[-1]))


# the transposed convs over H: (k, stride, padding, output padding), each
# on the splits of TCONV_SPLITS (H, bounds): uneven, even, and a one-row
# band whose outputs (a stride's rows) reach past the other's boundary
TCONV_CASES = [(3, 2, 1, 1), (4, 2, 1, 0), (4, 2, 0, 0), (16, 8, 0, 0)]
TCONV_SPLITS = {"uneven": (OP_H, OP_BOUNDS), "even": (12, ((0, 6), (6, 12))),
                "one-row": (OP_H, ((0, 1), (1, OP_H)))}


def _seeded_tconv(rng, cin, cout, k, s, p, op):
    m = nn.ConvTranspose2d(cin, cout, k, s, p, op).double()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.normal(size=m.weight.shape)))
        m.bias.copy_(torch.from_numpy(rng.normal(size=m.bias.shape)))
    return m


def tconv_inputs(case, split):
    """(x, the conv (float64), the generator) of a transposed conv case."""
    rng = np.random.default_rng(700 + 10 * TCONV_CASES.index(case) + list(TCONV_SPLITS).index(
        split))
    m = _seeded_tconv(rng, 3, 4, *case)
    return rng.normal(size=(2, 3, TCONV_SPLITS[split][0], OP_W)), m, rng


def tp_tconv_inputs():
    """(x, the whole conv, the generator) of the column-parallel transposed
    conv over H: ENet's 3x3/2 (padding 1, output padding 1), 8 -> 6
    channels."""
    rng = np.random.default_rng(41)
    m = _seeded_tconv(rng, 8, 6, 3, 2, 1, 1)
    return rng.normal(size=(2, 8, OP_H, OP_W)), m, rng


TP_CONVS = ("depthwise", "transposed", "plain")


def tp_conv_inputs(name):
    """(x, upstream gradient, the whole conv) of a column-parallel case."""
    rng = np.random.default_rng(31 + TP_CONVS.index(name))
    m = {"depthwise": nn.Conv2d(8, 8, 3, padding=1, groups=8),
         "transposed": nn.ConvTranspose2d(8, 6, 2, 2),
         "plain": nn.Conv2d(8, 6, 3, padding=2, dilation=2)}[name].double()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.normal(size=m.weight.shape)))
        m.bias.copy_(torch.from_numpy(rng.normal(size=m.bias.shape)))
    x = torch.from_numpy(rng.normal(size=(2, 8, 9, 10)))
    return x, torch.from_numpy(rng.normal(size=tuple(m(x).shape))), m


def case_tp_ops(out):
    """Column-parallel convs under tensor parallelism alone, a depthwise
    one and a transposed one, against the whole conv on one rank."""
    mesh.set_model_axis(MP)
    res = {}
    for name in TP_CONVS:
        x, g, m = tp_conv_inputs(name)
        holder = nn.Sequential(m)
        assert tensor_parallel.shard_model(holder, 2) == ["0"]
        xr = x.clone().requires_grad_()
        y = holder(xr)
        (y * g).sum().backward()
        dims = tensor_parallel.sharded_dims(holder)
        res[name] = (y.detach(), xr.grad, {n: tensor_parallel._gather_dim(p.grad, dims[n])
                                           for n, p in holder.named_parameters()})
    save(out, "tp_ops", res)


def case_bn(out):
    """``GlobalBatchNorm2d`` under TP (the data group's count), under
    spatial sharding (the world's), and on replicated maps under spatial
    sharding (the data group's, each model rank carrying a part of the
    gradient)."""
    res = {}
    x, g, *params = dw.bn_inputs(torch.float64)  # (8, 6, 5, 7)
    for mode in ("tp", "spatial", "replicated"):
        mesh.set_model_axis(MP, spatial=mode != "tp")
        bn = dw.make_bn(x.shape[1], params, GlobalBatchNorm2d).train()
        bn.replicated_maps = mode == "replicated"
        xr, gr = images_of(x), images_of(g)
        if mode == "spatial":
            xr, gr = band(xr, ((0, 3), (3, 5)), 2), band(gr, ((0, 3), (3, 5)), 2)
        if mode == "replicated":
            gr = gr * (0.25 if mesh.model_index() == 0 else 0.75)
        xr = xr.clone().requires_grad_()
        y = bn(xr)
        (y * gr).sum().backward()
        res[mode] = {"y": y.detach(), "dx": xr.grad, "dweight": bn.weight.grad,
                     "dbias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()}
    save(out, "bn", res)


def case_losses(out):
    """Every loss under spatial sharding: each rank a band of rows of its
    data index's images."""
    mesh.set_model_axis(MP, spatial=True)
    res = {}
    for name, kw in dw.LOSS_CASES:
        binary = name in dw.BINARY
        logits, labels = loss_inputs(binary)
        mine = band(images_of(logits), LOSS_BOUNDS, 1 if binary else 2).clone()
        mine.requires_grad_()
        lab = band(images_of(labels), LOSS_BOUNDS, 1)
        loss = dw.loss_fn(name)(mine, lab, ignore_index=255, **kw)
        loss.backward()
        res[(name, tuple(sorted(kw.items())))] = (loss.detach(), mine.grad)
    save(out, "losses", res)


def _train(model, batches, rows_of_batch=None, eval_batch=None, keep=(0,)):
    """SGD steps of ``model`` (already sharded) on its part of each global
    batch: (the losses, gathered snapshots after steps 1 and the last on the
    ranks of ``keep``, the rank spread after each step, eval loss and
    stats)."""
    opt, scheds = make_optimizer(model, **SGD)
    state = TrainState(model, opt, scheds)
    state.model_axis()
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float64)
    snaps, spreads, losses_ = {}, [], []
    for i, (imgs, labels) in enumerate(batches):
        imgs, labels = images_of(imgs), images_of(labels)
        args = ()
        if rows_of_batch is not None:
            rows = rows_of_batch(imgs.shape[1])
            imgs, labels = spatial.keep_rows(imgs, rows), spatial.keep_rows(labels, rows)
            args = (rows,)
        loss, _ = step(state, torch.from_numpy(imgs), torch.from_numpy(labels), *args)
        losses_.append(float(loss))
        sd, _ = gathered(model)
        spreads.append(rank_spread(sd))
        if mesh.rank() in keep and i + 1 in (1, len(batches)):
            snaps[i + 1] = (loss.numpy(), sd)
    res = {"losses": losses_, "snaps": snaps, "spread": spreads}
    if eval_batch is not None:
        imgs, labels = (images_of(a) for a in eval_batch)
        args = ()
        if rows_of_batch is not None:
            rows = rows_of_batch(imgs.shape[1])
            imgs, labels = spatial.keep_rows(imgs, rows), spatial.keep_rows(labels, rows)
            args = (rows,)
        estep = make_eval_step(losses.cross_entropy, compute_dtype=torch.float64)
        loss, stats, logits = estep(model, torch.from_numpy(imgs), torch.from_numpy(labels),
                                    *args)
        res["eval"] = (float(loss), [t.clone() for t in stats.all_reduce()])
        res["logits_h"] = logits.shape[2]
    return res


def case_tp_step(out):
    """PSPNet-R18, float64, 3 SGD steps on the global batch of 8 over the
    2 x 2 mesh, its convs of 256 or more channels sharded (segtpu's
    default)."""
    mesh.set_model_axis(MP)
    model = dw.no_dropout(dw.zoo_model("PSPNet"))
    convert_global_bn(model)
    names = tensor_parallel.shard_model(model)
    res = _train(model, dw.step_batches())
    res["sharded"] = names
    res["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    save(out, "tp_step", res)


def one_process(name, batches, eval_batch=None):
    """The port as one process on the whole batches (plain BN, the local
    CE, no collective and no global state, so that it can run in a thread
    beside the spatial steps): ``{step: (loss, state)}`` at the start and
    after steps 1 and the last, the eval step's loss and seg stats after
    them, and the probed map's height (PROBES). The step's and the eval
    step's bodies (``core/steps.py``) without their layouts' scope."""
    from segtpu_torch.core.steps import _forward_loss, prep_images
    from segtpu_torch.metrics import seg_stats_from_logits

    model = spatial_model(name)
    heights = []
    model.get_submodule(PROBES[name][0]).register_forward_hook(
        lambda m, i, o: heights.append(o.shape[2]))
    opt, scheds = make_optimizer(model, **SGD)
    state = TrainState(model, opt, scheds)
    snaps = {0: (None, {k: v.clone() for k, v in model.state_dict().items()})}
    for i, (imgs, labels) in enumerate(batches):
        model.train()
        x = prep_images(torch.from_numpy(imgs), None, torch.float64)
        loss, _ = _forward_loss(model, x, torch.from_numpy(labels), dw.local_cross_entropy,
                                255, 0.4, torch.float64)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        if i + 1 in (1, len(batches)):
            snaps[i + 1] = (loss.detach().numpy(),
                            {k: v.clone() for k, v in model.state_dict().items()})
    ref = {"snaps": snaps, "probe_rows": heights[0]}
    if eval_batch is not None:
        model.eval()
        imgs, labels = (torch.from_numpy(a) for a in eval_batch)
        with torch.no_grad():
            loss, logits = _forward_loss(model, prep_images(imgs, None, torch.float64), labels,
                                         dw.local_cross_entropy, 255, 0.0, torch.float64)
        ref["eval"] = (float(loss), [t.clone() for t in seg_stats_from_logits(logits, labels)])
    return ref


def beside(fn, *args):
    """``fn(*args)`` in a thread; returns a function that joins it and
    gives its result (or raises what it raised)."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # raised by the join
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


# a tensor is held relative to the larger of its largest value and this:
# where a bias is followed by a BN (SegNet's convs, DeepLab_DUC_HDC's
# classifier), its gradient is 0 in exact arithmetic and its value float64
# rounding noise, 1e-19 to 1e-18
VALUE_FLOOR = 1e-9


def compare_states(snaps, ref):
    """Each of ``ref``'s steps after the start against ``snaps``: (the
    loss's relative error, the largest error of a floating tensor relative
    to the larger of its largest value and VALUE_FLOOR, that tensor's name,
    whether every integer tensor is equal, the change since the start of
    all floating tensors against ``ref``'s, relative L2)."""
    out = {}
    start = ref["snaps"][0][1]
    for n, (ref_loss, ref_sd) in ref["snaps"].items():
        if not n:
            continue
        loss, sd = snaps[n]
        worst, worst_key, ints, diff, norm = 0.0, None, True, 0.0, 0.0
        for k, v in ref_sd.items():
            if v.is_floating_point():
                err = float((sd[k] - v).abs().max()) / max(float(v.abs().max()), VALUE_FLOOR)
                if err >= worst:
                    worst, worst_key = err, k
                diff += float((sd[k] - v).square().sum())
                norm += float((v - start[k]).square().sum())
            else:
                ints = ints and torch.equal(sd[k], v)
        out[n] = (abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)), worst,
                  worst_key, ints, (diff / max(norm, 1e-300)) ** 0.5)
    return out


def case_spatial(out):
    """Each model of SPATIAL_CASES under spatial sharding (and TP, as
    segtpu's trainer sets both), float64, 3 SGD steps on a global batch of
    2, then an eval step; each rank's activation heights. Rank ``i % WORLD``
    also runs case i as one process on the whole batches, in a thread, and
    compares the two (what it keeps is the comparison); rank 0 writes the
    gathered states of the cases SEG_CASES holds against segtpu to a file a
    case."""
    mesh.set_model_axis(MP, spatial=True)
    res = {}
    for i, (name, hw) in enumerate(SPATIAL_CASES):
        data = spatial_batches(hw)
        judge = i % WORLD
        ref = beside(one_process, name, data[:-1], data[-1]) if mesh.rank() == judge else None
        model = spatial_model(name)
        convert_global_bn(model)
        tensor_parallel.shard_model(model)
        heights = []
        probe = model.get_submodule(PROBES[name][0])
        handle = probe.register_forward_hook(lambda m, i, o: heights.append(o.shape[2]))
        stride = spatial.check_model(model)
        got = _train(model, data[:-1], lambda h: spatial.split(h, stride, MP), data[-1],
                     keep=(0, judge))
        handle.remove()
        got["heights"] = (heights[0], got.pop("logits_h"))
        got["rows"] = spatial.split(hw, stride, MP)
        if ref is not None:
            ref = ref()
            got["one_process"] = {"steps": compare_states(got["snaps"], ref),
                                  "eval": ref["eval"], "probe_rows": ref["probe_rows"]}
        if mesh.rank() == 0 and (name, hw) in SEG_CASES:
            torch.save(got["snaps"], os.path.join(out, f"spatial-snaps-{name}-{hw}.pt"))
        del got["snaps"], ref, model
        res[(name, hw)] = got
    # the cases held against segtpu alone: one step (FCN8's FC6 and FC7 at
    # segtpu's width)
    for name, hw in SEG_ONLY:
        model = seg_case_model(name)
        convert_global_bn(model)
        tensor_parallel.shard_model(model)
        stride = spatial.check_model(model)
        got = _train(model, spatial_batches(hw)[:1], lambda h: spatial.split(h, stride, MP))
        if mesh.rank() == 0:
            torch.save(got["snaps"], os.path.join(out, f"spatial-snaps-{name}-{hw}.pt"))
        res[("seg", name, hw)] = {"spread": got["spread"], "losses": got["losses"]}
        del got, model
    # remat_backbone against one process without it, one step (rank 0)
    name, hw = REMAT_CASE
    data = spatial_batches(hw)[:1]
    ref = beside(one_process, name, data) if mesh.is_main() else None
    model = spatial_model(name, remat_backbone=True)
    convert_global_bn(model)
    tensor_parallel.shard_model(model)
    stride = spatial.check_model(model)
    got = _train(model, data, lambda h: spatial.split(h, stride, MP))
    if ref is not None:
        got["one_process"] = compare_states(got["snaps"], ref())
    del got["snaps"]
    res["remat"] = got
    save(out, "spatial", res)


def case_zoo(out):
    """Each zoo model's step under TP (convs of ZOO_MIN_CHANNELS or more
    sharded) on a global batch of 2, one image a data index; and, on the
    ranks in turn, the same step as one process on the whole batch.
    Records, for every parameter, the largest gradient difference (the
    sharded ones gathered whole) and the largest single-process
    gradient."""
    mesh.set_model_axis(MP)
    res = {}
    for i, (name, (_, hw)) in enumerate(dw.ZOO.items()):
        imgs, labels = dw.zoo_batch(hw)
        model = dw.zoo_model(name)
        convert_global_bn(model)
        sharded = tensor_parallel.shard_model(model, ZOO_MIN_CHANNELS)
        got = _zoo_step(model, images_of(imgs), images_of(labels))
        res[name] = {"loss": got[0], "n_sharded": len(sharded), "n_grads": len(got[1]),
                     "model_scale": max(float(g.abs().max()) for g in got[1].values())}
        if i % WORLD == mesh.rank():
            _, ref_loss, ref = dw.one_step(dw.zoo_model(name), imgs, labels, False)
            res[name].update(ref_loss=ref_loss, ref_n_grads=len(ref), errors={
                n: (float((got[1][n] - g).abs().max()), float(g.abs().max()))
                for n, g in ref.items()})
    save(out, "zoo", res)


def _zoo_step(model, imgs, labels):
    opt, scheds = make_optimizer(model, **SGD)
    state = TrainState(model, opt, scheds)
    state.model_axis()
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float64)
    loss, _ = step(state, torch.from_numpy(imgs), torch.from_numpy(labels))
    dims = tensor_parallel.sharded_dims(model)
    grads = {n: tensor_parallel._gather_dim(p.grad, dims[n]) if n in dims else p.grad
             for n, p in model.named_parameters() if p.grad is not None}
    return float(loss), grads


# -- the Trainer: segtpu's test_trainer_parallelism_from_config ----------------------

def trainer_config(root, **trainer):
    synthetic = {"num_classes": 6, "image_hw": 72, "crop_size": 64, "num_workers": 1}
    return {
        "name": "TestRun", "seed": 0,
        "arch": {"type": "UNet", "args": {}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "batch_size": 8, "size": 24, "shuffle": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "batch_size": 8, "size": 8, "split": "val", "val": True,
            "augment": False, "shuffle": False}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.05, "weight_decay": 1e-4, "momentum": 0.9}},
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "save_dir": os.path.join(root, "saved"), "save_period": 1,
                    "monitor": "max Mean_IoU", "early_stop": 10, "tensorboard": False,
                    "log_dir": os.path.join(root, "runs"), "log_per_iter": 2,
                    "val": True, "val_per_epochs": 1, "compute_dtype": "float32",
                    **trainer},
    }


AXIS_KEYS = {"devices": 4, "model_parallel": 2, "spatial": True, "remat": True}


def port_trainer(cfg, resume=None):
    from segtpu_torch.data import DATASETS
    from segtpu_torch.models import get_model
    from segtpu_torch.trainer import Trainer
    from segtpu_torch.utils.logger import Logger

    model = get_model("UNet", device="cpu", num_classes=6)
    loaders = [DATASETS["Synthetic"](**cfg[k]["args"]) for k in ("train_loader", "val_loader")]
    return Trainer(model, cfg["loss"], cfg, *loaders, device="cpu", resume=resume,
                   train_logger=Logger())


def state_of(trainer):
    sd, osd = gathered(trainer.model, trainer.state.optimizer)
    return {"model": sd, "optimizer": osd, "step": trainer.state.step}


def case_trainer(out):
    """One epoch with segtpu's parallelism keys (data 2 x model 2, spatial,
    remat) and the val grid on, then a resume from its checkpoint on the 4
    ranks."""
    cfg = trainer_config(os.path.join(out, "trainer"), tensorboard=True, **AXIS_KEYS)
    trainer = port_trainer(cfg)
    step, step_losses = trainer.train_step, []

    def recorded(*args):
        loss, stats = step(*args)
        step_losses.append(float(loss))
        return loss, stats

    trainer.train_step = recorded
    history = trainer.train()
    res = {"history": history, "step_losses": step_losses,
           "checkpoint_dir": trainer.checkpoint_dir, "final": state_of(trainer),
           "sharded": len(trainer.sharded), "rows": trainer.train_rows,
           "param_shapes": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}}
    res["final_spread"] = rank_spread(res["final"]["model"])
    cfg["trainer"]["tensorboard"] = False
    resumed = port_trainer(cfg, resume=os.path.join(trainer.checkpoint_dir,
                                                    "checkpoint-epoch1"))
    res["resumed"] = state_of(resumed)
    res["resumed_epoch"] = resumed.start_epoch
    save(out, "trainer", res)


CASES = {"layout": case_layout, "ops": case_ops, "tp_ops": case_tp_ops, "bn": case_bn,
         "losses": case_losses, "tp_step": case_tp_step, "spatial": case_spatial,
         "zoo": case_zoo, "trainer": case_trainer}


def run_cases(device, out, names):
    """Every case of ``names`` on this rank, in order; each case's seconds
    in ``<out>/seconds-rank<r>.pt``."""
    import time

    torch.set_num_threads(1)
    seconds = {}
    for name in names:
        t0 = time.perf_counter()
        CASES[name](out)
        mesh.barrier()
        seconds[name] = time.perf_counter() - t0
    save(out, "seconds", seconds)
