#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (segtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]   # from the root of a checkout; one GPU

Phases, each announced on its own line:

1. device: the card's name and power limit (nvidia-smi), versions, TF32 off,
   whether the card's Python imports tensorboardX and tensorboard;
2. build: every hand-written kernel from the sources in the checkout, one
   nvcc each, all started together;
3. kernel against plain: each kernel's wrapper on the card, at the main
   paths' shapes and the test shapes, held against its plain PyTorch
   version: the stem weight gradient (also at shapes it once refused: tap
   groups, padded o tiles; at several o tiles, and at pixel tiles that end
   short of 64; launched twice at the main shape, bit for bit the same),
   and the flat-row wgrad and dgrad at the seven test cases and five
   full-width layers of PSPNet and UperNet;
4. flat_conv: the flat-row kernels' own path. No model calls ``flat_conv``
   (segtpu's models do not either), so its launches are this phase's:
   forward and backward at PSPNet's stem_conv2 shape, with the counts set to
   0 just before and read just after, held against autograd through
   ``F.conv2d`` and against the plain versions;
5. timings: kernel, plain version, the library call that computes the same
   function (timed only as a yardstick) and the bound (bytes or operations
   over the card's peak rate), for the stem kernel at its main-path shape
   and at k 7 on the same x and dy width, each with its launch plan and how
   the kernel's shared memory and the runtime's occupancy compare with it,
   and for both flat-row kernels at PSPNet's stem_conv2 and UperNet's head;
   the flat wgrad kernel also at the three other full-width layers (kernel,
   library and bound), with its launch plan (o tile, splits, blocks per SM,
   shared memory) at each;
6. PSPNet main path: ``segtpu_torch.train.main`` trains PSPNet-ResNet50 (19
   classes, 769x769 crops, batch 8, bf16 autocast, stem weight gradient
   through the kernel) for a few steps plus a validation pass, with every
   kernel's launch count set to 0 just before and read just after, writing
   checkpoint-latest after step 2 and checkpoint-epoch1 and best_model at
   the end;
   checkpoint and resume: checkpoint-epoch1 loads back into a fresh state
   bit for bit (model, optimizer, update count), with its size and its save
   and load times; a run resumed from checkpoint-latest starts its first
   update from the uninterrupted run's state bit for bit (model, momentum,
   update count, CPU and CUDA generators) and takes the epoch's last two
   steps on the uninterrupted run's batches, at its first rate, with its
   first loss equal to the uninterrupted run's, its second within
   RESUME_LOSS_TOL, and one stem launch a step (the counts set to 0 just
   before it and read just after); two controls, resumes that drop the
   generators' or the momentum buffers' restore, must fail those checks;
   then the main path times the train step on one device-resident batch,
   and traces a few more steps with torch.profiler for the device time by
   kernel category and the device's idle share, under the same flags; the
   losses of the timed and traced steps must be finite (so on every path);
7. PSPNet in-step check, from the same weights: in a bf16 step and in an
   fp32 step, the stem conv's weight gradient against the plain version on
   that step's own x and dy; on two batches, the fp32 gradient with the
   kernel against the library's (flag on against flag off), held per
   element to the bound that rounding x and dy to bf16 can move it by; and
   both flat-row kernels on stem_conv2's x, dy and weight from the bf16
   step, against the plain versions. Two bf16 steps are not held to each
   other: the same bf16 step run twice gives another upstream gradient, and
   the script prints how far the stem gradient moves;
8. inference: the inference CLI (``segtpu_torch.inference.main``) on
   best_model and on a freshly built checkpoint whose class maps vary (its
   BN statistics those of a batch of 8 crops of seeded frames like the
   inference images), in sliding and multiscale mode,
   fp32 and bf16, on two 1024x2048 RGB PNGs made from ``--seed``; each
   written class map reads back equal to the library call's; seconds per
   image, tiles and forwards, peak memory, and the share of pixels on which
   bf16 and fp32 agree; each checkpoint's fp32 sliding canvas against the
   plain tile-by-tile loop and its fp32 multiscale canvas (with flips)
   against the plain scale-by-scale loop, within INFER_TOL;
   serving export: best_model exported by ``torch.export`` at batch 1 and
   769x769 for cuda, reloaded, and run on a seeded uint8 batch beside the
   eager serve module (predictions equal where the top-two margin exceeds
   SERVE_TOL, confidences within it); the export time, the artifact's size;
   neither path launches a kernel (the stem kernel is a backward);
9. UperNet main path, after the PSPNet trainer is freed: UperNet-ResNet101
   (output stride 16, fpn_out 256, the same data, optimizer and dtype)
   trained, timed and traced as in phase 6;
10. UperNet in-step check: both flat-row kernels on the x, dy and weight of
   ``head`` and ``FPN.smooth_conv.0`` from one bf16 step, against the plain
   versions, with cuDNN's own gradients printed beside them (not gated);
11. DeepLabV3+-Xception main path: ``segtpu_torch.train.main`` trains
    DeepLab with segtpu's Xception at full width and depth (output stride
    16; 19 classes, 769x769, batch 8, uint8 transport, bf16 autocast) under
    CE_DiceLoss and AdamW with OneCycle for a few steps and a validation
    pass (no hand-written kernel: every count 0), then times and traces the
    step as in phase 6, the trace recording op shapes so that the depthwise
    convs' kernels (forward and backward) form a category of their own;
    the inference CLI, sliding bf16, on one seeded 1024x2048 frame with its
    best_model;
12. DeepLabV3+-R101 main path: the same at output stride 16 with the exact
    LovaszSoftmax and SGD under Poly, with the traced ms of the Lovász sort,
    its cumsums and its gathers per step;
13. the zoo paths at segtpu's defaults, full width and depth, each through
    ``segtpu_torch.train.main`` (19 classes, 769x769, batch 8, uint8
    transport, bf16 autocast, CE, two-group SGD under Poly) for 2 steps, then
    timed and traced as in phase 6, with no hand-written kernel (every count
    0): DeepLab_DUC_HDC-R101 (HDC "rf", output stride 8; with a validation
    pass, then the inference CLI, sliding bf16, on one 1024x2048 frame with
    its best_model), UNet, UNetResnet-R50, SegNet and SegResNet; the trace
    records op shapes and arguments, so that transposed convs, the max
    unpools and the pixel shuffles (forward and backward) form categories of
    their own. On SegResNet, two eval forwards of one batch give the same
    bits, and the card's ``max_unpool_flat`` on a bf16 step's own decoder
    tensor and stem-pool indices equals the CPU's bit for bit, forward and
    backward, with the indices' repeats counted. Then the last four models:
    ENet (with a validation pass, then the inference CLI, sliding bf16, on
    one frame), GCN-R50 (torchvision ResNet-50, bilinear decoder; the device
    ms of ``br9``'s two 3x3 convs at 19 channels over 769x769, beside their
    bound), GCN-ResnetGCN-deconv (timed, not traced), FCN8 (plain VGG-16,
    the fixed bilinear upsamplers as transposed convs; the device ms of
    conv6, 7x7 from 512 to 4096 channels, beside its bound) and PSPDenseNet-201
    with ``remat_backbone`` off (traced) and on (timed, not traced), each
    with its peak memory;
14. losses on the card: every name of the port's ``LOSSES``, plus
    ``lovasz_hinge`` and ``binary_xloss``, on bf16 logits 8x19x769x769 with
    255-ignored labels: forward + backward ms and peak memory at full size;
    value and logit gradient at a LOSS_CROP crop of the same draw, in
    float64 and float32 on the card, against float64 on the CPU;
15. optimizers and freezes on the card: PSPNet-R50 with the stem kernel at
    769x769, batch 8, 2 steps each of Adam, AdamW, centered RMSprop, Adagrad
    with lr_decay, SGD under OneCycle, freeze_backbone and freeze_bn from
    one set of weights: losses finite, the stem kernel's launches per step,
    the frozen backbone's parameters and the frozen running statistics bit
    for bit; AdamW under OneCycle saved after its first step and resumed,
    its resumed loss equal to the uninterrupted run's;
16. data: CityScapes on disk: a seeded CityScapes fine tree (32 train and
    8 val 1024x2048 frames, raw label ids 0-33) written to the work
    directory; the port's CityScapes loader alone (base 2048, 769 crops,
    scale, rotate, flip and blur, batch 8, 8 workers) in samples/s with
    thread and with process workers, whose batches must be bit-identical,
    with labels in {0..18, 255}, and equal bit for bit once prefetched to
    the card; PSPNet-R50 trained from it through ``segtpu_torch.train.main``
    for 4 steps and a validation pass with the stem kernel on (4 launches,
    the counts set to 0 just before and read just after), D and B from the
    epoch log and per step; the train step on one device-resident batch,
    then 5 timed and 3 traced steps fed by the prefetcher from the disk
    loader; the repo's ``config.json`` (only data_dir, save_dir and epochs
    set) trained for 5 steps and its validation on a view of the tree; the
    inference CLI, sliding bf16, on one frame with the 769 run's best_model;
    every run writes its tensorboard events into the work directory;
17. pretrained encoders: a seeded encoding-style resnet50s.pth in the work
    directory, and PSPNet-R50 trained from it through
    ``segtpu_torch.train.main`` with the main path's flags, tensorboard and
    ``profile: 2``: before its first step the backbone equals the file and
    the rest a model built from the same seed, bit for bit; one stem launch
    a step; the load time; the timed ms/step beside the main path's; the
    event file read back (framing, both CRCs, tags and steps, the logged
    losses against the steps'); the val grid's write time at one row and at
    15 rows (11535x2307: PNG and CRC); the profile's Chrome trace naming the
    stem kernel. PSPDenseNet-201 from a seeded densenet201.pth on the 7x7
    stem: the same state check, ms/step and peak memory beside the
    from-scratch stem's. Then one seeded file per remaining family
    (UperNet-R101, SegNet, FCN8 with FC6/FC7, DeepLab-Xception,
    GCN-ResnetGCN-R50 from a plain ResNet-50 file, SegResNet) loaded into
    the model on the card, bit for bit, with its load seconds;
18. the script's time, the ``kernels`` JSON line (each kernel's launches on
    every path above), then the card's name and power limit, then
    ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises and exits non-zero; without a GPU it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
import types
import zlib

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
MAIN_SHAPE = (8, 769, 769, 3, 64, 3)  # n, h, w, c, co, k of the stem conv
TEST_SHAPES = [(2, 65, 65, 3, 64, 7), (1, 32, 48, 3, 16, 7),
               (2, 64, 64, 4, 32, 7), (2, 65, 65, 3, 64, 3),
               (2, 33, 47, 5, 16, 3),
               # shapes the kernel once refused (tap groups, padded o tiles)
               (1, 33, 33, 6, 64, 7), (1, 33, 33, 3, 48, 3), (2, 33, 47, 5, 19, 3),
               (1, 17, 17, 64, 64, 7),
               # several o tiles at Wo < 64; 64-pixel tiles that end short at Wo 129
               (1, 9, 9, 3, 600, 3), (2, 257, 257, 3, 64, 3)]
# the stem kernel's timed shapes: the main path's, and k 7 on the same x
# and dy width
STEM_TIMED = {MAIN_SHAPE: "PSPNet-R50 stem (main path)",
              (8, 769, 769, 3, 64, 7): "the same x and dy width at k 7"}
# flat-row conv shapes (n, h, w, c, o, k, p, d): the cases of
# tests/test_flatconv.py, then the full-width layers of the two models
FLAT_TEST_CASES = [
    (2, 33, 33, 64, 64, 3, 1, 1), (2, 33, 33, 64, 128, 3, 1, 1),
    (1, 25, 25, 512, 19, 3, 1, 1), (2, 17, 29, 8, 16, 3, 1, 1),
    (2, 21, 21, 32, 48, 1, 0, 1), (1, 27, 27, 16, 24, 3, 2, 2),
    (3, 15, 15, 24, 8, 5, 2, 1)]
STEM_CONV2 = (8, 385, 385, 64, 64, 3, 1, 1)
UPERNET_HEAD = (8, 193, 193, 256, 19, 3, 1, 1)
FLAT_FULL_SHAPES = {
    STEM_CONV2: "PSPNet-R50 stem_conv2",
    (8, 385, 385, 64, 128, 3, 1, 1): "PSPNet-R50 stem_conv3",
    (8, 97, 97, 512, 512, 3, 4, 4): "PSPNet-R50 layer4 dilated conv2",
    UPERNET_HEAD: "UperNet-R101 head",
    (8, 193, 193, 256, 256, 3, 1, 1): "UperNet-R101 FPN.smooth_conv.0",
}
# relative error (max |kernel - plain| / max |plain|): the JAX kernel test's
# tolerance; both sides sum bf16-rounded products in fp32, in other orders
WGRAD_REL_TOL = 5e-3
BF16_U = 2.0 ** -8  # unit roundoff of bf16 (8 significant bits, round to nearest)
# flat dgrad: both sides round fp32 sums to bf16, so an element may land one
# bf16 ulp apart, at most 2**-7 of the largest value (held with <=)
DGRAD_REL_TOL = 2.0 ** -7
# flat_conv's gradients against fp32 autograd through F.conv2d: segtpu's
# 2e-2 for the bf16 rounding of x, dy and w
GRAD_REL_TOL = 2e-2
STEPS = 4
BATCH, CROP, CLASSES = 8, 769, 19
# the resumed run's losses against the uninterrupted run's: update 3 starts
# from the same state, batch and dropout masks and must be equal; update 4
# comes after one backward whose atomic adds sum in another order, and must
# be within this, relative (its readings were 0.5e-3 to 1.4e-3 apart)
RESUME_LOSS_TOL = 5e-3
FRAME = (1024, 2048)  # the inference phase's images, a CityScapes frame
# the sliding canvas against the plain tile-by-tile loop, relative to the
# largest logit: fp32 (TF32 off), batch-16 against batch-1 forwards (the CPU
# tests' tolerance against segtpu)
INFER_TOL = 1e-4
# exported program against the eager serve module: max |confidence
# difference|, and the top-two margin below which a prediction may differ
SERVE_TOL = 1e-3
TIMED_STEPS, TRACED_STEPS = 5, 3
# kernel-name substrings -> category of the traced step, first match wins
CATEGORIES = [
    ("stem_wgrad", "stem weight gradient (segtpu_torch CUDA kernel)"),
    ("Sort", "sort (Lovász)"),
    ("sort", "sort (Lovász)"),
    ("Scan", "cumsum (Lovász)"),
    ("scan", "cumsum (Lovász)"),
    ("scatter_gather", "gather (Lovász, CE)"),
    ("flat_wgrad", "flat-row conv wgrad (segtpu_torch CUDA kernel)"),
    ("flat_dgrad", "flat-row conv dgrad (segtpu_torch CUDA kernel)"),
    ("adaptive_average", "adaptive average pool (PSP pyramid)"),
    ("upsample", "bilinear resize"),
    ("batch_norm", "batch norm"),
    ("max_pool", "max pool"),
    ("xmma", "convolution (cuDNN)"),
    ("conv", "convolution (cuDNN)"),
    ("nvjet", "matmul (cuBLAS)"),
    ("gemm", "matmul (cuBLAS)"),
    ("reduce_kernel", "reductions (loss, stats)"),
    ("CatArray", "concat"),
    ("cat", "concat"),
    ("elementwise", "elementwise and copies"),
    ("copy", "elementwise and copies"),
]


def phase(name):
    print(f"== {name}", flush=True)


def smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref):
    diff = (got.float() - ref.float()).abs().max().item()
    return diff / max(ref.float().abs().max().item(), 1e-30), diff


def bound(nbytes, flops):
    """(bound ms, "bytes" or "operations") on the card's peak rates."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def wgrad_inputs(shape, seed, device):
    import torch

    n, h, w, c, co, k = shape
    ho, wo = (h + 2 * (k // 2) - k) // 2 + 1, (w + 2 * (k // 2) - k) // 2 + 1
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g, device=device)
    dy = torch.randn(n, ho, wo, co, generator=g, device=device)
    return x, dy


def flat_inputs(case, seed, device):
    """bf16 NHWC x and dy and an HWIO fp32 weight of a flat-row conv."""
    import torch

    n, h, w, c, o, k, _, _ = case
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g, device=device).bfloat16()
    dy = torch.randn(n, h, w, o, generator=g, device=device).bfloat16()
    wk = torch.randn(k, k, c, o, generator=g, device=device) * 0.05
    return x, dy, wk


def check_flat(label, x, dy, wk, k, p, d):
    """Both flat-row kernels on NHWC x, dy and HWIO wk, held against the
    plain versions on the same tensors; returns the (wgrad, dgrad) max abs
    errors."""
    from segtpu_torch.ops import flatconv as fc

    got_w = fc.flat_conv_wgrad(x, dy, (k, k), p, d)
    got_d = fc.flat_conv_dgrad(dy, wk, (k, k), p, d)
    ref_w = fc.flat_conv_wgrad_plain(x, dy, (k, k), p, d)
    ref_d = fc.flat_conv_dgrad_plain(dy, wk, (k, k), p, d)
    err_w, abs_w = rel_err(got_w, ref_w)
    err_d, abs_d = rel_err(got_d, ref_d)
    print(f"{label}: flat_conv_wgrad rel err {err_w:.3e}, max abs err {abs_w:.3e} "
          f"(tol {WGRAD_REL_TOL}); flat_conv_dgrad rel err {err_d:.3e}, max abs "
          f"err {abs_d:.3e} (tol {DGRAD_REL_TOL:.3e})", flush=True)
    check(got_w.shape == ref_w.shape and got_d.shape == ref_d.shape
          and got_d.dtype == ref_d.dtype, f"shapes or dtypes at {label}")
    check(err_w < WGRAD_REL_TOL, f"flat_conv_wgrad disagrees at {label}: {err_w}")
    check(err_d <= DGRAD_REL_TOL, f"flat_conv_dgrad disagrees at {label}: {err_d}")
    return abs_w, abs_d


def smoke_config(arch, save_dir, save_period=10, save_per_iters=0, steps=STEPS,
                 val=True):
    synthetic = {"num_classes": CLASSES, "batch_size": BATCH, "crop_size": CROP,
                 "num_workers": 8, "device_normalize": True}
    return {
        "name": "ChipSmoke", "seed": 0,
        "arch": arch,
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": BATCH * steps, "image_hw": 800,
            "flip": True, "shuffle": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": BATCH, "image_hw": CROP, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "log_per_iter": 1, "val": val,
                    "monitor": "max Mean_IoU", "compute_dtype": "bfloat16",
                    "save_dir": save_dir, "save_period": save_period,
                    "save_per_iters": save_per_iters,
                    "log_dir": os.path.join(os.path.dirname(save_dir), "runs")},
    }


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise RuntimeError("chip_smoke: torch.profiler event without a device time")


DEPTHWISE = "depthwise conv (cuDNN)"
TRANSPOSED = "transposed conv (cuDNN)"
UNPOOL = "max unpool"
PIXEL_SHUFFLE = "pixel shuffle"


def _depthwise_op(evt) -> bool:
    """A traced convolution op (forward or backward) whose weight is (C, 1,
    k, k) on a C-channel input, C > 1; the shapes are recorded ones."""
    shapes = getattr(evt, "input_shapes", None) or []
    if evt.name == "aten::convolution" and len(shapes) > 1:
        x, w = shapes[0], shapes[1]
    elif evt.name == "aten::convolution_backward" and len(shapes) > 2:
        x, w = shapes[1], shapes[2]
    else:
        return False
    return (len(x) == 4 and len(w) == 4 and w[1] == 1 and w[0] == x[1] > 1)


def _transposed_op(evt) -> bool:
    """A transposed convolution: ``aten::conv_transpose2d``, or a
    convolution backward whose recorded ``transposed`` argument is true."""
    if evt.name == "aten::conv_transpose2d":
        return True
    args = getattr(evt, "concrete_inputs", None) or []
    return evt.name == "aten::convolution_backward" and len(args) > 7 and args[7] is True


def _unpool_op(evt) -> bool:
    """SegNet's ``max_unpool2d`` and SegResNet's ``max_unpool_flat``,
    forward and backward."""
    return (evt.name in ("aten::max_unpool2d", "_MaxUnpoolFlat")
            or evt.name.endswith(("MaxUnpool2DBackward0", "_MaxUnpoolFlatBackward")))


def _pixel_shuffle_op(evt) -> bool:
    return evt.name == "aten::pixel_shuffle" or evt.name.endswith("PixelShuffleBackward0")


def _conv_on(x_shape, w_shape):
    """A predicate: a traced convolution op, forward or backward, of an
    input of ``x_shape`` (NCHW) and a weight of ``w_shape`` (OIHW); the
    backward is told by its recorded gradient's, input's and weight's
    shapes."""
    x_shape, w_shape = list(x_shape), list(w_shape)

    def pred(evt):
        shapes = getattr(evt, "input_shapes", None) or []
        if evt.name == "aten::convolution" and len(shapes) > 1:
            return shapes[0] == x_shape and shapes[1] == w_shape
        if evt.name == "aten::convolution_backward" and len(shapes) > 2:
            return shapes[1] == x_shape and shapes[2] == w_shape
        return False

    return pred


#: traced ops whose kernels form a category of their own (op shapes and
#: arguments recorded in the trace)
DEPTHWISE_OP = (_depthwise_op, DEPTHWISE)
TRANSPOSED_OP = (_transposed_op, TRANSPOSED)
UNPOOL_OP = (_unpool_op, UNPOOL)
PIXEL_SHUFFLE_OP = (_pixel_shuffle_op, PIXEL_SHUFFLE)


def _kernels_under(evt):
    """(name, device us) of every kernel launched by ``evt`` or its CPU
    children."""
    out = [(k.name, k.duration) for k in getattr(evt, "kernels", [])]
    for child in evt.cpu_children:
        out += _kernels_under(child)
    return out


def _op_kernels(prof, ops):
    """{category: {kernel name: device us}} of the kernels launched under
    the outermost traced op that each ``(predicate, category)`` of ``ops``
    matches, the first match winning."""
    out = {cat: {} for _, cat in ops}

    def walk(evt):
        for pred, cat in ops:
            if pred(evt):
                for name, us in _kernels_under(evt):
                    out[cat][name] = out[cat].get(name, 0.0) + us
                return
        for child in evt.cpu_children:
            walk(child)

    for evt in prof.events():
        if evt.cpu_parent is None:
            walk(evt)
    return out


def profile_steps(step, steps, card, ops=()):
    """Trace ``steps`` calls of ``step``; print the wall and device time per
    step, the idle share and the device time by kernel category. With
    ``ops``, (predicate, category) pairs, the trace records op shapes and
    arguments, and the kernels launched under each matching op (forward and
    backward) form a category of their own; returns the device ms per step
    by category."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(ops)) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    # device events, less the spans that record_function annotations (the
    # optimizer's step) also put on the device timeline over its kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / steps
    check(busy_ms > 0, "the traced steps show no device time")
    print(f"traced: {steps} steps, wall {wall_ms:.1f} ms/step, device busy "
          f"{busy_ms:.1f} ms/step, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} "
          f"[{card}]")
    by_op = _op_kernels(prof, ops) if ops else {}
    # kernel name -> device us attributed to an op category
    taken = {}
    for per_kernel in by_op.values():
        for name, us in per_kernel.items():
            taken[name] = taken.get(name, 0.0) + us
    sums = {}
    for e in kernels:
        cat = next((c for key, c in CATEGORIES if key in e.key), "other")
        us = device_us(e) - min(taken.get(e.key, 0.0), device_us(e))
        sums[cat] = sums.get(cat, 0.0) + us / 1e3 / steps
    for cat, per_kernel in by_op.items():
        sums[cat] = sum(per_kernel.values()) / 1e3 / steps
        print(f"  {cat} (op shapes recorded in this trace), its kernels (ms/step):")
        for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {us / 1e3 / steps:8.3f}  {name[:100]}")
    for cat, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms/step {ms / busy_ms:6.3f}  {cat}")
    other = [e for e in kernels if not any(key in e.key for key, _ in CATEGORIES)]
    for title, events in (("largest kernels", kernels), ("largest of other", other)):
        print(f"  {title} (ms/step, calls/step):")
        for e in sorted(events, key=device_us, reverse=True)[:8 if events is kernels else 4]:
            print(f"  {device_us(e) / 1e3 / steps:8.3f} {e.count / steps:5.1f}  {e.key[:100]}")
    return sums


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def reset_launches():
    from segtpu_torch.ops import conv_wgrad as cw
    from segtpu_torch.ops import flatconv as fc

    for fn in (cw.stem_conv_wgrad, fc.flat_conv_wgrad, fc.flat_conv_dgrad):
        fn.launches = 0


def read_launches():
    from segtpu_torch.ops import conv_wgrad as cw
    from segtpu_torch.ops import flatconv as fc

    return {fn.__name__: fn.launches
            for fn in (cw.stem_conv_wgrad, fc.flat_conv_wgrad, fc.flat_conv_dgrad)}


def train_main_path(label, config, want_launches, card, recorder, after_train=None,
                    ops=(), trace=True):
    """Train ``config`` through ``segtpu_torch.train.main`` with the launch
    counts set to 0 just before and read just after, its steps recorded;
    check the epoch log (and its validation, where the config runs one);
    call ``after_train(trainer)``; check an eval step; time and, with
    ``trace``, trace the train step (outside the recorded run; ``ops`` as in
    ``profile_steps``). Returns (trainer, launches, one device-resident
    train batch, one val batch, the timed step's numbers with the traced
    device ms by category, None untraced)."""
    import torch

    from segtpu_torch import train as train_cli
    from segtpu_torch.data import DevicePrefetcher

    dev = torch.device("cuda")
    steps = config["train_loader"]["args"]["size"] // BATCH
    val = config["trainer"]["val"]
    recorder.start()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main(config, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    recorder.stop()
    print(f"trainer: {trainer.state.step} steps{' + validation' if val else ''} in "
          f"{wall:.1f} s (model build and data included); launches {launches}")
    check(trainer.state.step == steps, f"{trainer.state.step} steps, want {steps}")
    check(launches == want_launches,
          f"{label} launched {launches} in {steps} steps, want {want_launches}")
    log = trainer.history[-1]
    check(math.isfinite(log["loss"]), f"non-finite loss {log}")
    check(all(math.isfinite(r["loss"]) for r in recorder.steps),
          f"non-finite step losses {recorder.steps}")
    if val:
        print(f"epoch log: loss {log['loss']}, val_loss {log['val_loss']}, "
              f"Mean_IoU {log['Mean_IoU']}, Pixel_Accuracy {log['Pixel_Accuracy']}")
        check(math.isfinite(log["val_loss"]), f"non-finite val loss {log}")
    else:
        print(f"epoch log: loss {log['loss']}, Mean_IoU {log['Mean_IoU']}, "
              f"Pixel_Accuracy {log['Pixel_Accuracy']} (train batches; no validation)")
    check(0.0 <= log["Mean_IoU"] <= 1.0 and 0.0 <= log["Pixel_Accuracy"] <= 1.0,
          f"metrics out of range {log}")
    check([r["stem_launches"] for r in recorder.steps]
          == [want_launches["stem_conv_wgrad"] // steps] * steps,
          f"stem kernel launches per step {recorder.steps}")
    if after_train is not None:
        after_train(trainer)
        phase(f"main path: {label}, timed")

    val_images, val_labels = next(iter(DevicePrefetcher(trainer.val_loader, dev)))
    loss, stats, _ = trainer.eval_step(trainer.model, val_images, val_labels)
    correct, labeled = float(stats.correct), float(stats.labeled)
    check(math.isfinite(float(loss)), "non-finite eval loss")
    check(labeled == BATCH * CROP * CROP, f"labeled {labeled}")
    check(0 <= correct <= labeled and float(stats.inter.sum()) == correct
          and bool((stats.inter <= stats.union).all()), f"SegStats {stats}")

    images, labels = next(iter(DevicePrefetcher(trainer.train_loader, dev)))
    torch.cuda.reset_peak_memory_stats()
    step_s, step_losses = [], []

    def step():
        step_losses.append(trainer.train_step(trainer.state, images, labels)[0])

    for i in range(2 + TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - t)
    ms_step = 1e3 * sum(step_s) / len(step_s)
    print(f"main path: {label} {CROP}x{CROP} bs{BATCH} bf16 train step "
          f"{ms_step:.1f} ms/step (min {1e3 * min(step_s):.1f}), "
          f"{BATCH * 1e3 / ms_step:.2f} imgs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    numbers = {"ms_per_step": ms_step, "imgs_per_s": BATCH * 1e3 / ms_step,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "device_ms_by_category": None}
    if trace:
        numbers["device_ms_by_category"] = profile_steps(step, TRACED_STEPS, card, ops=ops)
    else:
        print(f"{label}: not traced (idle share and device ms not measured on this path)")
    # the timed and traced steps' own losses: no time above is of a state
    # gone to inf or NaN
    losses_ = [float(v) for v in step_losses]
    print(f"{label}: losses of the {len(losses_)} warm-up, timed"
          f"{' and traced' if trace else ''} steps {losses_}")
    check(all(math.isfinite(v) for v in losses_), f"{label}: non-finite timed step losses")
    return trainer, launches, (images, labels), (val_images, val_labels), numbers


def keep_io(store):
    """Forward hook that keeps a conv's input x, and through tensor hooks the
    gradients at its output (dy) and at its input (cuDNN's dx)."""
    def hook(module, args, out):
        store["x"] = args[0].detach()
        out.register_hook(lambda g: store.__setitem__("dy", g.detach()))
        if args[0].requires_grad:
            args[0].register_hook(lambda g: store.__setitem__("dx", g.detach()))
    return hook


def flat_in_step(label, conv, store):
    """Both flat-row kernels on a conv's own x, dy and weight from a bf16
    step, against the plain versions (gated); cuDNN's own gradients from the
    step against the plain versions (printed only)."""
    from segtpu_torch.ops import flatconv as fc

    k, p, d = conv.kernel_size[0], conv.padding[0], conv.dilation[0]
    x, dy = store["x"].permute(0, 2, 3, 1), store["dy"].permute(0, 2, 3, 1)
    wk = conv.weight.detach().permute(2, 3, 1, 0)
    print(f"{label}: x {tuple(x.shape)} {x.dtype}, dy {tuple(dy.shape)} {dy.dtype} "
          f"(NHWC), k={k}, p={p}, d={d}")
    abs_w, abs_d = check_flat(f"{label}, the step's own x, dy and weight",
                              x, dy, wk, k, p, d)
    ref_w = fc.flat_conv_wgrad_plain(x, dy, (k, k), p, d)
    cudnn_w = conv.weight.grad.permute(2, 3, 1, 0)
    msg = (f"{label}: cuDNN's bf16 step gradients vs the plain versions (not "
           f"checked): weight rel err {rel_err(cudnn_w, ref_w)[0]:.3e}")
    if "dx" in store:
        ref_d = fc.flat_conv_dgrad_plain(dy, wk, (k, k), p, d)
        msg += f", input rel err {rel_err(store['dx'].permute(0, 2, 3, 1), ref_d)[0]:.3e}"
    print(msg)
    return abs_w, abs_d


def step_backward(trainer, model, state, images, labels, dtype):
    """One forward and backward of ``model`` from the weights ``state`` in
    ``dtype``, without an update, with the same dropout masks every time."""
    import torch

    from segtpu_torch.core.steps import _forward_loss, prep_images

    model.load_state_dict(state)
    model.train()
    model.zero_grad(set_to_none=True)
    torch.manual_seed(1234)
    x = prep_images(images, trainer.norm_stats, dtype)
    loss, _ = _forward_loss(model, x, labels, trainer.loss_fn, 255, 0.4, dtype)
    loss.backward()


class StepRecorder:
    """Wraps the train steps that ``segtpu_torch.trainer`` builds; between
    ``start()`` and ``stop()`` each step records its update count, a
    fingerprint of its batch, its learning rates, its loss and the stem
    kernel's launches in it (the float(loss) read syncs; timed steps run
    outside, where the wrapper only passes through). With ``snap_before``
    set to an update count, the step that starts from it first copies the
    state it starts from into ``snap`` (see ``snapshot``)."""

    def __init__(self):
        import segtpu_torch.trainer as trainer_mod

        self.steps, self.on, self.snap_before, self.snap = [], False, None, None
        make = trainer_mod.make_train_step

        def make_recorded(*args, **kwargs):
            step = make(*args, **kwargs)

            def recorded(state, images, labels):
                if not self.on:
                    return step(state, images, labels)
                from segtpu_torch.ops import conv_wgrad as cw

                if state.step == self.snap_before and self.snap is None:
                    self.snap = snapshot(state)
                before = cw.stem_conv_wgrad.launches
                t_in = time.perf_counter()
                loss, stats = step(state, images, labels)
                sample = (labels[:, ::7, ::7].cpu().numpy().tobytes()
                          + images[:, ::7, ::7].cpu().numpy().tobytes())
                self.steps.append({
                    "step": state.step, "batch": zlib.crc32(sample),
                    "lrs": [g["lr"] for g in state.optimizer.param_groups],
                    "loss": float(loss),
                    "stem_launches": cw.stem_conv_wgrad.launches - before,
                    "t_in": t_in, "t_out": time.perf_counter()})
                return loss, stats

            return recorded

        trainer_mod.make_train_step = make_recorded

    def start(self):
        self.steps, self.snap, self.on = [], None, True

    def stop(self):
        self.on = False


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def snapshot(state):
    """Copies, on the card, of what a train step starts from: the model's
    tensors, the momentum buffers, the update count and the CPU and CUDA
    generators (dropout draws from them)."""
    import torch

    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "momentum": [None if buf is None else buf.clone() for buf in (
                state.optimizer.state.get(p, {}).get("momentum_buffer")
                for p in params)],
            "step": state.step,
            "rng": (torch.get_rng_state(), torch.cuda.get_rng_state())}


def same_snapshot(a, b):
    """Which parts of two snapshots differ; empty when all are bit-identical."""
    import torch

    def same_tensors(x, y):
        return len(x) == len(y) and all(
            (u is None and v is None)
            or (u is not None and v is not None and torch.equal(u, v))
            for u, v in zip(x, y))

    differ = []
    if a["step"] != b["step"]:
        differ.append("update count")
    if a["model"].keys() != b["model"].keys() or not same_tensors(
            list(a["model"].values()), [b["model"][k] for k in a["model"]]):
        differ.append("model")
    if not same_tensors(a["momentum"], b["momentum"]):
        differ.append("momentum")
    if not all(torch.equal(u, v) for u, v in zip(a["rng"], b["rng"])):
        differ.append("generators")
    return differ


def same_state(a, b):
    """Model tensors, momentum buffers, update count and the optimizer's
    hyperparameters of two TrainStates, bit for bit."""
    import torch

    sa, sb = a.model.state_dict(), b.model.state_dict()
    opt_a, opt_b = a.optimizer, b.optimizer
    params_a = [p for g in opt_a.param_groups for p in g["params"]]
    params_b = [p for g in opt_b.param_groups for p in g["params"]]
    groups = [{k: v for k, v in g.items() if k != "params"} for g in opt_a.param_groups]
    return (a.step == b.step and sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and len(params_a) == len(params_b)
            and all(torch.equal(opt_a.state[pa]["momentum_buffer"],
                                opt_b.state[pb]["momentum_buffer"])
                    for pa, pb in zip(params_a, params_b))
            and groups == [{k: v for k, v in g.items() if k != "params"}
                           for g in opt_b.param_groups])


def checkpoint_and_resume(trainer, config, recorder, workdir, card):
    """The main path's checkpoints: checkpoint-epoch1 loads back bit for bit
    into a fresh state; a resume from the mid-epoch checkpoint-latest starts
    from the uninterrupted run's state and runs the epoch's remaining steps
    on the same batches, at the same first rate, its first loss equal and
    its second within RESUME_LOSS_TOL, one stem launch a step; resumes that
    drop a restore fail those checks. Returns the resumed run's launches and
    the checkpoint's numbers."""
    import copy

    import torch

    from segtpu_torch import train as train_cli
    from segtpu_torch.checkpoint import load_checkpoint, read_meta, save_checkpoint
    from segtpu_torch.core.state import TrainState, make_optimizer
    from segtpu_torch.models import get_model

    run_dir = trainer.checkpoint_dir
    names = sorted(os.listdir(run_dir))
    print(f"run directory {run_dir}: {names}")
    check({"config.json", "checkpoint-epoch1", "checkpoint-latest", "best_model"}
          <= set(names), f"the run wrote {names}")
    epoch1 = os.path.join(run_dir, "checkpoint-epoch1")
    size = dir_bytes(epoch1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = save_checkpoint(workdir, "timed-save", trainer.state, 1, trainer.mnt_best,
                            config, "PSPNet")
    save_s = time.perf_counter() - t0
    shutil.rmtree(timed)
    opt_cfg = config["optimizer"]
    model = get_model("PSPNet", device="cuda", seed=1, num_classes=CLASSES,
                      **config["arch"]["args"])
    opt, schedules = make_optimizer(model, differential_lr=opt_cfg["differential_lr"],
                                    num_epochs=1, iters_per_epoch=STEPS,
                                    **opt_cfg["args"])
    fresh = TrainState(model, opt, schedules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = load_checkpoint(epoch1, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    identical = same_state(fresh, trainer.state)
    print(f"checkpoint-epoch1: {size / 1e6:.1f} MB (model, SGD momentum, update "
          f"count, generators), save {save_s:.2f} s, load {load_s:.2f} s; loads back "
          f"bit-identical to the live state (model, optimizer, update count "
          f"{fresh.step}): {identical} [{card}]", flush=True)
    check(identical, "checkpoint-epoch1 does not load back to the live state")
    check(meta["epoch"] == 1 and meta["arch"] == "PSPNet", f"meta {meta}")
    del fresh, model, opt

    latest = os.path.join(run_dir, "checkpoint-latest")
    meta = read_meta(latest)
    check((meta.get("resume_epoch"), meta.get("resume_iter")) == (1, 2),
          f"checkpoint-latest meta {meta}")
    first, uninterrupted = recorder.steps, recorder.snap
    check(uninterrupted is not None and uninterrupted["step"] == 2,
          "the uninterrupted run kept no copy of the state its update 3 starts from")
    import segtpu_torch.trainer as trainer_mod

    real_load = trainer_mod.load_checkpoint

    def resume_run(label, load):
        """A run resumed from checkpoint-latest through the train CLI, with
        the trainer's ``load_checkpoint`` replaced by ``load``: its recorded
        steps, the state its first update starts from, its launches (the
        counts set to 0 just before it and read just after), its update
        count and its wall time."""
        cfg = copy.deepcopy(config)
        cfg["trainer"].update(save_dir=os.path.join(workdir, label), save_period=10,
                              save_per_iters=0)
        trainer_mod.load_checkpoint = load
        try:
            recorder.start()
            reset_launches()
            t0 = time.perf_counter()
            resumed = train_cli.main(cfg, "cuda", resume=latest)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            recorder.stop()
        finally:
            trainer_mod.load_checkpoint = real_load
        return recorder.steps, recorder.snap, launches, resumed.state.step, wall

    def loss_diffs(got):
        return [abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(got, first[2:])]

    def within_limits(got):
        diffs = loss_diffs(got)
        return len(diffs) == 2 and diffs[0] == 0.0 and diffs[1] <= RESUME_LOSS_TOL

    got, snap, launches, step, wall = resume_run("resumed", real_load)
    print(f"resumed from checkpoint-latest (epoch 1, batch 2): {len(got)} steps + "
          f"validation in {wall:.1f} s (model build included); launches {launches}")
    differ = same_snapshot(snap, uninterrupted) if snap else ["all: no copy kept"]
    print(f"  the state update 3 starts from (model, BN statistics, momentum, update "
          f"count, CPU and CUDA generators) is bit-identical to the uninterrupted "
          f"run's: {not differ}" + (f" (differs in {differ})" if differ else ""))
    del snap
    for g, w, rel in zip(got, first[2:], loss_diffs(got)):
        print(f"  update {g['step']}: batch {g['batch']:08x} (uninterrupted "
              f"{w['batch']:08x}), lr {g['lrs']} (uninterrupted {w['lrs']}), loss "
              f"{g['loss']:.6f} (uninterrupted {w['loss']:.6f}, rel diff {rel:.2e}), "
              f"stem launches {g['stem_launches']}")
    check(not differ, f"the resumed run starts update 3 from another state: {differ}")
    check(within_limits(got),
          f"resumed losses {loss_diffs(got)} apart: update 3 must equal the "
          f"uninterrupted run's, update 4 be within {RESUME_LOSS_TOL}")
    check([g["step"] for g in got] == [3, 4] and step == STEPS,
          f"resumed updates {[g['step'] for g in got]}")
    check([g["batch"] for g in got] == [w["batch"] for w in first[2:]],
          "the resumed run took other batches than the uninterrupted one")
    check(got[0]["lrs"] == first[2]["lrs"], "the first resumed rate differs")
    check([g["stem_launches"] for g in got] == [1, 1]
          and launches == {"stem_conv_wgrad": 2, "flat_conv_wgrad": 0,
                           "flat_conv_dgrad": 0},
          f"resumed launches {launches}, per step {[g['stem_launches'] for g in got]}")
    resumed_losses = [g["loss"] for g in got]

    # Controls: resumes that drop one restore must fail the checks above.
    def without_generators(path, state):
        kept = (torch.get_rng_state(), torch.cuda.get_rng_state())
        meta = real_load(path, state)
        torch.set_rng_state(kept[0])
        torch.cuda.set_rng_state(kept[1])
        return meta

    def without_momentum(path, state):
        meta = real_load(path, state)
        state.optimizer.state.clear()
        return meta

    controls = {}
    for label, load in (("without the generators' restore", without_generators),
                        ("without the momentum buffers' restore", without_momentum)):
        got, snap, _, _, _ = resume_run("control", load)
        differ = same_snapshot(snap, uninterrupted) if snap else ["all: no copy kept"]
        diffs = loss_diffs(got)
        caught = not within_limits(got)
        print(f"control, a resume {label}: loss rel diffs {diffs} (update 3 must be "
              f"0, update 4 within {RESUME_LOSS_TOL}): the loss limits "
              f"{'catch' if caught else 'do not catch'} it; the state update 3 "
              f"starts from differs in {differ}")
        check(bool(differ), f"the state check misses a resume {label}")
        controls[label] = {"loss_rel_diffs": diffs, "losses_catch": caught,
                           "state_differs_in": differ}
        del snap
        shutil.rmtree(os.path.join(workdir, "control"), ignore_errors=True)
    check(controls["without the generators' restore"]["losses_catch"],
          "the loss limits miss a resume that drops the generators")
    recorder.snap_before = None
    del uninterrupted
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"checkpoint_mb": size / 1e6, "save_s": save_s, "load_s": load_s,
                      "resumed_losses": resumed_losses,
                      "uninterrupted_losses": [w["loss"] for w in first[2:]],
                      "controls": controls}


def block_frame(rng, with_ids=False):
    """A FRAME-sized uint8 RGB image: 64-pixel blocks of colour plus noise,
    structure at several scales. With ``with_ids``, also a uint8 map of
    CityScapes raw label ids 0-33 that follows the blocks."""
    import numpy as np

    blocks = rng.integers(0, 256, (FRAME[0] // 64, FRAME[1] // 64, 3))
    pixels = np.repeat(np.repeat(blocks, 64, 0), 64, 1) + rng.normal(0, 20, FRAME + (3,))
    pixels = np.clip(pixels, 0, 255).astype(np.uint8)
    if not with_ids:
        return pixels
    ids = np.repeat(np.repeat(blocks.sum(-1) % 34, 64, 0), 64, 1).astype(np.uint8)
    return pixels, ids


def varied_checkpoint(best, workdir, seed, batch):
    """A checkpoint of a PSPNet-R50 freshly built from ``seed`` whose BN
    statistics are those of ``batch`` (normalized NHWC frames like the
    inference images; one train-mode forward with momentum 1): its class
    maps vary over the frame, where best_model's, after a few steps, hold
    one class. Returns its directory."""
    import torch

    from segtpu_torch.checkpoint import load_config_from_checkpoint, save_checkpoint
    from segtpu_torch.core.state import TrainState, make_optimizer
    from segtpu_torch.models import get_model

    config = load_config_from_checkpoint(best)
    model = get_model("PSPNet", device="cuda", seed=seed + 1, num_classes=CLASSES,
                      **config["arch"]["args"])
    norms = {m: m.momentum for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)}
    for m in norms:
        m.momentum = 1.0
    x = torch.from_numpy(batch).to("cuda").permute(0, 3, 1, 2)
    model.train()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model(x.contiguous(memory_format=torch.channels_last))
    for m, momentum in norms.items():
        m.momentum = momentum
    opt, schedules = make_optimizer(model, differential_lr=True, num_epochs=1,
                                    iters_per_epoch=STEPS,
                                    **config["optimizer"]["args"])
    path = save_checkpoint(workdir, "varied", TrainState(model, opt, schedules), 0,
                           float("nan"), config, "PSPNet")
    del model, opt, x
    return path


def inference_phase(best, workdir, seed, card):
    """The inference CLI on ``best`` and on a checkpoint whose class maps
    vary (``varied_checkpoint``), in both modes and both dtypes, on two
    seeded 1024x2048 PNGs; every written class map read back equal to the
    library call's; each checkpoint's fp32 sliding and multiscale (with
    flips) canvases against plain loops. Returns the launches of the CLI
    runs."""
    import numpy as np
    import torch
    from PIL import Image
    from scipy import ndimage

    from segtpu_torch import inference as inference_cli
    from segtpu_torch.checkpoint import load_config_from_checkpoint, load_model_weights
    from segtpu_torch.data import dataset_meta
    from segtpu_torch.inference_lib import (_tile_boxes, make_predictor,
                                            multi_scale_predict, sliding_predict)
    from segtpu_torch.models import get_model

    image_dir = os.path.join(workdir, "images")
    os.makedirs(image_dir)
    rng = np.random.default_rng(seed)
    names = ["frame0", "frame1"]
    for name in names:
        Image.fromarray(block_frame(rng)).save(os.path.join(image_dir, name + ".png"))
    config = load_config_from_checkpoint(best)
    mean, std, _, num_classes = dataset_meta(config)
    frames = []
    for n in names:
        with Image.open(os.path.join(image_dir, n + ".png")) as image:
            rgb = np.asarray(image.convert("RGB"), np.float32)
        frames.append((rgb / 255.0 - np.float32(mean)) / np.float32(std))
    boxes = _tile_boxes(FRAME[0], FRAME[1], 2.5, 1 / 3)[2]
    t0 = time.perf_counter()
    for scale in inference_cli.scales_for(config):
        ndimage.zoom(frames[0], (scale, scale, 1.0), order=1, prefilter=False)
    print(f"inference: the host's scipy zoom of one frame to the "
          f"{len(inference_cli.scales_for(config))} multiscale scales takes "
          f"{time.perf_counter() - t0:.3f} s")
    def against_plain(what, canvas, ref, loop):
        """Hold an fp32 canvas to the plain loop's within INFER_TOL of the
        largest logit, and its class map wherever the top-two margin
        exceeds that."""
        scale = np.abs(ref).max()
        err = np.abs(canvas - ref).max() / scale
        top2 = np.sort(ref, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > INFER_TOL * scale
        same = np.mean((canvas.argmax(-1) == ref.argmax(-1))[clear])
        print(f"inference {what} fp32, {FRAME[0]}x{FRAME[1]}: canvas vs the plain "
              f"{loop} loop (float64 sums): max abs err {err:.3e} of the largest "
              f"logit (tol {INFER_TOL}); class maps agree on {same:.6f} of the pixels "
              f"whose top-two margin exceeds the tol ({1 - clear.mean():.3e} of "
              f"pixels left out); the canvas's class map holds "
              f"{len(np.unique(canvas.argmax(-1)))} classes [{card}]", flush=True)
        check(err <= INFER_TOL and same == 1.0,
              f"{what}: the canvas is off the plain loop's: {err}, {same}")

    total = {name: 0 for name in read_launches()}
    rng = np.random.default_rng(seed + 1)
    batch = np.stack([(block_frame(rng)[:CROP, :CROP] / np.float32(255.0)
                       - np.float32(mean)) / np.float32(std) for _ in range(BATCH)])
    checkpoints = {"best_model": best,
                   "varied": varied_checkpoint(best, workdir, seed, batch)}
    for label, ckpt in checkpoints.items():
        model = get_model(config["arch"]["type"], device="cuda",
                          num_classes=num_classes, **config["arch"]["args"])
        load_model_weights(ckpt, model)
        maps = {}
        for mode in ("sliding", "multiscale"):
            for dtype in ("float32", "bfloat16"):
                out = os.path.join(workdir, f"out-{label}-{mode}-{dtype}")
                reset_launches()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                result = inference_cli.main([
                    "--model", ckpt, "--images", image_dir, "--output", out,
                    "--extension", "png", "--mode", mode, "--dtype", dtype,
                    "--device", "cuda"])
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                launches = read_launches()
                total = {k: total[k] + v for k, v in launches.items()}
                predict = make_predictor(model, compute_dtype=getattr(torch, dtype),
                                         device="cuda")
                seen = []

                def counted(x):
                    seen.append(len(x))
                    return predict(x)

                counted.device = predict.device
                for name, frame in zip(names, frames):
                    with Image.open(os.path.join(out, name + ".png")) as image:
                        check(image.mode == "P", f"{label} {mode} {dtype} {name}: "
                              f"mode {image.mode}, want a palette PNG")
                        written = np.asarray(image)
                    if mode == "sliding":
                        want = sliding_predict(counted, frame, num_classes,
                                               class_map=True)
                    else:
                        want = multi_scale_predict(counted, frame,
                                                   inference_cli.scales_for(config),
                                                   num_classes, class_map=True)
                    check(written.shape == FRAME and np.array_equal(written, want),
                          f"{label} {mode} {dtype} {name}: the PNG differs from the "
                          f"library call's class map on "
                          f"{np.mean(written != want):.3e} of pixels")
                    maps[mode, dtype, name] = written
                secs = ", ".join(f"{t:.3f}" for t in result["seconds"])
                shape = (f"{len(boxes)} tiles ({2 * len(boxes)} with flips) in "
                         f"{len(seen) // len(names)} forwards of {seen[0]}"
                         if mode == "sliding" else
                         f"scales {inference_cli.scales_for(config)}, "
                         f"{len(seen) // len(names)} forwards")
                classes = [len(np.unique(maps[mode, dtype, n])) for n in names]
                print(f"inference {label} {mode} {dtype}: {secs} s per image (the "
                      f"first includes the CLI's first forwards), {shape}; peak "
                      f"memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held "
                      f"before); launches {launches}; {len(names)} PNGs equal to the "
                      f"library call's class maps, holding {classes} classes "
                      f"[{card}]", flush=True)
        # the device-resident sliding pipeline against a plain one: each tile
        # and its mirror image forwarded alone, the canvas summed on the host
        # in float64 (the original repo's loop)
        predict = make_predictor(model, device="cuda")
        canvas = sliding_predict(predict, frames[0], num_classes)
        tile_h, tile_w, _ = _tile_boxes(FRAME[0], FRAME[1], 2.5, 1 / 3)
        ref = np.zeros(canvas.shape, np.float64)
        count = np.zeros(canvas.shape[:2] + (1,), np.float64)
        for y0, y1, x0, x1 in boxes:
            tile = np.zeros((tile_h, tile_w, 3), np.float32)
            tile[:y1 - y0, :x1 - x0] = frames[0][y0:y1, x0:x1]
            x = torch.from_numpy(tile).to("cuda").permute(2, 0, 1)[None]
            logits = 0.5 * (predict(x)[0] + predict(x.flip(-1))[0].flip(-1))
            ref[y0:y1, x0:x1] += logits.permute(1, 2, 0).double().cpu().numpy()[
                :y1 - y0, :x1 - x0]
            count[y0:y1, x0:x1] += 1
        ref /= count
        against_plain(f"{label} sliding", canvas, ref, "tile-by-tile")
        scale = np.abs(ref).max()
        bf16 = sliding_predict(make_predictor(model, compute_dtype=torch.bfloat16,
                                              device="cuda"), frames[0], num_classes)
        print(f"inference {label} sliding bf16, {FRAME[0]}x{FRAME[1]}: canvas vs the "
              f"plain fp32 loop: max abs err {np.abs(bf16 - ref).max() / scale:.3e} of "
              f"the largest logit (not checked)")
        for mode in ("sliding", "multiscale"):
            agree = np.mean([np.mean(maps[mode, "bfloat16", n] == maps[mode, "float32", n])
                             for n in names])
            classes = [len(np.unique(maps[mode, "float32", n])) for n in names]
            largest = [np.bincount(maps[mode, "float32", n].ravel()).max()
                       / maps[mode, "float32", n].size for n in names]
            print(f"inference {label} {mode}: bf16 and fp32 class maps agree on "
                  f"{agree:.6f} of pixels; the fp32 maps hold {classes} classes, "
                  f"the largest covering {', '.join(f'{x:.4f}' for x in largest)} "
                  f"of pixels")
            # the varied checkpoint's multiscale maps give the classes but one
            # under 1% of pixels (its BN statistics are of scale-1 crops), so
            # only more than one class is asked of them
            if label == "varied":
                check(max(largest) < 0.9 if mode == "sliding" else min(classes) > 1,
                      f"the varied checkpoint's {mode} maps hold {classes} classes, "
                      f"the largest covering {largest}: the class-map checks test little")
        if label == "varied":  # best_model's maps hold one class
            # multiscale, with flips, against a plain loop: each scale's frame
            # and its mirror image forwarded and upsampled alone, averaged on
            # the host in float64
            scales = inference_cli.scales_for(config)
            canvas = multi_scale_predict(predict, frames[0], scales, num_classes,
                                         flip=True)
            ref = np.zeros(canvas.shape, np.float64)
            for s in scales:
                zoomed = ndimage.zoom(frames[0], (s, s, 1.0), order=1, prefilter=False)
                x = torch.from_numpy(zoomed).to("cuda").permute(2, 0, 1)[None]
                for mirror in (False, True):
                    logits = predict(x.flip(-1) if mirror else x)
                    up = torch.nn.functional.interpolate(
                        logits, size=FRAME, mode="bilinear", align_corners=True)
                    up = up.flip(-1) if mirror else up
                    ref += 0.5 * up[0].permute(1, 2, 0).double().cpu().numpy()
            ref /= len(scales)
            against_plain(f"{label} multiscale", canvas, ref, "scale-by-scale")
        del model, predict, canvas, ref, bf16, maps
        gc.collect()
        torch.cuda.empty_cache()
    check(all(v == 0 for v in total.values()), f"inference launched {total}")
    return total


def serving_phase(best, workdir, seed, card):
    """Export ``best`` at batch 1 and CROP x CROP on cuda, reload it and run
    it on a seeded uint8 batch beside the eager serve module. Returns the
    launches of the export and the reloaded program's run."""
    import torch

    from segtpu_torch.checkpoint import load_config_from_checkpoint, load_model_weights
    from segtpu_torch.data import dataset_meta
    from segtpu_torch.models import get_model
    from segtpu_torch.serving import ServeModule, export_checkpoint, load_serving_artifact

    out = os.path.join(workdir, "serving")
    reset_launches()
    t0 = time.perf_counter()
    export_checkpoint(best, out, batch=1, hw=(CROP, CROP), device="cuda")
    export_s = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(out, "model.pt2"))
    t0 = time.perf_counter()
    call, meta = load_serving_artifact(out)
    reload_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randint(0, 256, (1, CROP, CROP, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    preds, conf = call(images)
    torch.cuda.synchronize()
    launches = read_launches()

    config = load_config_from_checkpoint(best)
    mean, std, _, num_classes = dataset_meta(config)
    model = get_model(config["arch"]["type"], device="cuda", num_classes=num_classes,
                      **config["arch"]["args"])
    serve = ServeModule(load_model_weights(best, model), mean, std).to("cuda").eval()
    with torch.no_grad():
        want_preds, want_conf = serve(images)
        top2 = torch.softmax(serve.logits(images), 1).topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > SERVE_TOL
    conf_err = (conf - want_conf).abs().max().item()
    mismatched = ((preds != want_preds) & clear).sum().item()
    program_ms = cuda_ms(lambda: call(images), iters=10)
    with torch.no_grad():
        eager_ms = cuda_ms(lambda: serve(images), iters=10)
    print(f"serving export at batch 1, {CROP}x{CROP}, bf16, cuda: export {export_s:.1f} s, "
          f"model.pt2 {size / 1e6:.1f} MB, reload {reload_s:.1f} s; launches {launches}; "
          f"predictions {tuple(preds.shape)} {preds.dtype}, confidence {conf.dtype}; "
          f"max |confidence - eager| {conf_err:.3e} (tol {SERVE_TOL}); predictions "
          f"differ from eager on {mismatched} pixels whose top-two margin exceeds "
          f"the tol ({1 - clear.float().mean().item():.2e} of pixels are within it); "
          f"program {program_ms:.2f} ms, eager module {eager_ms:.2f} ms a call [{card}]",
          flush=True)
    check(preds.dtype == torch.int32 and conf.dtype == torch.float32
          and tuple(preds.shape) == tuple(conf.shape) == (1, CROP, CROP),
          f"serving outputs {preds.shape} {preds.dtype}, {conf.shape} {conf.dtype}")
    check(meta["platforms"] == ["cuda"] and meta["num_classes"] == CLASSES,
          f"serving.json {meta}")
    check(conf_err <= SERVE_TOL and mismatched == 0,
          f"the exported program disagrees with the eager module ({conf_err}, "
          f"{mismatched})")
    check(all(v == 0 for v in launches.values()), f"serving launched {launches}")
    return launches


DISK_TRAIN, DISK_VAL = 32, 8  # frames of the seeded CityScapes tree
DISK_LABELS = set(range(CLASSES)) | {255}


def write_cityscapes_tree(root, seed):
    """A CityScapes fine tree under ``root``: DISK_TRAIN train and DISK_VAL
    val frames of FRAME size (``block_frame`` content) with raw label ids
    0-33 that follow the blocks, ignored ids among them; PNG compress level
    1, written by 8 threads. Returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    def write(job):
        split, i = job
        rng = np.random.default_rng([seed, i, split == "val"])
        pixels, ids = block_frame(rng, with_ids=True)
        stem = f"cityA_{i:06d}_000019"
        Image.fromarray(pixels).save(os.path.join(
            root, "leftImg8bit_trainvaltest/leftImg8bit", split, "cityA",
            stem + "_leftImg8bit.png"), compress_level=1)
        Image.fromarray(ids).save(os.path.join(
            root, "gtFine_trainvaltest/gtFine", split, "cityA",
            stem + "_gtFine_labelIds.png"), compress_level=1)

    jobs = ([("train", i) for i in range(DISK_TRAIN)]
            + [("val", i) for i in range(DISK_VAL)])
    for split in ("train", "val"):
        for sub in ("leftImg8bit_trainvaltest/leftImg8bit", "gtFine_trainvaltest/gtFine"):
            os.makedirs(os.path.join(root, sub, split, "cityA"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    return time.perf_counter() - t0


def disk_loaders(root, worker_type="thread"):
    """(train, val) loader args of the disk phase: segtpu's CityScapes
    augmentation at the main path's crop and batch."""
    train = {"data_dir": root, "split": "train", "batch_size": BATCH,
             "base_size": 2048, "crop_size": CROP, "augment": True, "scale": True,
             "flip": True, "rotate": True, "blur": True, "shuffle": True,
             "num_workers": 8, "device_normalize": True, "worker_type": worker_type}
    val = {"data_dir": root, "split": "val", "batch_size": BATCH, "crop_size": CROP,
           "val": True, "num_workers": 8, "device_normalize": True}
    return train, val


class Epochs:
    """A loader's batches over ``n`` epochs in one stream, so that one
    prefetcher feeds more steps than an epoch holds."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __len__(self):
        return self.n * len(self.loader)

    def __iter__(self):
        for _ in range(self.n):
            yield from self.loader


def disk_phase(workdir, seed, card, recorder):
    """The data slice at full width: a seeded CityScapes tree on disk; its
    loader alone (thread and process workers, bit-identical batches, the
    labels' range); PSPNet-R50 trained from it through
    ``segtpu_torch.train.main`` (4 steps and validation, stem kernel on),
    with D and B from the epoch log and per step; 5 steps timed and 3 traced
    fed by the prefetcher from the disk loader, beside the same trainer's
    step on one device-resident batch; the prefetched batches against the
    host's; the repo's config.json trained on the same tree; the inference
    CLI, sliding bf16, on one frame with the 769 run's best_model. Returns
    (launches of the training run, numbers)."""
    import logging

    import numpy as np
    import torch

    from segtpu_torch import inference as inference_cli
    from segtpu_torch import train as train_cli
    from segtpu_torch.data import CityScapes, DevicePrefetcher

    dev = torch.device("cuda")
    numbers = {"cpu_count": os.cpu_count(),
               "affinity": sorted(os.sched_getaffinity(0))}
    print(f"host: os.cpu_count() {numbers['cpu_count']}, CPU affinity "
          f"{numbers['affinity']}")
    root = os.path.join(workdir, "cityscapes")
    numbers["tree_write_s"] = write_cityscapes_tree(root, seed)
    print(f"tree: {DISK_TRAIN} train and {DISK_VAL} val {FRAME[0]}x{FRAME[1]} frames "
          f"written in {numbers['tree_write_s']:.1f} s ({dir_bytes(root) / 1e6:.0f} MB)")

    # the loader alone: one epoch (DISK_TRAIN samples) with each worker kind
    epochs = {}
    for kind in ("thread", "process"):
        loader = CityScapes(**disk_loaders(root, kind)[0])
        t0 = time.perf_counter()
        epochs[kind] = list(loader)
        secs = time.perf_counter() - t0
        numbers[f"loader_{kind}_samples_per_s"] = DISK_TRAIN / secs
        print(f"loader alone, {kind} workers (8): {DISK_TRAIN} samples in {secs:.2f} s, "
              f"{DISK_TRAIN / secs:.1f} samples/s, {1e3 * secs / len(epochs[kind]):.0f} "
              f"ms a batch of {BATCH}")
        if kind == "process":
            # the prefetched batches on the card against the host's
            loader.set_epoch(0)
            on_card = [(i.cpu().numpy(), l.cpu().numpy())
                       for i, l in DevicePrefetcher(loader, dev)]
            loader.close()
    same = all(np.array_equal(a, b) for x, y in zip(epochs["thread"], epochs["process"])
               for a, b in zip(x, y))
    print(f"thread and process workers give bit-identical batches: {same}")
    check(same and len(epochs["thread"]) == len(epochs["process"]) == DISK_TRAIN // BATCH,
          "thread and process workers gave other batches")
    prefetched = all(np.array_equal(a, b) for x, y in zip(on_card, epochs["thread"])
                     for a, b in zip(x, y)) and len(on_card) == len(epochs["thread"])
    print(f"prefetched batches on the card equal the host's bit for bit: {prefetched}")
    check(prefetched, "the prefetched batches differ from the host's")
    labels = set(np.unique(np.concatenate([b[1].ravel() for b in epochs["thread"]])).tolist())
    print(f"label values in the train batches: {sorted(labels)}")
    check(labels <= DISK_LABELS, f"labels outside 0-18 and 255: {labels - DISK_LABELS}")
    check(epochs["thread"][0][0].shape == (BATCH, CROP, CROP, 3)
          and epochs["thread"][0][0].dtype == np.uint8, "train batch shape or dtype")
    del epochs, on_card

    # where a sample's time goes, on one core: decoding, then the chain
    dataset = CityScapes(**disk_loaders(root)[0]).dataset
    decode_s, get_s = [], []
    for i in range(4):
        t0 = time.perf_counter()
        dataset._load_data(i)
        decode_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dataset.get(i, rng=random.Random(i))
        get_s.append(time.perf_counter() - t0)
    numbers["sample_decode_ms"] = 1e3 * sum(decode_s) / 4
    numbers["sample_ms"] = 1e3 * sum(get_s) / 4
    print(f"one sample on one core: {numbers['sample_ms']:.0f} ms, of which decoding "
          f"the two PNGs {numbers['sample_decode_ms']:.0f} ms (mean of 4)")
    del dataset

    # PSPNet-R50 trained from the tree through the training CLI's main, on
    # process workers (forked when train.main builds the loaders, before
    # the model goes to the card)
    train_args, val_args = disk_loaders(root, "process")
    config = smoke_config({"type": "PSPNet", "args": {"backbone": "resnet50",
                                                       "pallas_stem_wgrad": True}},
                          os.path.join(workdir, "saved_disk"), save_period=1)
    config["train_loader"] = {"type": "CityScapes", "args": train_args}
    config["val_loader"] = {"type": "CityScapes", "args": val_args}
    epoch_log = []
    handler = logging.Handler()
    handler.emit = lambda record: epoch_log.append(record.getMessage())
    logging.getLogger("segtpu_torch.Trainer").addHandler(handler)
    recorder.start()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main(config, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    recorder.stop()
    logging.getLogger("segtpu_torch.Trainer").removeHandler(handler)
    print(f"trainer: {trainer.state.step} steps + validation in {wall:.1f} s (model "
          f"build, loader start and validation included); launches {launches}")
    check(trainer.state.step == STEPS, f"{trainer.state.step} steps, want {STEPS}")
    check(launches == {"stem_conv_wgrad": STEPS, "flat_conv_wgrad": 0,
                       "flat_conv_dgrad": 0},
          f"the disk run launched {launches}, want {STEPS} stem launches")
    train_line = next(m for m in epoch_log if m.startswith("TRAIN"))
    b_s, d_s = (float(train_line.split(f" {k} ")[1].split("s")[0]) for k in ("B", "D"))
    numbers.update(epoch_log_B_s=b_s, epoch_log_D_s=d_s)
    print(f"epoch log: {train_line}")
    print(f"epoch log: D {d_s:.3f} s and B {b_s:.3f} s a step (averages over "
          f"{STEPS} steps; each recorded step syncs on its loss)")
    steps = recorder.steps
    waits = [b["t_in"] - a["t_out"] for a, b in zip(steps, steps[1:])]
    numbers["step_s"] = [r["t_out"] - r["t_in"] for r in steps]
    numbers["wait_s"] = waits
    print("per step: step " + ", ".join(f"{1e3 * t:.0f}" for t in numbers["step_s"])
          + " ms; host time between steps " + ", ".join(f"{1e3 * t:.0f}" for t in waits)
          + " ms")
    log = trainer.history[-1]
    print(f"epoch log: loss {log['loss']}, val_loss {log['val_loss']}, "
          f"Mean_IoU {log['Mean_IoU']}, Pixel_Accuracy {log['Pixel_Accuracy']}")
    check(math.isfinite(log["loss"]) and math.isfinite(log["val_loss"]),
          f"non-finite loss {log}")
    check([r["stem_launches"] for r in steps] == [1] * STEPS,
          f"stem kernel launches per step {steps}")
    best = os.path.join(trainer.checkpoint_dir, "best_model")
    check(os.path.isdir(best), "the disk run wrote no best_model")

    # the step on one device-resident batch, then 5 timed and 3 traced steps
    # fed by the prefetcher from the disk loader, in one stream (the workers
    # idle while the resident steps run)
    def sync_ms(run, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n

    images, labels = next(iter(DevicePrefetcher(trainer.val_loader, dev)))
    sync_ms(lambda: trainer.train_step(trainer.state, images, labels), 2)
    numbers["resident_ms"] = sync_ms(
        lambda: trainer.train_step(trainer.state, images, labels), TIMED_STEPS)
    del images, labels
    stream = iter(DevicePrefetcher(Epochs(trainer.train_loader, 3), dev))
    waits = []

    def fed_step():
        t = time.perf_counter()
        images, labels = next(stream)
        waits.append(time.perf_counter() - t)
        trainer.train_step(trainer.state, images, labels)

    sync_ms(fed_step, 2)
    del waits[:]
    numbers["disk_fed_ms"] = sync_ms(fed_step, TIMED_STEPS)
    numbers["disk_fed_wait_ms"] = [1e3 * w for w in waits]
    print(f"main path: PSPNet-R50 {CROP}x{CROP} bs{BATCH} bf16 train step fed by the "
          f"prefetcher from the disk loader {numbers['disk_fed_ms']:.1f} ms/step "
          f"({BATCH * 1e3 / numbers['disk_fed_ms']:.2f} imgs/s), waiting for its batch "
          + ", ".join(f"{w:.0f}" for w in numbers["disk_fed_wait_ms"])
          + f" ms; on one device-resident batch {numbers['resident_ms']:.1f} ms/step "
          f"[{card}]")
    profile_steps(fed_step, TRACED_STEPS, card)
    stream.close()
    del trainer, stream
    gc.collect()
    torch.cuda.empty_cache()

    # the repo's config.json: only data_dir, save_dir and epochs set; the
    # data_dir is a view of the tree with BATCH train frames (one step an
    # epoch), and 5 epochs reach its first validation (val_per_epochs 5)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "config.json")) as f:
        user = json.load(f)
    view = os.path.join(workdir, "cityscapes_view")
    for sub, suffix in (("leftImg8bit_trainvaltest/leftImg8bit", "leftImg8bit"),
                        ("gtFine_trainvaltest/gtFine", "gtFine_labelIds")):
        os.makedirs(os.path.join(view, sub, "train", "cityA"))
        os.symlink(os.path.join(root, sub, "val"), os.path.join(view, sub, "val"))
        for i in range(BATCH):
            name = f"cityA_{i:06d}_000019_{suffix}.png"
            os.symlink(os.path.join(root, sub, "train", "cityA", name),
                       os.path.join(view, sub, "train", "cityA", name))
    for key in ("train_loader", "val_loader"):
        user[key]["args"]["data_dir"] = view
    user["trainer"]["save_dir"] = os.path.join(workdir, "saved_user")
    user["trainer"]["log_dir"] = os.path.join(workdir, "runs_user")
    user["trainer"]["epochs"] = 5
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main(user, "cuda")
    torch.cuda.synchronize()
    user_launches = read_launches()
    log = trainer.history[-1]
    numbers["config_json"] = {"steps": trainer.state.step, "s": time.perf_counter() - t0,
                              "loss": log["loss"], "val_loss": log.get("val_loss"),
                              "Mean_IoU": log.get("Mean_IoU"), "launches": user_launches}
    print(f"config.json (base 400, crop 380, rotate; val crop 480): "
          f"{json.dumps(numbers['config_json'])}")
    check(trainer.state.step == 5 and math.isfinite(log["loss"])
          and "val_loss" in log and math.isfinite(log["val_loss"]),
          f"config.json's run: {trainer.state.step} steps, {log}")
    check(trainer.writer is not None and trainer.writer.path.startswith(workdir)
          and os.path.getsize(trainer.writer.path) > 0,
          "config.json's run wrote no events into the work directory")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # the inference CLI on the 769 run's best_model, whose config names
    # CityScapes (dataset_meta answers for it without the tree)
    images_dir = os.path.join(workdir, "disk_frame")
    os.makedirs(images_dir)
    frame = os.path.join(root, "leftImg8bit_trainvaltest/leftImg8bit/val/cityA",
                         "cityA_000000_000019_leftImg8bit.png")
    os.symlink(frame, os.path.join(images_dir, "frame.png"))
    reset_launches()
    result = inference_cli.main([
        "--model", best, "--images", images_dir, "--output",
        os.path.join(workdir, "disk_out"), "--extension", "png", "--mode", "sliding",
        "--dtype", "bfloat16"])
    from PIL import Image

    with Image.open(result["written"][0]) as written:
        classes = np.asarray(written)
    numbers["inference_s"] = result["seconds"][0]
    print(f"inference CLI, sliding bf16, best_model of the disk run: "
          f"{result['seconds'][0]:.2f} s for one {FRAME[0]}x{FRAME[1]} frame, "
          f"{len(np.unique(classes))} classes in its map; launches {read_launches()}")
    check(classes.shape == FRAME and classes.max() < CLASSES, "the written class map")
    return launches, numbers


# the DeepLab paths and the loss and optimizer phases
DEEPLAB_XCEPTION = {"type": "DeepLab", "args": {"backbone": "xception",
                                                "output_stride": 16}}
DEEPLAB_R101 = {"type": "DeepLab", "args": {"backbone": "resnet101", "output_stride": 16}}
# the losses phase: the card's float64 run of each loss at LOSS_CROP against
# the CPU's float64 run on the same values, value and logit gradient
# (relative to its largest element): the same arithmetic in other orders
LOSS_F64_TOL = 1e-9
# the card's float32 run (the bf16 logits upcast, as in training) against
# the same CPU float64 reference: float32 sums over 8*97*97 pixels. The
# gradients of the Lovasz losses are printed, not held: each of their
# elements is the difference of two Jaccard values near 1 that differ by
# about 1/union, which float32 leaves with a relative error of about
# 6e-8 * union (5.6e-4 at the hinge's 9409 pixels an image); and the fp32
# errors of the softmax forms can tie, or fall on the other side of a bin
# edge, where the float64 ones do not. Their float64 runs above are held
LOSS_F32_TOL = 1e-4
LOSS_CROP = 97
LOVASZ_LOSSES = ("LovaszSoftmax", "LovaszSoftmaxExact", "LovaszSoftmaxFast",
                 "lovasz_hinge")


def deeplab_config(arch, save_dir, loss, optimizer, scheduler):
    config = smoke_config(arch, save_dir, save_period=1)
    config.update(loss=loss, optimizer=optimizer, lr_scheduler=scheduler)
    return config


def losses_phase(card):
    """Every loss of ``segtpu_torch.losses.LOSSES`` plus ``lovasz_hinge``
    and ``binary_xloss`` on bf16 logits 8x19x769x769 with 255-ignored
    labels: forward + backward ms at full size and the peak memory; value
    and logit gradient at a LOSS_CROP crop of the same draw, in float64 and
    in float32 on the card, against float64 on the CPU."""
    import torch

    from segtpu_torch import losses

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(400)
    logits = torch.randn(BATCH, CLASSES, CROP, CROP, generator=g, device=dev).bfloat16()
    labels = torch.randint(0, CLASSES, (BATCH, CROP, CROP), generator=g, device=dev)
    labels[torch.rand(labels.shape, generator=g, device=dev) < 0.1] = 255
    binary = torch.where(labels == 255, labels, labels % 2)
    cases = {name: (fn, logits, labels) for name, fn in losses.LOSSES.items()}
    cases["lovasz_hinge"] = (losses.lovasz_hinge, logits[:, 0], binary)
    cases["binary_xloss"] = (losses.binary_xloss, logits[:, 0], binary)
    numbers = {}
    for name, (fn, lg, tg) in cases.items():
        x = lg.detach().clone().requires_grad_()

        def run():
            fn(x, tg).backward()
            x.grad = None

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms(run, iters=3, warmup=1)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        crop = (..., slice(0, LOSS_CROP), slice(0, LOSS_CROP))
        lc, tc = lg[crop].contiguous(), tg[crop].contiguous()
        results = {}
        for where, dtype in (("cpu", torch.float64), ("cuda", torch.float64),
                             ("cuda", torch.float32)):
            xc = lc.to(where, dtype).requires_grad_()
            value = fn(xc, tc.to(where))
            value.backward()
            results[(where, dtype)] = (value.detach().double().cpu(),
                                       xc.grad.double().cpu())
        ref_v, ref_g = results[("cpu", torch.float64)]
        errs = {}
        for key, label in ((("cuda", torch.float64), "f64"), (("cuda", torch.float32), "f32")):
            v, gr = results[key]
            errs[label] = (abs(float(v - ref_v)) / max(abs(float(ref_v)), 1e-30),
                           float((gr - ref_g).abs().max() / ref_g.abs().max().clamp_min(1e-30)))
        print(f"loss {name}: forward+backward {ms:.3f} ms at {BATCH}x{CLASSES}x{CROP}x"
              f"{CROP} bf16, peak memory {peak:.2f} GiB above its inputs; at "
              f"{LOSS_CROP}x{LOSS_CROP} against CPU float64: card float64 value rel "
              f"err {errs['f64'][0]:.2e}, gradient {errs['f64'][1]:.2e} (tol "
              f"{LOSS_F64_TOL}); card float32 value {errs['f32'][0]:.2e}, gradient "
              f"{errs['f32'][1]:.2e} (tol {LOSS_F32_TOL}"
              f"{', gradient not held' if name in LOVASZ_LOSSES else ''}) [{card}]",
              flush=True)
        check(math.isfinite(float(ref_v)) and ref_g.isfinite().all(),
              f"{name}: non-finite reference")
        check(max(errs["f64"]) < LOSS_F64_TOL, f"{name} on the card in float64: {errs}")
        check(errs["f32"][0] < LOSS_F32_TOL, f"{name}'s float32 value: {errs}")
        if name not in LOVASZ_LOSSES:
            check(errs["f32"][1] < LOSS_F32_TOL, f"{name}'s float32 gradient: {errs}")
        numbers[name] = {"ms": ms, "peak_gib": peak, "f64_err": errs["f64"],
                         "f32_err": errs["f32"]}
        del x, lc, tc, results
        torch.cuda.empty_cache()
    return numbers


def optimizer_phase(workdir, card):
    """PSPNet-R50 (``pallas_stem_wgrad``) at 769x769, batch 8, bf16: from one
    set of seeded weights, 2 steps each of Adam, AdamW, centered RMSprop,
    Adagrad (lr_decay), SGD under OneCycle, freeze_backbone and freeze_bn
    (both SGD under Poly) on two seeded device-resident batches. Losses
    finite; the stem kernel's launches counted per step (1, or 0 with the
    backbone frozen: no backbone parameter needs a gradient, so no backward
    reaches the stem conv); the backbone's parameters bit-identical under
    freeze_backbone and every running statistic under freeze_bn. AdamW under
    OneCycle is saved after its first step and resumed into a fresh state:
    its resumed loss must equal the uninterrupted run's second."""
    import torch

    from segtpu_torch import losses
    from segtpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from segtpu_torch.core.state import TrainState, make_optimizer
    from segtpu_torch.core.steps import make_train_step
    from segtpu_torch.models import get_model
    from segtpu_torch.ops import conv_wgrad as cw

    dev = torch.device("cuda")
    model = get_model("PSPNet", device="cuda", seed=5, num_classes=CLASSES,
                      backbone="resnet50", pallas_stem_wgrad=True)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(500)
    batches = []
    for _ in range(2):
        images = torch.randint(0, 256, (BATCH, CROP, CROP, 3), generator=g, device=dev,
                               dtype=torch.uint8)
        labels = torch.randint(0, CLASSES, (BATCH, CROP, CROP), generator=g, device=dev)
        labels[:, :64, :64] = 255
        batches.append((images, labels))
    norm = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.bfloat16,
                           norm_stats=norm)
    sched = dict(num_epochs=1, iters_per_epoch=10)
    runs = {
        "Adam": dict(optimizer_type="Adam", lr=1e-3, weight_decay=1e-4),
        "AdamW": dict(optimizer_type="AdamW", lr=1e-3, weight_decay=1e-2,
                      scheduler_type="OneCycle"),
        "RMSprop centered": dict(optimizer_type="RMSprop", lr=1e-3, centered=True,
                                 momentum=0.9),
        "Adagrad lr_decay": dict(optimizer_type="Adagrad", lr=1e-2, lr_decay=0.1,
                                 initial_accumulator_value=0.1),
        "SGD OneCycle": dict(optimizer_type="SGD", lr=0.01, scheduler_type="OneCycle"),
        "freeze_backbone": dict(optimizer_type="SGD", lr=0.01, freeze_backbone=True),
        "freeze_bn": dict(optimizer_type="SGD", lr=0.01),
    }

    def fresh(kw, freeze_bn=False):
        model.load_state_dict(initial)
        for p in model.parameters():
            p.requires_grad_(True)
        model.freeze_bn = freeze_bn
        return TrainState(model, *make_optimizer(model, **sched, **kw))

    def timed_step(state, batch):
        before = cw.stem_conv_wgrad.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = step(state, *batch)
        loss = float(loss)
        return loss, 1e3 * (time.perf_counter() - t), cw.stem_conv_wgrad.launches - before

    numbers = {}
    torch.manual_seed(7)
    for name, kw in runs.items():
        state = fresh(kw, freeze_bn=name == "freeze_bn")
        out = [timed_step(state, b) for b in batches]
        after = model.state_dict()
        losses_, ms, launches = zip(*out)
        numbers[name] = {"losses": losses_, "ms": ms, "stem_launches": launches}
        print(f"optimizer {name}: losses {losses_}, ms/step {tuple(round(m, 1) for m in ms)}"
              f" (the first with its state's allocation), stem launches per step "
              f"{launches} [{card}]", flush=True)
        check(all(math.isfinite(v) for v in losses_), f"{name}: non-finite loss {losses_}")
        want = (0, 0) if name == "freeze_backbone" else (1, 1)
        check(launches == want, f"{name}: stem launches per step {launches}, want {want}")
        backbone = [k for k in after if k.split(".")[0] in model.backbone_modules
                    and "running_" not in k and "num_batches" not in k]
        stats = [k for k in after if "running_" in k]
        if name == "freeze_backbone":
            same = all(torch.equal(after[k], initial[k]) for k in backbone)
            moved = not torch.equal(after["initial.1.running_mean"],
                                    initial["initial.1.running_mean"])
            print(f"freeze_backbone: {len(backbone)} backbone tensors bit-identical: "
                  f"{same}; backbone BN statistics moved: {moved}")
            check(same and moved, "freeze_backbone: the backbone moved, or its BN "
                  "statistics did not")
        if name == "freeze_bn":
            same = all(torch.equal(after[k], initial[k]) for k in stats)
            trained = not torch.equal(after["initial.1.weight"], initial["initial.1.weight"])
            print(f"freeze_bn: {len(stats)} running statistics bit-identical: {same}; "
                  f"BN scales trained: {trained}")
            check(same and trained, "freeze_bn: a running statistic moved, or the "
                  "BN scales did not train")
        del state
    model.freeze_bn = False

    # AdamW under OneCycle: save after its first step, then resume
    torch.manual_seed(8)
    state = fresh(runs["AdamW"])
    step(state, *batches[0])
    path = save_checkpoint(workdir, "adamw-onecycle", state, 0, float("nan"), {}, "PSPNet")
    want_loss = float(step(state, *batches[1])[0])
    resumed = fresh(runs["AdamW"])
    load_checkpoint(path, resumed)
    got_loss = float(step(resumed, *batches[1])[0])
    print(f"AdamW under OneCycle, resumed after step 1: resumed loss {got_loss!r}, "
          f"uninterrupted {want_loss!r}, update count {resumed.step}")
    check(got_loss == want_loss and resumed.step == 2,
          f"the resumed AdamW loss {got_loss} is not the uninterrupted run's {want_loss}")
    numbers["AdamW resumed"] = {"loss": got_loss, "uninterrupted": want_loss}
    for p in model.parameters():
        p.requires_grad_(True)
    del model, state, resumed, batches, initial
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


def frame_inference(label, best, workdir, seed, card):
    """The inference CLI, sliding bf16, on one seeded 1024x2048 frame with
    the ``label`` run's best_model; returns (launches, seconds)."""
    import numpy as np
    from PIL import Image

    from segtpu_torch import inference as inference_cli

    tag = "".join(c if c.isalnum() else "_" for c in label)
    images_dir = os.path.join(workdir, f"frame_{tag}")
    os.makedirs(images_dir)
    Image.fromarray(block_frame(np.random.default_rng(seed + 7))).save(
        os.path.join(images_dir, "frame.png"))
    reset_launches()
    result = inference_cli.main([
        "--model", best, "--images", images_dir, "--output",
        os.path.join(workdir, f"out_{tag}"), "--extension", "png", "--mode", "sliding",
        "--dtype", "bfloat16"])
    launches = read_launches()
    with Image.open(result["written"][0]) as written:
        classes = np.asarray(written)
    print(f"inference CLI, sliding bf16, {label} best_model: "
          f"{result['seconds'][0]:.2f} s for one {FRAME[0]}x{FRAME[1]} frame, "
          f"{len(np.unique(classes))} classes in its map; launches {launches} [{card}]")
    check(classes.shape == FRAME and classes.max() < CLASSES, "the written class map")
    return launches, result["seconds"][0]


def deeplab_phases(workdir, seed, card, recorder):
    """DeepLabV3+-Xception (CE_DiceLoss, AdamW under OneCycle, depthwise convs
    as a category of the trace) and the inference CLI on its best_model,
    then DeepLabV3+-R101 (exact LovaszSoftmax, SGD under Poly, the Lovász
    tail's traced ms). Returns (launches by path, numbers)."""
    import torch

    no_kernel = {"stem_conv_wgrad": 0, "flat_conv_wgrad": 0, "flat_conv_dgrad": 0}
    phase("main path: DeepLabV3+-Xception")
    trainer, dlx_launches, _, _, numbers = train_main_path(
        "DeepLabV3+-Xception", deeplab_config(
            DEEPLAB_XCEPTION, os.path.join(workdir, "saved"), "CE_DiceLoss",
            {"type": "AdamW", "differential_lr": True,
             "args": {"lr": 1e-3, "weight_decay": 1e-2}},
            {"type": "OneCycle", "args": {}}),
        no_kernel, card, recorder, ops=[DEPTHWISE_OP])
    check(numbers["device_ms_by_category"].get(DEPTHWISE, 0.0) > 0,
          "no device time attributed to the depthwise convs")
    deeplab_numbers = {"DeepLabV3+-Xception": numbers}
    dlx_best = os.path.join(trainer.checkpoint_dir, "best_model")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    phase("inference: DeepLabV3+-Xception")
    dl_infer_launches, deeplab_numbers["inference_s"] = frame_inference(
        "DeepLabV3+-Xception", dlx_best, workdir, seed, card)
    gc.collect()
    torch.cuda.empty_cache()

    phase("main path: DeepLabV3+-R101")
    trainer, dlr_launches, _, _, numbers = train_main_path(
        "DeepLabV3+-R101", deeplab_config(
            DEEPLAB_R101, os.path.join(workdir, "saved"), "LovaszSoftmax",
            {"type": "SGD", "differential_lr": True,
             "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
            {"type": "Poly", "args": {}}),
        no_kernel, card, recorder)
    cats = numbers["device_ms_by_category"]
    tail = {k: cats.get(k, 0.0) for k in ("sort (Lovász)", "cumsum (Lovász)",
                                          "gather (Lovász, CE)")}
    print(f"Lovász tail, traced: sort {tail['sort (Lovász)']:.3f}, cumsum "
          f"{tail['cumsum (Lovász)']:.3f}, gathers {tail['gather (Lovász, CE)']:.3f} "
          f"ms per traced train step [{card}]")
    check(tail["sort (Lovász)"] > 0, "no sort in the traced Lovász steps")
    deeplab_numbers["DeepLabV3+-R101"] = {**numbers, "lovasz_tail_ms": tail}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    return {"DeepLabV3+-Xception": dlx_launches, "DeepLabV3+-R101": dlr_launches,
            "DeepLabV3+-Xception inference": dl_infer_launches}, deeplab_numbers


#: convs traced as categories of their own: (category, input NCHW, weight
#: OIHW, output HW, convs of that shape a step). GCN-R50's ``br9``: two 3x3
#: convs at 19 channels over the whole 769x769 map; FCN8's conv6 (FC6)
BR9 = ("GCN br9 3x3 convs, C=19 at 769x769 (cuDNN)", (BATCH, CLASSES, CROP, CROP),
       (CLASSES, CLASSES, 3, 3), (CROP, CROP), 2)
FC6 = ("FCN8 conv6 7x7, 512->4096 at 31x31 (cuDNN)", (BATCH, 512, 31, 31),
       (4096, 512, 7, 7), (25, 25), 1)
BR9_OP, FC6_OP = ((_conv_on(x, w), cat) for cat, x, w, _, _ in (BR9, FC6))
# the zoo paths at segtpu's defaults (full width and depth): (label, arch,
# whether the run validates and keeps a best_model, the traced ops that
# form categories of their own, whether the steps are traced)
ZOO_PATHS = [
    ("DeepLab_DUC_HDC-R101", {"type": "DeepLab_DUC_HDC",
                              "args": {"backbone": "resnet101", "output_stride": 8}},
     True, [PIXEL_SHUFFLE_OP], True),
    ("UNet", {"type": "UNet", "args": {}}, False, [TRANSPOSED_OP], True),
    ("UNetResnet-R50", {"type": "UNetResnet", "args": {"backbone": "resnet50"}}, False,
     [TRANSPOSED_OP], True),
    ("SegNet", {"type": "SegNet", "args": {}}, False, [UNPOOL_OP], True),
    ("SegResNet", {"type": "SegResNet", "args": {}}, False, [TRANSPOSED_OP, UNPOOL_OP],
     True),
    ("ENet", {"type": "ENet", "args": {}}, True, [TRANSPOSED_OP, UNPOOL_OP], True),
    ("GCN-R50", {"type": "GCN", "args": {"backbone": "resnet50"}}, False, [BR9_OP], True),
    ("GCN-ResnetGCN-deconv", {"type": "GCN", "args": {
        "backbone": "resnet50", "use_resnet_gcn": True, "use_deconv": True}},
     False, [], False),
    ("FCN8", {"type": "FCN8", "args": {}}, False, [TRANSPOSED_OP, FC6_OP], True),
    ("PSPDenseNet-201", {"type": "PSPDenseNet", "args": {"backbone": "densenet201"}},
     False, [], True),
    ("PSPDenseNet-201 remat", {"type": "PSPDenseNet", "args": {
        "backbone": "densenet201", "remat_backbone": True}}, False, [], False),
]
ZOO_STEPS = 2


def segresnet_checks(trainer, batch, val_batch, card):
    """SegResNet on the card: two eval forwards of one val batch give the
    same bits; the card's ``max_unpool_flat`` on a bf16 train step's own
    decoder tensor and stem-pool indices equals the CPU's bit for bit,
    forward and backward (a seeded cotangent); the indices' repeats are
    counted. Returns the numbers."""
    import torch

    from segtpu_torch.core.steps import prep_images
    from segtpu_torch.models import segnet
    from segtpu_torch.ops.pooling import max_unpool_flat

    model = trainer.model
    x = prep_images(val_batch[0], trainer.norm_stats, torch.bfloat16)
    model.eval()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        first, second = model(x)["out"], model(x)["out"]
    same_eval = torch.equal(first, second)
    print(f"SegResNet: two eval forwards of one val batch give the same bits: {same_eval}")
    check(same_eval, "two SegResNet eval forwards of one batch differ")
    del first, second

    seen = {}

    def keep_unpool_inputs(y, idx, output_hw):
        seen.update(y=y.detach().clone(), idx=idx.clone(), hw=tuple(output_hw))
        return max_unpool_flat(y, idx, output_hw)

    state = {k: v.clone() for k, v in model.state_dict().items()}
    segnet.max_unpool_flat = keep_unpool_inputs
    try:
        step_backward(trainer, model, state, *batch, torch.bfloat16)
    finally:
        segnet.max_unpool_flat = max_unpool_flat
    model.zero_grad(set_to_none=True)
    y, idx, hw = seen["y"], seen["idx"], seen["hw"]
    g = torch.randn((*y.shape[:2], *hw), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0)).to(y.dtype)
    outs = []
    for dev in ("cuda", "cpu"):
        yd = y.to(dev).detach().requires_grad_()
        out = max_unpool_flat(yd, idx.to(dev), hw)
        out.backward(g.to(dev))
        outs.append((out.detach().cpu(), yd.grad.cpu()))
    same_fwd = torch.equal(outs[0][0], outs[1][0])
    same_bwd = torch.equal(outs[0][1], outs[1][1])
    repeats = int((idx.flatten(2).sort(dim=2).values.diff(dim=2) == 0).sum())
    print(f"SegResNet max_unpool_flat on a bf16 step's own decoder tensor "
          f"{tuple(y.shape)} {y.dtype} and stem-pool indices into {hw}: {repeats} "
          f"repeated indices of {idx.numel()}; the card's forward and backward equal "
          f"the CPU's bit for bit: {same_fwd}, {same_bwd} [{card}]")
    check(repeats > 0, "the step's stem-pool indices hold no repeat")
    check(same_fwd and same_bwd, "the card's max_unpool_flat is not the CPU's")
    del state, seen, y, idx, g, outs
    return {"eval_forwards_equal": same_eval, "unpool_repeated_indices": repeats,
            "unpool_card_equals_cpu": same_fwd and same_bwd}


def zoo_phases(workdir, seed, card, recorder):
    """The ZOO_PATHS through ``segtpu_torch.train.main`` (19 classes, 769x769,
    batch 8, uint8 transport, bf16, CE, two-group SGD under Poly), ZOO_STEPS
    steps each (DeepLab_DUC_HDC and ENet with a validation pass), then timed
    and, where the path says so, traced as in phase 6; no hand-written
    kernel (every count 0). SegResNet's own checks (``segresnet_checks``),
    GCN-R50's br9 convs and FCN8's conv6 against their bounds, and the
    inference CLI on DeepLab_DUC_HDC's and ENet's best_model. Returns
    (launches by path, numbers)."""
    import torch

    no_kernel = {"stem_conv_wgrad": 0, "flat_conv_wgrad": 0, "flat_conv_dgrad": 0}
    launches, numbers = {}, {}
    for label, arch, val, ops, trace in ZOO_PATHS:
        phase(f"main path: {label}")
        config = smoke_config(arch, os.path.join(workdir, "saved"),
                              save_period=1 if val else 10, steps=ZOO_STEPS, val=val)
        trainer, launches[label], batch, val_batch, numbers[label] = train_main_path(
            label, config, no_kernel, card, recorder, ops=ops, trace=trace)
        cats = numbers[label]["device_ms_by_category"] or {}
        for _, cat in ops:
            check(cats.get(cat, 0.0) > 0, f"no device time attributed to {cat} on {label}")
        if label == "GCN-R50":
            check(cats.get("bilinear resize", 0.0) > 0, "no resize in GCN-R50's trace")
            numbers[label]["br9_bound"] = conv_bound(label, BR9, cats, card)
        if label == "FCN8":
            numbers[label]["conv6_bound"] = conv_bound(label, FC6, cats, card)
        if label == "PSPDenseNet-201 remat":
            print(f"PSPDenseNet-201 peak memory: remat_backbone off "
                  f"{numbers['PSPDenseNet-201']['peak_gib']:.2f} GiB, on "
                  f"{numbers[label]['peak_gib']:.2f} GiB [{card}]")
        if label == "SegResNet":
            numbers[label].update(segresnet_checks(trainer, batch, val_batch, card))
        best = os.path.join(trainer.checkpoint_dir, "best_model") if val else None
        del trainer, batch, val_batch
        gc.collect()
        torch.cuda.empty_cache()
        if best is not None:
            phase(f"inference: {label}")
            launches[f"{label} inference"], numbers[label]["inference_s"] = \
                frame_inference(label, best, workdir, seed, card)
            gc.collect()
            torch.cuda.empty_cache()
    return launches, numbers


def conv_bound(label, conv, cats, card):
    """The traced device ms of ``conv`` (a BR9-like tuple) on ``label``
    against its bound: each conv of the shape run forward and for its input
    and weight gradients, bf16; each of the three passes reads two of x, w
    and y (or dy) once and writes the third once."""
    cat, (n, c, h, w), (o, _, kh, kw), (ho, wo), count = conv
    ms = cats[cat]
    nbytes = count * 3 * 2 * (n * c * h * w + o * c * kh * kw + n * o * ho * wo)
    flops = count * 3 * 2 * n * ho * wo * o * c * kh * kw
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"{label} {cat}, forward and backward: {ms:.3f} ms per traced step, bound "
          f"{bound_ms:.3f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.2f} GB) "
          f"[{card}]")
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}


#: the "pretrained: load only" families: (label, model, args, the args of the
#: model whose layout the file takes, when it is another's)
PRETRAINED_LOAD_ONLY = [
    ("UperNet-R101", "UperNet", {"backbone": "resnet101"}, None),
    ("SegNet", "SegNet", {}, None),
    ("FCN8", "FCN8", {}, None),
    ("DeepLab-Xception", "DeepLab", {"backbone": "xception"}, None),
    # a plain torchvision ResNet-50 file: its layer3/4 must be skipped
    ("GCN-ResnetGCN-R50", "GCN", {"backbone": "resnet50", "use_resnet_gcn": True},
     {"backbone": "resnet50"}),
    ("SegResNet", "SegResNet", {}, None),
]
GRID_ROWS = 15  # the trainer's val grid at full size: 15 rows of 769 x 2307


def write_seeded_pth(path, model, seed):
    """A ``.pth`` in the original layout that ``model`` reads
    (``pretrained.file_layout``), of seeded tensors (running variances in
    [0.5, 1.5)); returns (the state dict, seconds to make and write it)."""
    import torch

    from segtpu_torch import pretrained

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, (_, shape) in sorted(pretrained.file_layout(model).items()):
        sd[key] = (torch.rand(shape, generator=g) + 0.5 if key.endswith("running_var")
                   else torch.randn(shape, generator=g) * 0.05)
    torch.save(sd, path)
    return sd, time.perf_counter() - t0


def check_pretrained_state(label, state, sd, ref, model):
    """``state`` (tensors on the card) holds the file's tensors where
    ``model`` reads them, bit for bit, and ``ref``'s (the same seed, nothing
    loaded) everywhere else; returns (tensors, parameters) loaded."""
    import torch

    from segtpu_torch import pretrained

    fed = pretrained.remap(model, sd)
    for target, (key, value) in fed.items():
        got = state[target]
        check(torch.equal(got, value.to(got.device).reshape(got.shape)),
              f"{label}: {target} is not the file's {key}")
    ref_sd = ref.state_dict()
    kept = [k for k in state if k not in fed]
    check(all(torch.equal(state[k], ref_sd[k]) for k in kept),
          f"{label}: a tensor outside the file's is not its init")
    params = dict(model.named_parameters())
    n_params = sum(state[t].numel() for t in fed if t in params)
    print(f"{label}: {len(fed)} tensors ({n_params:,} parameters) equal the file's bit "
          f"for bit; the other {len(kept)} equal a model built from the same seed")
    return len(fed), n_params


def pretrained_phases(workdir, card, recorder, main_numbers, zoo_numbers):
    """The pretrained encoders on the card. PSPNet-R50 from a seeded
    encoding-style resnet50s.pth, trained through
    ``segtpu_torch.train.main`` as the main path with tensorboard and
    ``profile: 2``: its state before the first step against the file and
    the init, one stem launch a step, the load time, its timed ms/step
    against the main path's, the event file read back (framing, CRCs, tags,
    steps, the losses), the val grid's write time at one row and at 15, the
    profile's trace naming the stem kernel. PSPDenseNet-201 on the 7x7 stem
    from a seeded densenet201.pth: the same state check, 2 steps, ms/step
    and peak memory against the zoo's from-scratch stem. Then
    ``pretrained_load_phase``. Returns (launches by path, numbers)."""
    import numpy as np
    import torch

    from segtpu_torch import pretrained
    from segtpu_torch import trainer as trainer_mod
    from segtpu_torch.models import get_model
    from segtpu_torch.utils import tensorboard as tb

    root = os.path.join(workdir, "pretrained")
    os.makedirs(root)
    no_kernel = {"stem_conv_wgrad": 0, "flat_conv_wgrad": 0, "flat_conv_dgrad": 0}
    launches, numbers = {}, {}
    load_s, grid_s, viz_seen = [], [], []
    load, write_grid = trainer_mod.maybe_load_pretrained, trainer_mod.Trainer._write_val_grid

    def timed_load(model, config):
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = load(model, config)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t)
        return path

    def timed_grid(self, viz, epoch):
        t = time.perf_counter()
        write_grid(self, viz, epoch)
        grid_s.append(time.perf_counter() - t)
        viz_seen.append((self, viz))

    trainer_mod.maybe_load_pretrained = timed_load
    trainer_mod.Trainer._write_val_grid = timed_grid
    try:
        phase("pretrained: PSPNet-R50")
        label = "PSPNet-R50 pretrained"
        args = {"backbone": "resnet50", "pallas_stem_wgrad": True, "pretrained": True}
        ref = get_model("PSPNet", device="cuda", num_classes=CLASSES, **args)
        plain = get_model("PSPNet", device="cuda", num_classes=CLASSES,
                          **{**args, "pretrained": False})
        check(all(torch.equal(v, plain.state_dict()[k]) for k, v in ref.state_dict().items()),
              "PSPNet built with pretrained differs from one without")
        del plain
        sd, write_s = write_seeded_pth(os.path.join(root, "resnet50s.pth"), ref, 1)
        print(f"resnet50s.pth (encoding deep base, seeded): {len(sd)} tensors, "
              f"{os.path.getsize(os.path.join(root, 'resnet50s.pth')) / 1e6:.1f} MB, made "
              f"and written in {write_s:.2f} s")
        config = smoke_config({"type": "PSPNet", "args": args},
                              os.path.join(workdir, "saved_pretrained"))
        config["pretrained_dir"] = root
        config["trainer"].update(tensorboard=True, profile=2)
        recorder.snap_before = 0
        trainer, launches[label], _, _, num = train_main_path(
            label, config, {**no_kernel, "stem_conv_wgrad": STEPS}, card, recorder,
            trace=False)
        numbers[label] = num
        check_pretrained_state(label, recorder.snap["model"], sd, ref, trainer.model)
        numbers[label]["load_s"] = load_s[-1]
        print(f"{label}: load of resnet50s.pth into the model on the card {load_s[-1]:.3f} s; "
              f"train step {num['ms_per_step']:.1f} ms/step against the main path's "
              f"{main_numbers['ms_per_step']:.1f} (same flags, no pretrained) [{card}]")

        path = trainer.writer.path
        t = time.perf_counter()
        events = tb.read_events(path)
        read_s = time.perf_counter() - t
        grid_tag = "val/inputs_targets_predictions"
        got = [(v["tag"], e["step"]) for e in events[1:] for v in e["values"]]
        want = ([("train/loss", i + 1) for i in range(STEPS)]
                + [(f"train/{k}", STEPS) for k in ("Pixel_Accuracy", "Mean_IoU",
                                                   "Learning_rate_0", "Learning_rate_1")]
                + [(grid_tag, 1)] + [(f"val/{k}", STEPS)
                                     for k in ("loss", "Pixel_Accuracy", "Mean_IoU")])
        check(events[0].get("file_version") == "brain.Event:2" and got == want,
              f"{label}: events {got}")
        losses = [v["simple_value"] for e in events[1:STEPS + 1] for v in e["values"]]
        check(losses == [float(np.float32(r["loss"])) for r in recorder.steps],
              f"{label}: logged losses {losses}, steps' {recorder.steps}")
        image = next(v["image"] for e in events for v in e["values"] if "image" in v)
        check((image["height"], image["width"], image["colorspace"]) == (CROP, 3 * CROP, 3),
              f"{label}: val grid {image}")
        numbers[label].update(events_bytes=os.path.getsize(path), events_read_s=read_s,
                              grid_1row_s=grid_s[-1])
        print(f"{label}: event file {os.path.getsize(path)} bytes, {len(events)} records, "
              f"read back (CRCs checked) in {read_s:.3f} s; tags and steps {got[:1]}... "
              f"as segtpu's; the val grid (1 row, {CROP}x{3 * CROP}) written in "
              f"{grid_s[-1]:.3f} s")

        # the grid at full size, 15 rows of the run's own val image
        owner, viz = viz_seen[-1]
        writer = tb.SummaryWriter(os.path.join(root, "grid15"))
        fake = types.SimpleNamespace(val_loader=owner.val_loader, writer=writer)
        t = time.perf_counter()
        write_grid(fake, viz * GRID_ROWS, 1)
        full_s = time.perf_counter() - t
        writer.close()
        png = next(v["image"]["png"] for e in tb.read_events(writer.path) for v in e["values"]
                   if "image" in v)
        t = time.perf_counter()
        tb.crc32c(png)
        crc_s = time.perf_counter() - t
        numbers[label].update(grid_15row_s=full_s, grid_15row_png_bytes=len(png),
                              grid_15row_crc_s=crc_s)
        print(f"val grid at full size ({GRID_ROWS * CROP}x{3 * CROP}): written in "
              f"{full_s:.3f} s, PNG {len(png) / 1e6:.1f} MB, its CRC-32C alone "
              f"{crc_s:.3f} s (host)")

        traces = glob.glob(os.path.join(trainer.checkpoint_dir, "profile", "*.json"))
        check(len(traces) == 1, f"{label}: profile traces {traces}")
        with open(traces[0]) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
        stem = sum("stem_wgrad" in n for n in names)
        numbers[label].update(trace_bytes=os.path.getsize(traces[0]), trace_stem_events=stem)
        print(f"{label}: profile of 2 steps, {os.path.getsize(traces[0]) / 1e6:.1f} MB, "
              f"{len(names)} events, {stem} of the stem kernel's")
        check(stem >= 2, f"{label}: the profile names no stem kernel launch")
        del trainer, ref, sd, events
        gc.collect()
        torch.cuda.empty_cache()

        phase("pretrained: PSPDenseNet-201")
        label = "PSPDenseNet-201 pretrained"
        args = {"backbone": "densenet201", "pretrained": True}
        ref = get_model("PSPDenseNet", device="cuda", num_classes=CLASSES, **args)
        sd, write_s = write_seeded_pth(os.path.join(root, "densenet201.pth"), ref, 2)
        print(f"densenet201.pth (seeded): {len(sd)} tensors, made and written in "
              f"{write_s:.2f} s")
        config = smoke_config({"type": "PSPDenseNet", "args": args},
                              os.path.join(workdir, "saved_pretrained"), steps=ZOO_STEPS,
                              val=False)
        config["pretrained_dir"] = root
        trainer, launches[label], _, _, num = train_main_path(
            label, config, no_kernel, card, recorder, trace=False)
        numbers[label] = {**num, "load_s": load_s[-1]}
        check(tuple(trainer.model.block0[0].weight.shape) == (64, 3, 7, 7),
              f"{label}: stem {tuple(trainer.model.block0[0].weight.shape)}")
        check_pretrained_state(label, recorder.snap["model"], sd, ref, trainer.model)
        scratch = zoo_numbers["PSPDenseNet-201"]
        print(f"{label}: 7x7 stem, load {load_s[-1]:.3f} s; {num['ms_per_step']:.1f} ms/step, "
              f"peak {num['peak_gib']:.2f} GiB, against the from-scratch stem's "
              f"{scratch['ms_per_step']:.1f} ms/step, {scratch['peak_gib']:.2f} GiB in this "
              f"run [{card}]")
        del trainer, ref, sd
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        trainer_mod.maybe_load_pretrained = load
        trainer_mod.Trainer._write_val_grid = write_grid
        recorder.snap_before = None

    numbers.update(pretrained_load_phase(root, card))
    return launches, numbers


def pretrained_load_phase(root, card):
    """One seeded file per remaining family (PRETRAINED_LOAD_ONLY) written
    into ``root`` and loaded into the model on the card: every tensor it
    feeds equal to the file's bit for bit, the others to the seed's init;
    FCN8's conv6 from FC6's 2-D weight, the ResnetGCN's layer3/4 skipped.
    Returns the load numbers."""
    import torch

    from segtpu_torch import pretrained
    from segtpu_torch.models import get_model

    phase("pretrained: load only")
    numbers = {}
    for seed, (label, name, args, layout_args) in enumerate(PRETRAINED_LOAD_ONLY, start=3):
        model = get_model(name, device="cuda", num_classes=CLASSES, pretrained=True, **args)
        ref = get_model(name, device="cuda", num_classes=CLASSES, pretrained=True, **args)
        source = model if layout_args is None else get_model(
            name, device="cpu", num_classes=CLASSES, **layout_args)
        cid = pretrained.checkpoint_id(model)
        path = os.path.join(root, f"{cid}.pth")
        sd, write_s = write_seeded_pth(path, source, seed)
        del source
        torch.cuda.synchronize()
        t = time.perf_counter()
        check(pretrained.maybe_load_pretrained(model, {"pretrained_dir": root}) == path,
              f"{label}: not loaded from {path}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        n, n_params = check_pretrained_state(label, model.state_dict(), sd, ref, model)
        fed = pretrained.remap(model, sd)
        if name == "FCN8":
            check(fed["output.0.weight"][0] == "classifier.0.weight"
                  and sd["classifier.0.weight"].dim() == 2, "FCN8: conv6 not from FC6")
        if layout_args is not None:
            skipped = [k for k in sd if k.startswith(("layer3.", "layer4."))]
            check(skipped and not any(t.startswith(("backbone.layer3.", "backbone.layer4."))
                                      for t in fed), f"{label}: layer3/4 not skipped")
            print(f"{label}: the file's {len(skipped)} layer3/4 tensors skipped")
        numbers[f"{label} load"] = {"id": cid, "tensors": n, "params": n_params, "load_s": dt,
                                    "file_bytes": os.path.getsize(path)}
        print(f"pretrained: load only: {label} from {cid}.pth "
              f"({os.path.getsize(path) / 1e6:.1f} MB, written in {write_s:.2f} s): "
              f"{dt:.3f} s into the model on the card [{card}]")
        os.remove(path)
        del model, ref, sd, fed
        gc.collect()
        torch.cuda.empty_cache()
    return numbers


def main(argv=None):
    parser = argparse.ArgumentParser(description="Drive segtpu_torch on one GPU")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the inference images and the serving batch")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(args, workdir, time.perf_counter())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run(args, workdir, t_start):
    import torch

    from segtpu_torch.ops import build
    from segtpu_torch.ops import conv_wgrad as cw
    from segtpu_torch.ops import flatconv as fc

    dev = torch.device("cuda")
    phase("device")
    card = smi_name_power()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32: matmul.allow_tf32=False, cudnn.allow_tf32=False")
    for module in ("tensorboardX", "tensorboard"):  # the port writes events without either
        found = subprocess.run([sys.executable, "-c", f"import {module}"], capture_output=True,
                               text=True, timeout=120)
        print(f"python3 -c 'import {module}': exit {found.returncode} "
              f"{(found.stderr.strip().splitlines() or [''])[-1]}")

    phase("build")
    t0 = time.perf_counter()
    build.load_all(["stem_conv_wgrad", "flat_conv"])
    print(f"stem_conv_wgrad and flat_conv built (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    phase("kernel against plain")
    main_err = None
    for i, shape in enumerate([MAIN_SHAPE] + TEST_SHAPES):
        x, dy = wgrad_inputs(shape, i, dev)
        k = shape[-1]
        got = cw.stem_conv_wgrad(x, dy, kernel=k)
        ref = cw.stem_conv_wgrad_plain(x, dy, kernel=k)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (k, k, shape[3], shape[4]),
              f"shape {tuple(got.shape)} at {shape}")
        err, abs_err = rel_err(got, ref)
        print(f"stem_conv_wgrad {shape}: rel err {err:.3e}, max abs err "
              f"{abs_err:.3e} (tol {WGRAD_REL_TOL})")
        check(err < WGRAD_REL_TOL, f"stem_conv_wgrad disagrees at {shape}: {err}")
        if shape == MAIN_SHAPE:
            main_err = abs_err
            again = cw.stem_conv_wgrad(x, dy, kernel=k)
            torch.cuda.synchronize()
            print(f"stem_conv_wgrad {shape}: two launches bit-identical: "
                  f"{torch.equal(again, got)}")
            check(torch.equal(again, got), "two launches of stem_conv_wgrad differ")
            del again
        del x, dy, got, ref
    flat_err = {}
    for i, case in enumerate(FLAT_TEST_CASES + list(FLAT_FULL_SHAPES)):
        x, dy, wk = flat_inputs(case, 10 + i, dev)
        label = f"{case} {FLAT_FULL_SHAPES.get(case, 'test case')}"
        flat_err[case] = check_flat(label, x, dy, wk, *case[5:])
        del x, dy, wk
    torch.cuda.empty_cache()

    phase("flat_conv forward and backward (the flat-row kernels' own path)")
    n, h, w, c, o, k, p, d = STEM_CONV2
    g = torch.Generator(device=dev).manual_seed(200)
    x0 = torch.randn(n, c, h, w, generator=g, device=dev).to(
        memory_format=torch.channels_last)
    w0 = torch.randn(o, c, k, k, generator=g, device=dev) * 0.05
    up = torch.randn(n, o, h, w, generator=g, device=dev).to(
        memory_format=torch.channels_last)
    grads = {}
    for name in ("flat_conv", "F.conv2d"):
        xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        if name == "flat_conv":
            reset_launches()
            copies = fc.flat_conv_wgrad.copies + fc.flat_conv_dgrad.copies
            y = fc.flat_conv(xr, wr, (k, k), p, d)
        else:
            y = torch.nn.functional.conv2d(xr, wr, padding=p, dilation=d)
        (y * up).sum().backward()
        torch.cuda.synchronize()
        grads[name] = (xr.grad, wr.grad)
        if name == "flat_conv":
            flat_launches = read_launches()
            copies = fc.flat_conv_wgrad.copies + fc.flat_conv_dgrad.copies - copies
    print(f"flat_conv at {STEM_CONV2}: launches {flat_launches}, input copies {copies}")
    check(flat_launches == {"stem_conv_wgrad": 0, "flat_conv_wgrad": 1,
                            "flat_conv_dgrad": 1},
          f"flat_conv's backward launched {flat_launches}")
    for i, what in enumerate(("input", "weight")):
        err, _ = rel_err(grads["flat_conv"][i], grads["F.conv2d"][i])
        print(f"flat_conv {what} gradient vs fp32 autograd through F.conv2d: "
              f"rel err {err:.3e} (tol {GRAD_REL_TOL})")
        check(err < GRAD_REL_TOL, f"flat_conv's {what} gradient is off: {err}")
    g_nhwc = up.permute(0, 2, 3, 1)
    ref_w = fc.flat_conv_wgrad_plain(x0.permute(0, 2, 3, 1), g_nhwc, (k, k), p, d)
    ref_d = fc.flat_conv_dgrad_plain(g_nhwc, w0.permute(2, 3, 1, 0), (k, k), p, d)
    err_w = rel_err(grads["flat_conv"][1], ref_w.permute(3, 2, 0, 1))[0]
    err_d = rel_err(grads["flat_conv"][0], ref_d.permute(0, 3, 1, 2))[0]
    print(f"flat_conv weight gradient vs plain: rel err {err_w:.3e} (tol "
          f"{WGRAD_REL_TOL}); input gradient vs plain: rel err {err_d:.3e} "
          f"(tol {DGRAD_REL_TOL:.3e})")
    check(err_w < WGRAD_REL_TOL and err_d <= DGRAD_REL_TOL,
          f"flat_conv's gradients are not the kernels' ({err_w}, {err_d})")
    del x0, w0, up, grads, y, xr, wr, g_nhwc, ref_w, ref_d
    torch.cuda.empty_cache()

    phase("timings")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stem_times = []
    for shape, label in STEM_TIMED.items():
        n, h, w, c, co, k = shape
        x, dy = wgrad_inputs(shape, 100, dev)
        xb, dyb = x.bfloat16(), dy.bfloat16()
        del x, dy
        ho, wo = dyb.shape[1], dyb.shape[2]
        plan, per_sm, smem = cw.stem_launch_plan(xb.shape, co, k, dev)
        ring = (c, plan.kr, plan.kc, plan.cs, int(plan.span), plan.stages)
        kernel_smem = cw._lib().stem_conv_wgrad_smem_bytes(*ring)
        blocks = plan.row_blocks * plan.tap_groups * plan.o_tiles
        print(f"stem_conv_wgrad launch at {shape} ({label}): {plan}; shared memory "
              f"a block {smem} bytes by the plan, {kernel_smem} by the kernel; "
              f"{per_sm} blocks per SM by the runtime's occupancy, {blocks} blocks "
              f"on {sms} SMs ({blocks / (sms * per_sm):.3f} of one wave)", flush=True)
        check(kernel_smem == smem, f"the plan's shared memory {smem} is not the "
              f"kernel's {kernel_smem} at {shape}")
        # the kernel (and the reduction of its partials) launched on buffers
        # made once; and per call of the wrapper, its host time included
        out = torch.empty((k, k, c, co), dtype=torch.float32, device=dev)
        partial = torch.empty((plan.row_blocks, k * k * c, co), dtype=torch.float32,
                              device=dev)
        kernel_ms = cuda_ms(lambda: cw._launch(cw._lib(), xb, dyb, k, plan, partial, out),
                            iters=20)
        wrapper_ms = cuda_ms(lambda: cw.stem_conv_wgrad(xb, dyb, kernel=k), iters=20)
        plain_ms = cuda_ms(lambda: cw.stem_conv_wgrad_plain(xb, dyb, kernel=k), iters=5)
        x_nchw, dy_nchw = xb.permute(0, 3, 1, 2), dyb.permute(0, 3, 1, 2)
        library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            x_nchw, (co, c, k, k), dy_nchw, stride=2, padding=k // 2), iters=20)
        nbytes = xb.numel() * 2 + dyb.numel() * 2 + k * k * c * co * 4
        flops = 2 * n * ho * wo * k * k * c * co
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"stem_conv_wgrad at {shape} ({label}): kernel {kernel_ms:.4f} ms a launch "
              f"({wrapper_ms:.4f} ms a call of the wrapper), plain "
              f"{plain_ms:.4f} ms, library (conv2d_weight, cuDNN) {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP) [{card}]", flush=True)
        stem_times.append({
            "layer": label, "shape": {"x": [n, h, w, c], "dy": [n, ho, wo, co], "k": k},
            "ms": kernel_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "plan": plan._asdict(),
            "blocks_per_sm": per_sm, "smem_bytes": smem})
        del xb, dyb, x_nchw, dy_nchw, out, partial
        torch.cuda.empty_cache()

    flat_times = {"flat_conv_wgrad": [], "flat_conv_dgrad": []}
    for case, layer in FLAT_FULL_SHAPES.items():
        n, h, w, c, o, k, p, d = case
        x, dy, wk = flat_inputs(case, 300, dev)
        wb = wk.bfloat16()
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        w_oihw = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        flops = 2 * n * h * w * k * k * c * o
        rows = n * h * w
        # the plain versions are timed at the two shapes they always were;
        # both kernels at all five
        both = case in (STEM_CONV2, UPERNET_HEAD)
        plan, per_sm, smem = fc.wgrad_launch_plan(x.shape, o, (k, k), d, dev)
        print(f"flat_conv_wgrad launch at {case} ({layer}): {plan}, {per_sm} blocks "
              f"per SM, {smem} bytes of shared memory a block", flush=True)
        dplan, d_per_sm, d_smem = fc.dgrad_launch_plan(dy.shape, c, (k, k), d, dev)
        print(f"flat_conv_dgrad launch at {case} ({layer}): {dplan}, {d_per_sm} blocks "
              f"per SM, {d_smem} bytes of shared memory a block", flush=True)
        runs = {
            "flat_conv_wgrad": (
                lambda: fc.flat_conv_wgrad(x, dy, (k, k), p, d),
                lambda: fc.flat_conv_wgrad_plain(x, dy, (k, k), p, d),
                lambda: torch.nn.grad.conv2d_weight(x_nchw, (o, c, k, k), dy_nchw,
                                                    padding=p, dilation=d),
                rows * c * 2 + rows * o * 2 + k * k * c * o * 4,
                "torch.nn.grad.conv2d_weight (cuDNN, bf16 channels_last)"),
            "flat_conv_dgrad": (
                lambda: fc.flat_conv_dgrad(dy, wb, (k, k), p, d),
                lambda: fc.flat_conv_dgrad_plain(dy, wb, (k, k), p, d),
                lambda: torch.nn.grad.conv2d_input((n, c, h, w), w_oihw, dy_nchw,
                                                   padding=p, dilation=d),
                rows * o * 2 + k * k * c * o * 2 + rows * c * 2,
                "torch.nn.grad.conv2d_input (cuDNN, bf16 channels_last)"),
        }
        for name, (kern, plain, library, nbytes, lib_name) in runs.items():
            t_kernel = cuda_ms(kern, iters=20)
            t_plain = cuda_ms(plain, iters=3, warmup=1) if both else None
            t_library = cuda_ms(library, iters=20)
            b_ms, b_by = bound(nbytes, flops)
            plain_txt = f"{t_plain:.4f} ms" if both else "not timed"
            print(f"{name} at {case} ({layer}): kernel {t_kernel:.4f} ms, plain "
                  f"{plain_txt}, library ({lib_name}) {t_library:.4f} ms, bound "
                  f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP) [{card}]", flush=True)
            entry = {"layer": layer, "shape": list(case), "ms": t_kernel,
                     "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": t_library}
            if name == "flat_conv_wgrad":
                entry.update(tile_o=plan.tile_o, splits=plan.splits,
                             blocks_per_sm=per_sm, smem_bytes=smem)
            else:
                entry.update(tile_c=dplan.tile_c, ko=dplan.ko, taps=dplan.taps,
                             resident=dplan.resident, blocks=dplan.blocks,
                             blocks_per_sm=d_per_sm, smem_bytes=d_smem)
            flat_times[name].append(entry)
        del x, dy, wk, wb, x_nchw, dy_nchw, w_oihw, runs
        torch.cuda.empty_cache()

    phase("main path: PSPNet-R50")
    from segtpu_torch.models import get_model

    recorder = StepRecorder()
    psp_config = smoke_config({"type": "PSPNet", "args": {"backbone": "resnet50",
                                                         "pallas_stem_wgrad": True}},
                              os.path.join(workdir, "saved"), save_period=1,
                              save_per_iters=2)
    resume = {}
    recorder.snap_before = 2  # the state checkpoint-latest holds

    def checkpoints(trainer):
        phase("checkpoint and resume")
        resume["launches"], resume["numbers"] = checkpoint_and_resume(
            trainer, psp_config, recorder, workdir, card)
        resume["best"] = os.path.join(trainer.checkpoint_dir, "best_model")

    (trainer, psp_launches, (images, labels), (val_images, val_labels),
     psp_numbers) = train_main_path(
        "PSPNet-R50", psp_config,
        {"stem_conv_wgrad": STEPS, "flat_conv_wgrad": 0, "flat_conv_dgrad": 0}, card,
        recorder, after_train=checkpoints)
    print(f"stem_conv_wgrad dy copies {cw.stem_conv_wgrad.copies}")
    print("checkpoint and resume: " + json.dumps(resume["numbers"]))

    phase("in-step check: PSPNet-R50")
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    model_off = get_model("PSPNet", device="cuda", num_classes=CLASSES,
                          backbone="resnet50", pallas_stem_wgrad=False)
    on_io, off_io = {}, {}

    def stem_grad(model, imgs, lbls, dtype):
        step_backward(trainer, model, state, imgs, lbls, dtype)
        return model.initial[0][0].weight.grad.float().clone()

    def library_wgrad(x, dy):
        return torch.nn.grad.conv2d_weight(x, (64, 3, 3, 3), dy, stride=2, padding=1)

    def plain_of(store):
        xs, dys = store["x"], store["dy"]
        plain = cw.stem_conv_wgrad_plain(xs.permute(0, 2, 3, 1),
                                         dys.permute(0, 2, 3, 1), kernel=3)
        return xs, dys, plain.permute(3, 2, 0, 1)

    hooks = [m.initial[0][0].register_forward_hook(keep_io(store))
             for m, store in ((trainer.model, on_io), (model_off, off_io))]
    grad_bf16 = stem_grad(trainer.model, images, labels, torch.bfloat16)
    xs, dys, plain = plain_of(on_io)
    err, abs_err = rel_err(grad_bf16, plain)
    print(f"bf16 step, flag on: stem_conv1 weight gradient vs the plain version "
          f"on the step's own x and dy: rel err {err:.3e}, max abs err "
          f"{abs_err:.3e} (tol {WGRAD_REL_TOL})")
    check(err < WGRAD_REL_TOL, f"the step's stem gradient is not the kernel's: {err}")
    print(f"library (cuDNN, bf16) on the same x and dy vs plain: rel err "
          f"{rel_err(library_wgrad(xs, dys), plain)[0]:.3e}")
    again = stem_grad(trainer.model, images, labels, torch.bfloat16)
    print(f"bf16 step, flag on, run twice: stem_conv1 weight gradient rel err "
          f"{rel_err(again, grad_bf16)[0]:.3e} (run-to-run, not checked)")
    for batch, (imgs, lbls) in (("train batch", (images, labels)),
                                ("val batch", (val_images, val_labels))):
        grad_on = stem_grad(trainer.model, imgs, lbls, torch.float32)
        xs, dys, plain = plain_of(on_io)
        err, abs_err = rel_err(grad_on, plain)
        print(f"fp32 step, {batch}, flag on: stem_conv1 weight gradient vs the "
              f"plain version on the step's own x and dy: rel err {err:.3e}, "
              f"max abs err {abs_err:.3e} (tol {WGRAD_REL_TOL})")
        check(err < WGRAD_REL_TOL, f"the fp32 step's stem gradient is not the "
              f"kernel's: {err}")
        grad_off = stem_grad(model_off, imgs, lbls, torch.float32)
        check(torch.equal(off_io["x"], xs), "flag on and off saw other stem inputs")
        # The bf16 tolerance, per element: rounding x and dy to bf16 moves each
        # product by at most (2u + u^2)|x||dy|; the two steps' own dy differ
        # by run-to-run noise, which moves the sum by at most
        # sum |x||dy_on - dy_off|; 1e-4 sum |x||dy| covers fp32 sums taken in
        # other orders.
        bnd = ((2 * BF16_U + BF16_U ** 2 + 1e-4) * library_wgrad(xs.abs(), dys.abs())
               + library_wgrad(xs.abs(), (dys - off_io["dy"]).abs()))
        diff = (grad_on - grad_off).abs()
        share = (diff / bnd.clamp_min(1e-30)).max().item()
        print(f"fp32 step, {batch}, flag on vs flag off: stem_conv1 weight "
              f"gradient rel err {rel_err(grad_on, grad_off)[0]:.3e}; "
              f"max |on - off| / bf16 rounding bound {share:.3f} (must be <= 1)")
        check(bool((diff <= bnd).all()),
              f"flag on and off disagree past the bf16 bound on the {batch}: {share}")
    for hook in hooks:
        hook.remove()
    del on_io, off_io, xs, dys, plain, grad_bf16, again, grad_on, grad_off, bnd, diff
    del model_off

    stem_conv2 = trainer.model.initial[0][3]
    io = {}
    hook = stem_conv2.register_forward_hook(keep_io(io))
    step_backward(trainer, trainer.model, state, images, labels, torch.bfloat16)
    hook.remove()
    in_step = {"PSPNet-R50 stem_conv2": flat_in_step(
        "PSPNet-R50 stem_conv2 (initial.0.3)", stem_conv2, io)}
    del trainer, state, io, stem_conv2, images, labels, val_images, val_labels
    gc.collect()
    torch.cuda.empty_cache()

    phase("inference")
    infer_launches = inference_phase(resume["best"], workdir, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()

    phase("serving export")
    serve_launches = serving_phase(resume["best"], workdir, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()

    phase("main path: UperNet-R101")
    trainer, uper_launches, (images, labels), _, _ = train_main_path(
        "UperNet-R101", smoke_config({"type": "UperNet", "args": {"backbone": "resnet101"}},
                                     os.path.join(workdir, "saved")),
        {"stem_conv_wgrad": 0, "flat_conv_wgrad": 0, "flat_conv_dgrad": 0}, card,
        recorder)

    phase("in-step check: UperNet-R101")
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    convs = {"UperNet-R101 head": trainer.model.head,
             "UperNet-R101 FPN.smooth_conv.0": trainer.model.FPN.smooth_conv[0]}
    stores = {name: {} for name in convs}
    hooks = [conv.register_forward_hook(keep_io(stores[name]))
             for name, conv in convs.items()]
    step_backward(trainer, trainer.model, state, images, labels, torch.bfloat16)
    for hook in hooks:
        hook.remove()
    for name, conv in convs.items():
        in_step[name] = flat_in_step(name, conv, stores[name])
    del trainer, state, stores, convs, images, labels
    gc.collect()
    torch.cuda.empty_cache()

    deeplab_launches, deeplab_numbers = deeplab_phases(workdir, args.seed, card, recorder)
    print("deeplab: " + json.dumps(deeplab_numbers))

    zoo_launches, zoo_numbers = zoo_phases(workdir, args.seed, card, recorder)
    print("zoo: " + json.dumps(zoo_numbers))

    phase("losses on the card")
    loss_numbers = losses_phase(card)
    print("losses: " + json.dumps(loss_numbers))
    gc.collect()
    torch.cuda.empty_cache()

    phase("optimizers and freezes on the card")
    reset_launches()
    opt_numbers = optimizer_phase(workdir, card)
    opt_launches = read_launches()
    print("optimizers: " + json.dumps(opt_numbers) + f"; launches {opt_launches}")

    phase("data: CityScapes on disk")
    disk_launches, disk_numbers = disk_phase(workdir, args.seed, card, recorder)
    print("data: " + json.dumps(disk_numbers))
    gc.collect()
    torch.cuda.empty_cache()

    pre_launches, pre_numbers = pretrained_phases(workdir, card, recorder, psp_numbers,
                                                  zoo_numbers)
    print("pretrained: " + json.dumps(pre_numbers))

    phase("kernels")
    flat_note = ("no model calls flat_conv (segtpu's do not either): launches "
                 "are those of the flat_conv phase, 0 on every main path")
    paths = {"PSPNet-R50": psp_launches, "PSPNet-R50 resumed": resume["launches"],
             "inference": infer_launches, "serving export": serve_launches,
             "UperNet-R101": uper_launches, "PSPNet-R50 CityScapes on disk": disk_launches,
             **deeplab_launches, **zoo_launches, **pre_launches,
             "PSPNet-R50 optimizers and freezes (7 runs of 2 steps, 1 resumed step)":
                 opt_launches}
    stem_main = stem_times[0]
    kernels = [{
        "name": "stem_conv_wgrad", "route": "cuda",
        "source": "segtpu_torch/csrc/stem_conv_wgrad.cu",
        "replaces": "segtpu/ops/conv_wgrad.py:138",
        "shape": stem_main["shape"], "launches": psp_launches["stem_conv_wgrad"],
        "max_abs_err": main_err,
        **{key: stem_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
        "timings": stem_times,
        "main_path_launches": {k: v["stem_conv_wgrad"] for k, v in paths.items()}}]
    for name, line, idx in (("flat_conv_wgrad", "segtpu/ops/flatconv.py:168", 0),
                            ("flat_conv_dgrad", "segtpu/ops/flatconv.py:205", 1)):
        first = flat_times[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": "segtpu_torch/csrc/flat_conv.cu",
            "replaces": line, "shape": first["shape"],
            "launches": flat_launches[name], "launches_note": flat_note,
            "max_abs_err": flat_err[STEM_CONV2][idx],
            **{key: first[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
            "timings": flat_times[name],
            "in_step_max_abs_err": {k: v[idx] for k, v in in_step.items()},
            "main_path_launches": {k: v[name] for k, v in paths.items()}})
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s of "
          f"script time [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
