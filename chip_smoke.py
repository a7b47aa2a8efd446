#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (segtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one GPU

Phases, each announced on its own line:

1. device: the card's name and power limit (nvidia-smi), versions, TF32 off;
2. build: every hand-written kernel from the sources in the checkout, one
   nvcc each, all started together;
3. kernel against plain: each kernel's wrapper on the card, at the main
   paths' shapes and the test shapes, held against its plain PyTorch
   version: the stem weight gradient, and the flat-row wgrad and dgrad at
   the seven test cases and five full-width layers of PSPNet and UperNet;
4. flat_conv: the flat-row kernels' own path. No model calls ``flat_conv``
   (segtpu's models do not either), so its launches are this phase's:
   forward and backward at PSPNet's stem_conv2 shape, with the counts set to
   0 just before and read just after, held against autograd through
   ``F.conv2d`` and against the plain versions;
5. timings: kernel, plain version, the library call that computes the same
   function (timed only as a yardstick) and the bound (bytes or operations
   over the card's peak rate), for the stem kernel at its main-path shape
   and for both flat-row kernels at PSPNet's stem_conv2 and UperNet's head;
6. PSPNet main path: ``segtpu_torch.train.main`` trains PSPNet-ResNet50 (19
   classes, 769x769 crops, batch 8, bf16 autocast, stem weight gradient
   through the kernel) for a few steps plus a validation pass, with every
   kernel's launch count set to 0 just before and read just after; then
   times the train step on one device-resident batch, and traces a few
   more steps with torch.profiler for the device time by kernel category
   and the device's idle share, under the same flags;
7. PSPNet in-step check, from the same weights: in a bf16 step and in an
   fp32 step, the stem conv's weight gradient against the plain version on
   that step's own x and dy; on two batches, the fp32 gradient with the
   kernel against the library's (flag on against flag off), held per
   element to the bound that rounding x and dy to bf16 can move it by; and
   both flat-row kernels on stem_conv2's x, dy and weight from the bf16
   step, against the plain versions. Two bf16 steps are not held to each
   other: the same bf16 step run twice gives another upstream gradient, and
   the script prints how far the stem gradient moves;
8. UperNet main path, after the PSPNet trainer is freed: UperNet-ResNet101
   (output stride 16, fpn_out 256, the same data, optimizer and dtype)
   trained, timed and traced as in phase 6;
9. UperNet in-step check: both flat-row kernels on the x, dy and weight of
   ``head`` and ``FPN.smooth_conv.0`` from one bf16 step, against the plain
   versions, with cuDNN's own gradients printed beside them (not gated);
10. the ``kernels`` JSON line, then the card's name and power limit, then
    ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises and exits non-zero; without a GPU it exits non-zero
before printing any result.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
MAIN_SHAPE = (8, 769, 769, 3, 64, 3)  # n, h, w, c, co, k of the stem conv
TEST_SHAPES = [(2, 65, 65, 3, 64, 7), (1, 32, 48, 3, 16, 7),
               (2, 64, 64, 4, 32, 7), (2, 65, 65, 3, 64, 3),
               (2, 33, 47, 5, 16, 3)]
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
TIMED_STEPS, TRACED_STEPS = 5, 3
# kernel-name substrings -> category of the traced step, first match wins
CATEGORIES = [
    ("stem_wgrad", "stem weight gradient (segtpu_torch CUDA kernel)"),
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


def smoke_config(arch):
    synthetic = {"num_classes": CLASSES, "batch_size": BATCH, "crop_size": CROP,
                 "num_workers": 8, "device_normalize": True}
    return {
        "name": "ChipSmoke", "seed": 0,
        "arch": arch,
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": BATCH * STEPS, "image_hw": 800,
            "flip": True, "shuffle": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": BATCH, "image_hw": CROP, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "log_per_iter": 1, "val": True,
                    "monitor": "max Mean_IoU", "compute_dtype": "bfloat16"},
    }


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise RuntimeError("chip_smoke: torch.profiler event without a device time")


def profile_steps(step, steps, card):
    """Trace ``steps`` calls of ``step``; print the wall and device time per
    step, the idle share and the device time by kernel category."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    sums = {}
    for e in kernels:
        cat = next((c for key, c in CATEGORIES if key in e.key), "other")
        sums[cat] = sums.get(cat, 0.0) + device_us(e) / 1e3 / steps
    for cat, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms/step {ms / busy_ms:6.3f}  {cat}")
    other = [e for e in kernels if not any(key in e.key for key, _ in CATEGORIES)]
    for title, events in (("largest kernels", kernels), ("largest of other", other)):
        print(f"  {title} (ms/step, calls/step):")
        for e in sorted(events, key=device_us, reverse=True)[:8 if events is kernels else 4]:
            print(f"  {device_us(e) / 1e3 / steps:8.3f} {e.count / steps:5.1f}  {e.key[:100]}")


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


def train_main_path(label, arch, want_launches, card):
    """Train ``arch`` through ``segtpu_torch.train.main`` with the launch
    counts set to 0 just before and read just after; check the epoch log and
    an eval step; time and trace the train step. Returns (trainer, launches,
    one device-resident train batch, one val batch)."""
    import torch

    from segtpu_torch import train as train_cli
    from segtpu_torch.trainer import _to_device

    dev = torch.device("cuda")
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main(smoke_config(arch), "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"trainer: {trainer.state.step} steps + validation in {wall:.1f} s "
          f"(model build and data included); launches {launches}")
    check(trainer.state.step == STEPS, f"{trainer.state.step} steps, want {STEPS}")
    check(launches == want_launches,
          f"{label} launched {launches} in {STEPS} steps, want {want_launches}")
    log = trainer.history[-1]
    print(f"epoch log: loss {log['loss']}, val_loss {log['val_loss']}, "
          f"Mean_IoU {log['Mean_IoU']}, Pixel_Accuracy {log['Pixel_Accuracy']}")
    check(math.isfinite(log["loss"]) and math.isfinite(log["val_loss"]),
          f"non-finite loss {log}")
    check(0.0 <= log["Mean_IoU"] <= 1.0 and 0.0 <= log["Pixel_Accuracy"] <= 1.0,
          f"metrics out of range {log}")

    val_images, val_labels = _to_device(next(iter(trainer.val_loader)), dev)
    loss, stats = trainer.eval_step(trainer.model, val_images, val_labels)
    correct, labeled = float(stats.correct), float(stats.labeled)
    check(math.isfinite(float(loss)), "non-finite eval loss")
    check(labeled == BATCH * CROP * CROP, f"labeled {labeled}")
    check(0 <= correct <= labeled and float(stats.inter.sum()) == correct
          and bool((stats.inter <= stats.union).all()), f"SegStats {stats}")

    images, labels = _to_device(next(iter(trainer.train_loader)), dev)
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(2 + TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_step(trainer.state, images, labels)
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - t)
    ms_step = 1e3 * sum(step_s) / len(step_s)
    print(f"main path: {label} {CROP}x{CROP} bs{BATCH} bf16 train step "
          f"{ms_step:.1f} ms/step (min {1e3 * min(step_s):.1f}), "
          f"{BATCH * 1e3 / ms_step:.2f} imgs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    profile_steps(lambda: trainer.train_step(trainer.state, images, labels),
                  TRACED_STEPS, card)
    return trainer, launches, (images, labels), (val_images, val_labels)


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2

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
    n, h, w, c, co, k = MAIN_SHAPE
    x, dy = wgrad_inputs(MAIN_SHAPE, 100, dev)
    xb, dyb = x.bfloat16(), dy.bfloat16()
    del x, dy
    ho, wo = dyb.shape[1], dyb.shape[2]
    kernel_ms = cuda_ms(lambda: cw.stem_conv_wgrad(xb, dyb, kernel=k), iters=20)
    plain_ms = cuda_ms(lambda: cw.stem_conv_wgrad_plain(xb, dyb, kernel=k), iters=5)
    x_nchw, dy_nchw = xb.permute(0, 3, 1, 2), dyb.permute(0, 3, 1, 2)
    library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
        x_nchw, (co, c, k, k), dy_nchw, stride=2, padding=k // 2), iters=20)
    nbytes = xb.numel() * 2 + dyb.numel() * 2 + k * k * c * co * 4
    flops = 2 * n * ho * wo * k * k * c * co
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"stem_conv_wgrad at {MAIN_SHAPE}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library (conv2d_weight, cuDNN) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP) [{card}]")
    del xb, dyb, x_nchw, dy_nchw
    stem_shape = {"x": [n, h, w, c], "dy": [n, ho, wo, co], "k": k}
    stem_times = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": library_ms}

    flat_times = {"flat_conv_wgrad": [], "flat_conv_dgrad": []}
    for case in (STEM_CONV2, UPERNET_HEAD):
        n, h, w, c, o, k, p, d = case
        x, dy, wk = flat_inputs(case, 300, dev)
        wb = wk.bfloat16()
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        w_oihw = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        flops = 2 * n * h * w * k * k * c * o
        rows = n * h * w
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
            t_plain = cuda_ms(plain, iters=3, warmup=1)
            t_library = cuda_ms(library, iters=20)
            b_ms, b_by = bound(nbytes, flops)
            print(f"{name} at {case} ({FLAT_FULL_SHAPES[case]}): kernel "
                  f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, library ({lib_name}) "
                  f"{t_library:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                  f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) [{card}]",
                  flush=True)
            flat_times[name].append({
                "layer": FLAT_FULL_SHAPES[case], "shape": list(case),
                "ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": t_library})
        del x, dy, wk, wb, x_nchw, dy_nchw, w_oihw, runs
        torch.cuda.empty_cache()

    phase("main path: PSPNet-R50")
    from segtpu_torch.models import get_model

    trainer, psp_launches, (images, labels), (val_images, val_labels) = train_main_path(
        "PSPNet-R50", {"type": "PSPNet",
                       "args": {"backbone": "resnet50", "pallas_stem_wgrad": True}},
        {"stem_conv_wgrad": STEPS, "flat_conv_wgrad": 0, "flat_conv_dgrad": 0}, card)
    print(f"stem_conv_wgrad dy copies {cw.stem_conv_wgrad.copies}")

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

    phase("main path: UperNet-R101")
    trainer, uper_launches, (images, labels), _ = train_main_path(
        "UperNet-R101", {"type": "UperNet", "args": {"backbone": "resnet101"}},
        {"stem_conv_wgrad": 0, "flat_conv_wgrad": 0, "flat_conv_dgrad": 0}, card)

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

    phase("kernels")
    flat_note = ("no model calls flat_conv (segtpu's do not either): launches "
                 "are those of the flat_conv phase, 0 on both models' main paths")
    kernels = [{
        "name": "stem_conv_wgrad", "route": "cuda",
        "source": "segtpu_torch/csrc/stem_conv_wgrad.cu",
        "replaces": "segtpu/ops/conv_wgrad.py:138",
        "shape": stem_shape, "launches": psp_launches["stem_conv_wgrad"],
        "max_abs_err": main_err, **stem_times}]
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
            "main_path_launches": {"PSPNet-R50": psp_launches[name],
                                   "UperNet-R101": uper_launches[name]}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
