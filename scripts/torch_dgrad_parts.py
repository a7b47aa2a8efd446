#!/usr/bin/env python3
"""Where the flat-row dgrad kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_dgrad_parts.py      # from the root of a checkout
    python3 scripts/torch_dgrad_parts.py --source other/flat_conv.cu

Builds ``segtpu_torch/csrc/flat_conv.cu`` three times: as it is, with
``FLAT_DGRAD_SKIP_COPIES`` (only the first stages are staged; the products
run on stale windows) and with ``FLAT_DGRAD_SKIP_PRODUCTS`` (the staging and
the epilogue run, no products). Times each with the launch plan
``flat_conv_dgrad`` uses, at the five full-width layers of PSPNet-R50 and
UperNet-R101, beside cuDNN's ``conv2d_input`` on the same bf16 channels_last
tensors (a yardstick only); the full build also with other c tiles and o
chunks at some layers, to show what the plan's tiling buys. The two skipping
builds give wrong dx and are for timing only; the full build is checked
against the plain version. Prints the card's name and power limit.
``--source`` times another version of ``flat_conv.cu`` with the same C
interface, so that two versions can be compared in one run on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = {(8, 385, 385, 64, 64, 3, 1, 1): "PSPNet-R50 stem_conv2",
          (8, 385, 385, 64, 128, 3, 1, 1): "PSPNet-R50 stem_conv3",
          (8, 97, 97, 512, 512, 3, 4, 4): "PSPNet-R50 layer4 dilated conv2",
          (8, 193, 193, 256, 19, 3, 1, 1): "UperNet-R101 head",
          (8, 193, 193, 256, 256, 3, 1, 1): "UperNet-R101 FPN.smooth_conv.0"}
BUILDS = {"full": [], "copies skipped": ["-DFLAT_DGRAD_SKIP_COPIES"],
          "products skipped": ["-DFLAT_DGRAD_SKIP_PRODUCTS"]}
# other (c tile, o chunk) pairs the full build is timed with, beside the plan's
VARIANTS = {(8, 385, 385, 64, 64, 3, 1, 1): [(64, 32)],
            (8, 385, 385, 64, 128, 3, 1, 1): [(64, 32)],
            (8, 97, 97, 512, 512, 3, 4, 4): [(128, 64), (128, 32)],
            (8, 193, 193, 256, 256, 3, 1, 1): [(128, 64), (128, 32)]}
DGRAD_REL_TOL = 2.0 ** -7  # one bf16 ulp of the largest value (chip_smoke.py)


def main():
    import torch

    from segtpu_torch.ops import build
    from segtpu_torch.ops import flatconv as fc

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path, default=build.CSRC / "flat_conv.cu",
                        help="the flat_conv.cu to build (default: the checkout's)")
    source = parser.parse_args().source.resolve()
    if not torch.cuda.is_available():
        print("torch_dgrad_parts: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o",
         str(out_dir / f"flat_conv_d{i}_{os.getpid()}.so"),
         str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (name, flags) in enumerate(BUILDS.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"flat_conv_d{i}_{os.getpid()}.so"))
        lib.flat_conv_dgrad.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 15
                                        + [ctypes.c_void_p])
        lib.flat_conv_dgrad_occupancy.argtypes = [ctypes.c_int] * 8 + [
            ctypes.POINTER(ctypes.c_int)]
        libs[name] = lib

    def cuda_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{card}; source {source}")
    for case, layer in SHAPES.items():
        n, h, w, c, o, k, p, d = case
        g = torch.Generator(device=dev).manual_seed(0)
        dy = torch.randn(n, h, w, o, generator=g, device=dev).bfloat16()
        wk = (torch.randn(k, k, c, o, generator=g, device=dev) * 0.05).bfloat16()
        ow = -(-o // 8) * 8
        wp = torch.nn.functional.pad(wk, (0, ow - o)).contiguous()
        ref = fc.flat_conv_dgrad_plain(dy, wk, (k, k), p, d)
        dx = torch.empty((n, h, w, c), dtype=torch.bfloat16, device=dev)
        runs = [(name, lib, None) for name, lib in libs.items()]
        runs += [(f"full, c tile {t[0]}, o chunk {t[1]}", libs["full"], t)
                 for t in VARIANTS.get(case, [])]
        for name, lib, tiles in runs:
            tile_c, ko, taps, resident = fc.dgrad_tiling(c, o, k, k, d, *(tiles or ()))
            per_sm, smem = fc.dgrad_occupancy(lib, o, k, k, d, tile_c, ko, taps, resident)
            plan = fc.dgrad_plan(n * h * w, c, o, k, k, d, sms, per_sm, tile_c, ko)

            def run():
                err = lib.flat_conv_dgrad(
                    dy.data_ptr(), wp.data_ptr(), dx.data_ptr(), n, h, w, c, o, ow, k, k,
                    p, d, plan.tile_c, plan.ko, plan.taps, int(plan.resident), plan.blocks,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            note = ""
            if name.startswith("full"):
                rel = ((dx.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
                if rel > DGRAD_REL_TOL:
                    raise RuntimeError(f"full build disagrees with plain at {case}: {rel}")
                note = f", rel err {rel:.2e}"
            print(f"{layer} {case}: {name}: {cuda_ms(run):.4f} ms ({plan}, {per_sm} "
                  f"blocks per SM, {smem} bytes{note}) [{card}]", flush=True)
        dy_nchw = dy.permute(0, 3, 1, 2)
        w_oihw = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_input(
            (n, c, h, w), w_oihw, dy_nchw, padding=p, dilation=d))
        print(f"{layer} {case}: cuDNN conv2d_input: {lib_ms:.4f} ms [{card}]", flush=True)
        del dy, wk, wp, ref, dx, dy_nchw, w_oihw
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
