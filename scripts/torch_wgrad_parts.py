#!/usr/bin/env python3
"""Where the flat-row wgrad kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_wgrad_parts.py      # from the root of a checkout

Builds ``segtpu_torch/csrc/flat_conv.cu`` three times: as it is, with
``FLAT_WGRAD_SKIP_COPIES`` (only the first chunks are staged; the products
run on stale tiles) and with ``FLAT_WGRAD_SKIP_PRODUCTS`` (the staging runs,
no products). Times each with the launch plan ``flat_conv_wgrad`` uses, at
PSPNet's stem_conv2, UperNet's head and ``FPN.smooth_conv.0``; where O <= 32
also the full build with the 64-wide o tile O > 32 takes, to show what the
narrow tile buys. The two skipping builds give wrong dW and are for timing
only; the full build is checked against the plain version. Prints the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = {(8, 385, 385, 64, 64, 3, 1, 1): "PSPNet-R50 stem_conv2",
          (8, 193, 193, 256, 19, 3, 1, 1): "UperNet-R101 head",
          (8, 193, 193, 256, 256, 3, 1, 1): "UperNet-R101 FPN.smooth_conv.0"}
BUILDS = {"full": [], "copies skipped": ["-DFLAT_WGRAD_SKIP_COPIES"],
          "products skipped": ["-DFLAT_WGRAD_SKIP_PRODUCTS"]}


def main():
    import torch

    from segtpu_torch.ops import build
    from segtpu_torch.ops import flatconv as fc

    if not torch.cuda.is_available():
        print("torch_wgrad_parts: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o",
         str(out_dir / f"flat_conv_{i}_{os.getpid()}.so"),
         str(build.CSRC / "flat_conv.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (name, flags) in enumerate(BUILDS.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"flat_conv_{i}_{os.getpid()}.so"))
        lib.flat_conv_wgrad.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                                        + [ctypes.c_void_p])
        lib.flat_conv_wgrad_occupancy.argtypes = [ctypes.c_int] * 4 + [
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
    print(card)
    for case, layer in SHAPES.items():
        n, h, w, c, o, k, p, d = case
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, h, w, c, generator=g, device=dev).bfloat16()
        dy = torch.randn(n, h, w, o, generator=g, device=dev).bfloat16()
        ref = fc.flat_conv_wgrad_plain(x, dy, (k, k), p, d)
        tile_o, taps = fc.wgrad_tiling(k, o, d)
        runs = [(name, lib, tile_o) for name, lib in libs.items()]
        if o <= 32:
            runs.append(("full, 64-wide o tile", libs["full"], 64))
        for name, lib, tile in runs:
            per_sm, _ = fc.wgrad_occupancy(lib, o, d, tile, taps)
            plan = fc.wgrad_plan(n * h * w, k, k, c, o, d, sms, per_sm, tile_o=tile)
            out = torch.empty((k, k, c, o), dtype=torch.float32, device=dev)
            part = out if plan.splits == 1 else torch.empty(
                (plan.splits, k, k, c, o), dtype=torch.float32, device=dev)

            def run():
                err = lib.flat_conv_wgrad(
                    x.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(),
                    n, h, w, c, o, k, k, p, d, plan.tile_o, plan.taps, plan.splits,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            note = ""
            if name.startswith("full"):
                rel = ((out - ref).abs().max() / ref.abs().max()).item()
                if rel >= 5e-3:
                    raise RuntimeError(f"full build disagrees with plain at {case}: {rel}")
                note = f", rel err {rel:.2e}"
            print(f"{layer} {case}: {name}: {cuda_ms(run):.4f} ms ({per_sm} blocks per "
                  f"SM, {plan.splits} splits{note}) [{card}]", flush=True)
        del x, dy, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
