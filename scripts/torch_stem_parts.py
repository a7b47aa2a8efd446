#!/usr/bin/env python3
"""Where the stem weight-gradient kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_stem_parts.py               # from the root of a checkout
    python3 scripts/torch_stem_parts.py --source DIR  # DIR: another checkout

Builds ``segtpu_torch/csrc/stem_conv_wgrad.cu`` three times, one nvcc each,
all started together: as it is, with ``STEM_WGRAD_SKIP_COPIES`` (only the
first tiles are staged; the products run on stale tiles) and with
``STEM_WGRAD_SKIP_PRODUCTS`` (the staging runs, no products). Times each
through the wrapper ``stem_conv_wgrad`` with the launch plan it uses, at the
PSPNet-R50 stem's shape (x 8x769x769x3, dy 8x385x385x64, k 3) and at k 7 on
the same x, beside cuDNN's ``conv2d_weight`` on the same bf16 tensors (a
yardstick only) and the bound (bytes or operations over the card's peak
rates). Each time of this checkout's builds is given twice, both from CUDA
events around 20 calls: per call of the wrapper (its host time included
where the card outruns it) and per launch of the kernels on buffers made
once (the kernel and the reduction of its partials alone). The full build is
also timed with fewer blocks an SM than its plan takes (and the deeper rings
they leave room for). The two
skipping builds give a wrong dW and are for timing only; the full build is
checked against the plain version and, launched twice, against itself bit
for bit.

``--source DIR`` names another checkout of the repository (the parent
commit unpacked by ``git archive``, say). Its ``stem_conv_wgrad.cu`` is built
with its own wrapper and plan, checked against the plain version and timed in
turns with this checkout's (other, this, this, other), so that two versions
are compared in one run on one card. Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = {(8, 769, 769, 3, 64, 3): "PSPNet-R50 stem (main path)",
          (8, 769, 769, 3, 64, 7): "the same x and dy width at k 7"}
BUILDS = {"full": [], "copies skipped": ["-DSTEM_WGRAD_SKIP_COPIES"],
          "products skipped": ["-DSTEM_WGRAD_SKIP_PRODUCTS"]}
# caps on the blocks an SM the full build is also timed with
BLOCKS_VARIANTS = (3, 2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
WGRAD_REL_TOL = 5e-3       # chip_smoke.py's tolerance against the plain version


def _module(tree: Path, name: str):
    """``segtpu_torch/ops/conv_wgrad.py`` of ``tree`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        name, tree / "segtpu_torch" / "ops" / "conv_wgrad.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bind(mod, lib):
    """Let ``mod``'s wrapper launch ``lib``: its own ``_lib`` sets the
    argument types on ``lib`` (handed over in place of a build)."""
    from segtpu_torch.ops import build

    with mock.patch.object(build, "load", lambda name: lib):
        mod._lib.__wrapped__()
    return lib


def main():
    import torch

    from segtpu_torch.ops import build
    from segtpu_torch.ops import conv_wgrad as cw

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path, default=None,
                        help="another checkout whose stem kernel is timed beside this one")
    other_tree = parser.parse_args().source
    if not torch.cuda.is_available():
        print("torch_stem_parts: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: (build.CSRC / "stem_conv_wgrad.cu", flags)
               for name, flags in BUILDS.items()}
    if other_tree is not None:
        other_tree = other_tree.resolve()
        sources["other"] = (other_tree / "segtpu_torch" / "csrc" / "stem_conv_wgrad.cu", [])
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o",
         str(out_dir / f"stem_{i}_{os.getpid()}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (name, (src, flags)) in enumerate(sources.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"stem_{i}_{os.getpid()}.so"))
    mods = {name: cw for name in BUILDS}
    if other_tree is not None:
        mods["other"] = _module(other_tree, "stem_other_conv_wgrad")
    for name, lib in libs.items():
        _bind(mods[name], lib)
    # this checkout's plan (its occupancy queries) from its own full build
    cw._lib = lambda: libs["full"]

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

    def launcher(name, x, dy, k):
        """The kernels of build ``name`` launched on buffers made once."""
        plan, _, _ = cw.stem_launch_plan(x.shape, dy.shape[3], k, x.device)
        c, co = x.shape[3], dy.shape[3]
        out = torch.empty((k, k, c, co), dtype=torch.float32, device=x.device)
        partial = torch.empty((plan.row_blocks, k * k * c, co), dtype=torch.float32,
                              device=x.device)
        return lambda: cw._launch(libs[name], x, dy, k, plan, partial, out)

    def run_with(name, x, dy, k):
        mod = mods[name]
        saved = mod._lib
        mod._lib = lambda: libs[name]
        try:
            return mod.stem_conv_wgrad(x, dy, kernel=k)
        finally:
            mod._lib = saved

    dev = torch.device("cuda")
    print(f"{card}; this checkout {ROOT}; other {other_tree}", flush=True)
    for case, label in SHAPES.items():
        n, h, w, c, co, k = case
        ho, wo = (h + 2 * (k // 2) - k) // 2 + 1, (w + 2 * (k // 2) - k) // 2 + 1
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, h, w, c, generator=g, device=dev).bfloat16()
        dy = torch.randn(n, ho, wo, co, generator=g, device=dev).bfloat16()
        ref = cw.stem_conv_wgrad_plain(x, dy, k)
        nbytes = x.numel() * 2 + dy.numel() * 2 + k * k * c * co * 4
        flops = 2 * n * ho * wo * k * k * c * co
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        print(f"{label} {case}: bound {max(bytes_ms, ops_ms):.4f} ms by "
              f"{'bytes' if bytes_ms >= ops_ms else 'operations'} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP) [{card}]", flush=True)
        if hasattr(cw, "stem_launch_plan"):
            print(f"{label} {case}: plan {cw.stem_launch_plan(x.shape, co, k, dev)}",
                  flush=True)
        for name in ("full", "other"):
            if name not in libs:
                continue
            got = run_with(name, x, dy, k)
            again = run_with(name, x, dy, k)
            torch.cuda.synchronize()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if rel >= WGRAD_REL_TOL:
                raise RuntimeError(f"the {name} build disagrees with plain at {case}: {rel}")
            print(f"{label} {case}: {name} build rel err {rel:.3e} (tol {WGRAD_REL_TOL}), "
                  f"two launches bit-identical: {torch.equal(got, again)}", flush=True)
        order = ["other", "full", "full", "other"] if "other" in libs else ["full"]
        order += ["copies skipped", "products skipped"]
        def timed(name):
            text = f"{cuda_ms(lambda: run_with(name, x, dy, k)):.4f} ms a call"
            if mods[name] is cw:
                text += f", {cuda_ms(launcher(name, x, dy, k)):.4f} ms a launch"
            return text

        for name in order:
            print(f"{label} {case}: {name}: {timed(name)} [{card}]", flush=True)
        default = cw.MAX_BLOCKS_PER_SM
        for cap in BLOCKS_VARIANTS:
            cw.MAX_BLOCKS_PER_SM = cap
            cw._launch_plan.cache_clear()
            try:
                plan = cw.stem_launch_plan(x.shape, co, k, dev)
                print(f"{label} {case}: full, at most {cap} blocks an SM: {timed('full')} "
                      f"({plan}) [{card}]", flush=True)
            finally:
                cw.MAX_BLOCKS_PER_SM = default
                cw._launch_plan.cache_clear()
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)

        def library():
            return torch.nn.grad.conv2d_weight(x_nchw, (co, c, k, k), dy_nchw, stride=2,
                                               padding=k // 2)

        print(f"{label} {case}: cuDNN conv2d_weight: {cuda_ms(library):.4f} ms a call "
              f"[{card}]", flush=True)
        del x, dy, ref, x_nchw, dy_nchw
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
