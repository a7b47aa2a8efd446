"""segtpu's GCN-R50 and the port's from the same random weights, on the CPU,
at the crop of ``chip_smoke.py``'s GCN-R50 path: the loss of one batch, one
SGD update at that path's first rate, and the loss of the next batch after
it, in fp32 on both sides.

The weights are the ones that path starts from: the port's ``get_model`` at
the config's seed, carried to segtpu by segtpu's own ``convert_gcn``. The
batches are the first images of the path's first two Synthetic batches
(its train loader, shuffle and augmentation included), normalized as the
trainer does. The update is the path's: SGD with momentum 0.9 and weight
decay 1e-4, two groups (backbone at lr/10), Poly over 2 steps, so the first
rate is 0.01 * 0.5**0.9. Prints each side's two losses and their relative
differences; the port's losses on the card (bf16, batch 8) are in
``chip_smoke.py``'s output.

    JAX_PLATFORMS=cpu python tests/torch_gcn_growth.py [--batch 1] [--threads 4]

Batch 1 at 769x769 takes about 5 GiB and a few minutes on 4 threads.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke
    from segtpu import losses as seg_losses
    from segtpu.core import state as seg_state
    from segtpu.core.steps import make_train_step as seg_make_train_step
    from segtpu.models.gcn import GCN as SegtpuGCN
    from segtpu.utils.weight_convert import convert_gcn
    from segtpu_torch import losses
    from segtpu_torch.core.state import TrainState, make_optimizer
    from segtpu_torch.core.steps import make_train_step
    from segtpu_torch.data import DATASETS
    from segtpu_torch.models import get_model
    from segtpu_torch.train import get_instance

    torch.set_num_threads(args.threads)
    arch = {"type": "GCN", "args": {"backbone": "resnet50"}}
    with tempfile.TemporaryDirectory() as save_dir:
        config = chip_smoke.smoke_config(arch, save_dir, steps=chip_smoke.ZOO_STEPS,
                                         val=False)
    config["train_loader"]["args"]["num_workers"] = 0
    loader = get_instance(DATASETS, "train_loader", config)
    mean, std = (np.asarray(v, np.float32).reshape(1, 1, 1, 3)
                 for v in (loader.dataset.mean, loader.dataset.std))
    data = []
    for images, labels in loader:
        x = (np.asarray(images[:args.batch], np.float32) / 255.0 - mean) / std
        data.append((x, np.asarray(labels[:args.batch], np.int32)))
    assert len(data) == 2, len(data)
    print(f"batches: {len(data)} x {data[0][0].shape} (NHWC, normalized)")

    sgd = dict(optimizer_type="SGD", lr=config["optimizer"]["args"]["lr"], momentum=0.9,
               weight_decay=1e-4, scheduler_type="Poly", num_epochs=1,
               iters_per_epoch=len(data), differential_lr=True)
    port = get_model("GCN", device="cpu", seed=config["seed"], num_classes=chip_smoke.CLASSES,
                     **arch["args"])
    # copies: the port's update below changes its tensors in place
    params, stats = convert_gcn({k: v.numpy().copy() for k, v in port.state_dict().items()},
                                "resnet50")

    t0 = time.perf_counter()
    opt, scheds = make_optimizer(port, **sgd)
    state = TrainState(port, opt, scheds)
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float32)
    port_losses = [float(step(state, torch.from_numpy(x), torch.from_numpy(y))[0])
                   for x, y in data]
    print(f"port (torch, CPU fp32): losses {port_losses} ({time.perf_counter() - t0:.0f} s)")

    t0 = time.perf_counter()
    tx, _ = seg_state.make_optimizer_with_schedules(**sgd)
    jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats=stats, opt_state=tx.init(params), tx=tx)
    jstep = seg_make_train_step(SegtpuGCN(num_classes=chip_smoke.CLASSES, backbone="resnet50"),
                                seg_losses.cross_entropy, chip_smoke.CLASSES,
                                compute_dtype=jnp.float32)
    seg_losses_ = []
    for x, y in data:
        jstate, loss, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        seg_losses_.append(float(loss))
    print(f"segtpu (JAX, CPU fp32): losses {seg_losses_} ({time.perf_counter() - t0:.0f} s)")
    rel = [abs(a - b) / abs(b) for a, b in zip(port_losses, seg_losses_)]
    print(f"relative differences: {rel}; growth over one update: port "
          f"{port_losses[1] / port_losses[0]:.3e}, segtpu {seg_losses_[1] / seg_losses_[0]:.3e}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
