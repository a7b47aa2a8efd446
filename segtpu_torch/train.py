"""Training CLI with segtpu's config surface:

    python -m segtpu_torch.train --config config.json [--device cpu | -d 0,1]
    python -m segtpu_torch.train --resume saved/<name>/<ts>/checkpoint-epoch5
    torchrun --nproc-per-node 4 -m segtpu_torch.train --config config.json

The config schema is segtpu's (``train.py``): name, arch, train_loader,
val_loader, optimizer, loss, ignore_index, lr_scheduler, trainer. With
``--resume`` and no ``--config`` the config is the checkpoint's own.
``--device`` defaults to ``cuda``; the CPU is used only when asked for; a
list of GPU ids ("0,2", segtpu's ``-d``) sets ``trainer.device_ids``.

Data parallel, one process a device: on the card the run takes
``trainer.device_ids``, else the first ``trainer.devices``, else every
visible GPU; with ``--device cpu``, ``trainer.devices`` processes (1 by
default). One device runs in this process, with no process group; more
are started here, joined in one group (NCCL on the card, gloo on the CPU),
rank i on the i-th device. Under torchrun (``RANK`` and ``WORLD_SIZE``
set) this process joins torchrun's group instead. The config's
``batch_size`` is each node's, split over its devices. With
``trainer.model_parallel`` the devices form segtpu's (data, model) mesh:
``devices`` and ``device_ids`` count all of it, and the batch splits over
its data ranks (``core/mesh.py``).
"""

from __future__ import annotations

import argparse
import json
import logging


def get_instance(registry, name, config, *args, **extra):
    cfg = config[name]
    if cfg["type"] not in registry:
        raise KeyError(f"unknown {name} type {cfg['type']!r}; available: "
                       f"{sorted(registry)}")
    return registry[cfg["type"]](*args, **{**cfg["args"], **extra})


def plan_devices(config, device="cuda"):
    """The device of each rank of a run started here ("cpu" or
    "cuda:<i>"): see the module's docstring. Raises when more GPUs are
    asked for than are visible, and when none is."""
    from segtpu_torch import resolve_device
    from segtpu_torch.trainer import device_ids

    kind = resolve_device(device).type
    ids = device_ids(config.get("trainer", {}))
    if kind == "cpu":
        return ["cpu"] * (len(ids) if ids else 1)
    import torch

    visible = torch.cuda.device_count()
    if ids is None:
        ids = list(range(visible))
    if not ids or max(ids) >= visible or min(ids) < 0:
        raise ValueError(f"GPUs {ids} asked for, {visible} visible")
    if len(set(ids)) != len(ids):
        raise ValueError(f"GPU ids {ids} repeat one: NCCL takes one rank a GPU")
    return [f"cuda:{i}" for i in ids]


def run(config, device="cuda", resume=None):
    """Train ``config`` on the devices it asks for (:func:`plan_devices`),
    or, under torchrun, as this process's rank."""
    import os

    from segtpu_torch.core import mesh

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        from segtpu_torch import resolve_device
        from segtpu_torch.trainer import rank_device

        mesh.init_from_env(resolve_device(device).type)
        try:
            return main(config, str(rank_device(device, config.get("trainer", {}))),
                        resume)
        finally:
            mesh.shutdown()
    devices = plan_devices(config, device)
    if len(devices) == 1:
        return main(config, devices[0], resume)
    mesh.launch(_rank_main, (config, resume), devices)
    return None


def _rank_main(device, config, resume):
    main(config, device, resume)


def main(config, device="cuda", resume=None):
    from segtpu_torch import resolve_device
    from segtpu_torch.core import mesh
    from segtpu_torch.data import DATASETS
    from segtpu_torch.models import get_model
    from segtpu_torch.ops.conv_wgrad import stem_conv_wgrad
    from segtpu_torch.ops.flatconv import flat_conv_dgrad, flat_conv_wgrad
    from segtpu_torch.trainer import Trainer
    from segtpu_torch.utils.logger import Logger, setup_logging

    device = resolve_device(device)
    logger = setup_logging(logging.INFO if mesh.is_main() else logging.WARNING)
    train_loader = get_instance(DATASETS, "train_loader", config)
    val_loader = None
    if "val_loader" in config:
        val_loader = get_instance(DATASETS, "val_loader", config)
    elif getattr(train_loader, "val_split", 0):
        val_loader = train_loader.get_val_loader()
    arch = config["arch"]
    model = get_model(arch["type"], device=device, seed=config.get("seed", 0),
                      num_classes=train_loader.dataset.num_classes,
                      **arch.get("args", {}))
    logger.info(f"model: {type(model).__name__} on {device}")
    trainer = Trainer(model, config["loss"], config, train_loader, val_loader,
                      device=device, resume=resume, train_logger=Logger())
    trainer.train()
    logging.getLogger("segtpu_torch.train").info("kernel launches: " + ", ".join(
        f"{fn.__name__}={fn.launches}"
        for fn in (stem_conv_wgrad, flat_conv_wgrad, flat_conv_dgrad)))
    return trainer


def apply_device_arg(config, device: str):
    """``(config, device)`` for ``-d``: ``cuda`` and ``cpu`` as they are; a
    list of GPU ids sets ``trainer.device_ids`` (segtpu's ``-d``) on
    cuda."""
    if device in ("cuda", "cpu"):
        return config, device
    ids = [i.strip() for i in device.split(",") if i.strip()]
    if not ids or not all(i.isdigit() for i in ids):
        raise SystemExit(f"--device: cuda, cpu or GPU ids such as 0,2; got {device!r}")
    trainer = {**config.get("trainer", {}), "device_ids": ",".join(ids)}
    return {**config, "trainer": trainer}, "cuda"


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="segtpu_torch training")
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="Path to the config file (default: the resumed "
                             "checkpoint's, else config.json)")
    parser.add_argument("-r", "--resume", default=None, type=str,
                        help="Path to the checkpoint directory to resume from")
    parser.add_argument("-d", "--device", default="cuda",
                        help="cuda (default), cpu, or GPU ids such as 0,2 (sets "
                             "trainer.device_ids)")
    args = parser.parse_args()
    config = None
    if args.resume and args.config is None:
        from segtpu_torch.checkpoint import load_config_from_checkpoint

        config = load_config_from_checkpoint(args.resume)
    if config is None:
        with open(args.config or "config.json") as f:
            config = json.load(f)
    run(*apply_device_arg(config, args.device), args.resume)
