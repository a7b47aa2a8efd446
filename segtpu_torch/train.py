"""Training CLI with segtpu's config surface:

    python -m segtpu_torch.train --config config.json [--device cpu]
    python -m segtpu_torch.train --resume saved/<name>/<ts>/checkpoint-epoch5

The config schema is segtpu's (``train.py``): name, arch, train_loader,
val_loader, optimizer, loss, ignore_index, lr_scheduler, trainer. With
``--resume`` and no ``--config`` the config is the checkpoint's own.
``--device`` defaults to ``cuda``; the CPU is used only when asked for.
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


def main(config, device="cuda", resume=None):
    from segtpu_torch import resolve_device
    from segtpu_torch.data import DATASETS
    from segtpu_torch.models import get_model
    from segtpu_torch.ops.conv_wgrad import stem_conv_wgrad
    from segtpu_torch.ops.flatconv import flat_conv_dgrad, flat_conv_wgrad
    from segtpu_torch.trainer import Trainer
    from segtpu_torch.utils.logger import Logger, setup_logging

    device = resolve_device(device)
    logger = setup_logging()
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


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="segtpu_torch training")
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="Path to the config file (default: the resumed "
                             "checkpoint's, else config.json)")
    parser.add_argument("-r", "--resume", default=None, type=str,
                        help="Path to the checkpoint directory to resume from")
    parser.add_argument("-d", "--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (default) or cpu")
    args = parser.parse_args()
    config = None
    if args.resume and args.config is None:
        from segtpu_torch.checkpoint import load_config_from_checkpoint

        config = load_config_from_checkpoint(args.resume)
    if config is None:
        with open(args.config or "config.json") as f:
            config = json.load(f)
    main(config, args.device, args.resume)
