"""Inference CLI with segtpu's surface:

    python -m segtpu_torch.inference --model <ckpt-dir> --images <dir> \\
        [--mode multiscale|sliding|simple] [--output outputs] [--extension png] \\
        [--bucket N] [--dtype float32|bfloat16] [--device cuda|cpu]

Counterpart of ``inference.py``. The config is read from the checkpoint's
``meta.json`` (``--config`` is the fallback), and the dataset's mean, std
and palette come from :func:`segtpu_torch.data.dataset_meta`, so a
checkpoint directory and a directory of images are enough. Images are
normalized on the host; each one is saved as a palette PNG of its class map
under ``--output``. PNGs are read without PIL; other formats need PIL.
``--device`` defaults to ``cuda``; the CPU is used only when asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from glob import glob

import numpy as np


def resolve_config(args) -> dict:
    """The config saved in the checkpoint's meta.json, else ``--config``."""
    from segtpu_torch.checkpoint import load_config_from_checkpoint

    config = load_config_from_checkpoint(args.model)
    if config is not None:
        return config
    with open(args.config) as f:
        return json.load(f)


def scales_for(config) -> list:
    if config["train_loader"]["type"] == "CityScapes":
        return [0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.25]
    return [0.75, 1.0, 1.25, 1.5, 1.75, 2.0]


def run(args) -> dict:
    """Segment every ``*.<extension>`` under ``args.images``; returns the
    files written and the seconds each image took, its host-side reading
    and normalization included."""
    import torch

    from segtpu_torch import resolve_device
    from segtpu_torch.checkpoint import load_model_weights
    from segtpu_torch.data import dataset_meta
    from segtpu_torch.inference_lib import (make_predictor, multi_scale_predict,
                                            sliding_predict)
    from segtpu_torch.models import get_model
    from segtpu_torch.ops.reductions import fast_argmax
    from segtpu_torch.utils.helpers import colorize_mask, load_rgb

    device = resolve_device(args.device)
    config = resolve_config(args)
    mean, std, palette, num_classes = dataset_meta(config)
    mean, std = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    model = get_model(config["arch"]["type"], device=device,
                      num_classes=num_classes, **config["arch"].get("args", {}))
    load_model_weights(args.model, model)
    compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    predict = make_predictor(model, bucket=args.bucket,
                             compute_dtype=compute_dtype, device=device)

    os.makedirs(args.output, exist_ok=True)
    written, seconds = [], []
    for img_file in sorted(glob(os.path.join(args.images, f"*.{args.extension}"))):
        t0 = time.perf_counter()
        image = (load_rgb(img_file).astype(np.float32) / 255.0 - mean) / std
        if args.mode == "multiscale":
            prediction = multi_scale_predict(predict, image, scales_for(config),
                                             num_classes, class_map=True)
        elif args.mode == "sliding":
            prediction = sliding_predict(predict, image, num_classes,
                                         class_map=True)
        elif args.mode == "simple":
            x = torch.from_numpy(image).to(device).permute(2, 0, 1)[None]
            prediction = fast_argmax(predict(x)[0], dim=0).cpu().numpy()
        else:
            raise ValueError(f"unknown mode {args.mode!r}: multiscale, sliding "
                             f"or simple")
        name = os.path.basename(img_file).split(".")[0]
        out = os.path.join(args.output, name + ".png")
        colorize_mask(prediction.astype(np.uint8), palette).save(out)
        written.append(out)
        seconds.append(time.perf_counter() - t0)
    return {"written": written, "seconds": seconds}


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="segtpu_torch inference")
    parser.add_argument("-c", "--config", default="config.json", type=str,
                        help="Fallback config for a checkpoint without "
                             "meta.json (the training config is normally read "
                             "from the checkpoint itself)")
    parser.add_argument("-mo", "--mode", default="multiscale", type=str,
                        choices=("multiscale", "sliding", "simple"),
                        help="Prediction mode")
    parser.add_argument("-m", "--model", default="best_model", type=str,
                        help="Path to the checkpoint directory")
    parser.add_argument("-i", "--images", default=None, type=str,
                        help="Path to the images to be segmented")
    parser.add_argument("-o", "--output", default="outputs", type=str,
                        help="Output path")
    parser.add_argument("-e", "--extension", default="jpg", type=str,
                        help="The extension of the images to be segmented")
    parser.add_argument("-b", "--bucket", default=None, type=int,
                        help="Pad inputs to multiples of this and crop back")
    parser.add_argument("-d", "--dtype", default="float32", type=str,
                        choices=("float32", "bfloat16"),
                        help="Activation dtype of the forward (bf16 autocast); "
                             "logits and argmax are float32 either way")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    return run(parse_arguments(argv))


if __name__ == "__main__":
    main()
