"""Multi-scale and sliding-window inference.

Counterpart of ``segtpu/inference_lib.py``, whose parity target is the
original repo's ``inference.py``: ``multi_scale_predict`` (scipy zoom per
scale, bilinear ``align_corners=True`` upsample, optional flip averaging,
mean over scales) and ``sliding_predict`` (tiles of size/2.5, overlap 1/3,
logits accumulated and divided by the count).

A frame is uploaded once. Tiles are cut and zero-padded on the device,
forwarded in fixed-size chunks, flip-averaged and accumulated into the
canvas there; the only download is the canvas, or with ``class_map=True``
the (H, W) class map.

While ``torch.profiler`` records, ``sliding_predict`` runs in the port's
span ``segtpu_torch.sliding`` (``tracing.py``), whose children are
``.upload`` (the frame to the device), ``.tiles`` (cut, pad, stack and
flip), ``.forward`` (each chunk's padding and forward) and ``.canvas``
(from the concat of the chunks' logits to the class map on the device);
the class map's copy to the host is the outer span's own.
"""

from __future__ import annotations

from math import ceil
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from segtpu_torch import resolve_device
from segtpu_torch.core.steps import HALF_DTYPES, autocast
from segtpu_torch.ops.reductions import fast_argmax
from segtpu_torch.ops.resize import resize_bilinear
from segtpu_torch.tracing import span


def make_predictor(model: torch.nn.Module, bucket: Optional[int] = None,
                   compute_dtype: Optional[torch.dtype] = None,
                   device="cuda") -> Callable:
    """Eval-mode forward ``predict(x)``: an NCHW float batch on ``device`` ->
    float32 logits (N, classes, H, W). ``predict.device`` is the device.

    ``bucket`` pads H and W with zeros up to the next multiple before the
    forward and crops the logits back. ``compute_dtype=torch.bfloat16`` or
    ``torch.float16`` runs the forward under autocast to it; ``None`` (or
    float32) keeps it fp32. The logits come back float32 either way.
    """
    device = resolve_device(device)
    if compute_dtype not in (None, torch.float32) + HALF_DTYPES:
        raise ValueError(f"compute_dtype must be None, float32, bfloat16 or float16, "
                         f"not {compute_dtype}")
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    dtype = compute_dtype or torch.float32

    @torch.inference_mode()
    def predict(x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if bucket:
            x = F.pad(x, (0, (-w) % bucket, 0, (-h) % bucket))
        if device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        with autocast(device, dtype):
            out = model(x)["out"]
        return out.float()[..., :h, :w]

    predict.device = device
    return predict


def _result(total: torch.Tensor, class_map: bool) -> torch.Tensor:
    """(C, H, W) canvas -> (H, W, C) float32, or the (H, W) int32 class map,
    on the canvas's device."""
    if class_map:
        return fast_argmax(total, dim=0).to(torch.int32)
    return total.permute(1, 2, 0)


def multi_scale_predict(predict_fn: Callable, image: np.ndarray,
                        scales: Sequence[float], num_classes: int,
                        flip: bool = False, class_map: bool = False) -> np.ndarray:
    """``image`` is (H, W, C) normalized float32; returns the (H, W, classes)
    logits averaged over scales, or the (H, W) int32 class map.

    The zoom stays on the host (scipy's spline semantics are the parity
    target); each scale's logits are upsampled, flip-averaged and added up
    on ``predict_fn.device``.
    """
    device = predict_fn.device
    h, w = image.shape[:2]
    with torch.inference_mode():
        total = torch.zeros((1, num_classes, h, w), device=device)
        for scale in scales:
            scaled = ndimage.zoom(image, (float(scale), float(scale), 1.0),
                                  order=1, prefilter=False)
            x = torch.from_numpy(scaled).to(device).permute(2, 0, 1)[None]
            logits = resize_bilinear(predict_fn(x), (h, w), align_corners=True)
            if flip:
                flipped = resize_bilinear(predict_fn(x.flip(-1)), (h, w),
                                          align_corners=True)
                logits = 0.5 * (logits + flipped.flip(-1))
            total += logits
        return _result(total[0] / len(scales), class_map).cpu().numpy()


def _tile_boxes(h: int, w: int, tile_divisor: float, overlap: float):
    """The original repo's tile geometry (``inference.py:26-40``), a copy of
    segtpu's: (tile_h, tile_w, boxes as (y0, y1, x0, x1))."""
    tile_h, tile_w = int(h // tile_divisor), int(w // tile_divisor)
    stride = ceil(tile_h * (1 - overlap))
    num_rows = int(ceil((h - tile_h) / stride) + 1)
    num_cols = int(ceil((w - tile_w) / stride) + 1)
    boxes = []
    for row in range(num_rows):
        for col in range(num_cols):
            x0, y0 = int(col * stride), int(row * stride)
            x1, y1 = min(x0 + tile_w, w), min(y0 + tile_h, h)
            boxes.append((y0, y1, x0, x1))
    return tile_h, tile_w, tuple(boxes)


def sliding_predict(predict_fn: Callable, image: np.ndarray, num_classes: int,
                    flip: bool = True, tile_divisor: float = 2.5,
                    overlap: float = 1 / 3, max_tile_batch: Optional[int] = 16,
                    class_map: bool = False) -> np.ndarray:
    """Overlapped tiles, their logits summed on a canvas and divided by the
    count (the original repo's ``inference.py:26-58``). ``image`` is (H, W, C)
    normalized float32; returns the (H, W, classes) canvas or the (H, W)
    int32 class map.

    Tiles (and with ``flip`` their mirror images) go through ``predict_fn``
    in chunks of ``max_tile_batch``, the last one padded with zeros to the
    same batch (eval-mode BN is independent of the batch, so chunking is
    exact); ``None`` forwards all tiles at once.
    """
    device = predict_fn.device
    h, w = image.shape[:2]
    tile_h, tile_w, boxes = _tile_boxes(h, w, tile_divisor, overlap)
    with torch.inference_mode(), span("segtpu_torch.sliding"):
        with span("segtpu_torch.sliding.upload"):
            frame = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(device)
        with span("segtpu_torch.sliding.tiles"):
            frame = frame.permute(2, 0, 1)
            batch = torch.stack([
                F.pad(frame[:, y0:y1, x0:x1], (0, tile_w - (x1 - x0), 0, tile_h - (y1 - y0)))
                for y0, y1, x0, x1 in boxes])
            if flip:
                batch = torch.cat([batch, batch.flip(-1)])
        with span("segtpu_torch.sliding.forward"):
            chunk_size = max_tile_batch or len(batch)
            outs = []
            for i in range(0, len(batch), chunk_size):
                chunk = batch[i:i + chunk_size]
                real = len(chunk)
                if real < chunk_size:
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (chunk_size - real,) + chunk.shape[1:])])
                outs.append(predict_fn(chunk)[:real])
        with span("segtpu_torch.sliding.canvas"):
            logits = torch.cat(outs)
            if flip:
                t = len(boxes)
                logits = 0.5 * (logits[:t] + logits[t:].flip(-1))
            total = torch.zeros((num_classes, h, w), device=device)
            count = torch.zeros((1, h, w), device=device)
            for (y0, y1, x0, x1), lg in zip(boxes, logits):
                total[:, y0:y1, x0:x1] += lg[:, :y1 - y0, :x1 - x0]
                count[:, y0:y1, x0:x1] += 1.0
            result = _result(total / count, class_map)
        return result.cpu().numpy()
