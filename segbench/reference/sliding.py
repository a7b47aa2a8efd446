"""Sliding-window prediction, plain PyTorch: the original repo's
``inference.py`` ``sliding_predict``.

Tiles of ``int(H // 2.5) x int(W // 2.5)``, one stride for rows and columns,
``ceil(tile_h * (1 - 1/3))``; a tile at the right or bottom edge is cut
short and zero-padded to the tile's size at its right and bottom; with
``flip`` its logits are the mean of the tile's and its mirror image's
(mirrored back); each tile's logits, cropped to the part inside the frame,
are summed on a canvas, divided by how many tiles covered each pixel.
"""

from __future__ import annotations

from math import ceil

import torch
import torch.nn.functional as F


def tile_boxes(h: int, w: int, divisor: float = 2.5, overlap: float = 1 / 3):
    """(tile_h, tile_w, [(y0, y1, x0, x1)] in row-major order)."""
    tile_h, tile_w = int(h // divisor), int(w // divisor)
    stride = ceil(tile_h * (1 - overlap))
    rows = int(ceil((h - tile_h) / stride) + 1)
    cols = int(ceil((w - tile_w) / stride) + 1)
    boxes = []
    for r in range(rows):
        for c in range(cols):
            x0, y0 = c * stride, r * stride
            boxes.append((y0, min(y0 + tile_h, h), x0, min(x0 + tile_w, w)))
    return tile_h, tile_w, boxes


@torch.no_grad()
def canvas(model, frame: torch.Tensor, num_classes: int, flip: bool = True,
           chunk: int = 8) -> torch.Tensor:
    """(classes, H, W) float32 logits of ``frame`` (3, H, W), ``model`` in
    eval mode, forwarded ``chunk`` tiles at a time."""
    _, h, w = frame.shape
    tile_h, tile_w, boxes = tile_boxes(h, w)
    total = torch.zeros((num_classes, h, w), device=frame.device)
    count = torch.zeros((h, w), device=frame.device)
    for i in range(0, len(boxes), chunk):
        part = boxes[i:i + chunk]
        tiles = torch.stack([F.pad(frame[:, y0:y1, x0:x1], (0, tile_w - (x1 - x0),
                                                            0, tile_h - (y1 - y0)))
                             for y0, y1, x0, x1 in part])
        logits = model(tiles)["out"].float()
        if flip:
            logits = 0.5 * (logits + model(tiles.flip(-1))["out"].float().flip(-1))
        for (y0, y1, x0, x1), lg in zip(part, logits):
            total[:, y0:y1, x0:x1] += lg[:, :y1 - y0, :x1 - x0]
            count[y0:y1, x0:x1] += 1
    return total / count
