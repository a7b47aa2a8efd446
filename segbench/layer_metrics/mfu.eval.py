"""``mfu.eval``: the evaluation window's model FLOP utilisation, in percent.

A frame's FLOPs are its tile forwards' (the reference model's forward at one
tile, ``counts.model_flops``, times the tiles of the sliding geometry, twice
with flips), times the frames of the window over its seconds on the host's
clock, over the card's dense bf16 peak (989 TFLOP/s).
"""

from segbench import counts
from segbench.reference.sliding import tile_boxes

UNIT = "%"


def read(ctx):
    t = ctx.cell.traffic
    if t["kind"] != "sliding_eval" or not ctx.units:
        return None
    tile_h, tile_w, boxes = tile_boxes(*t["frame"], t["tile_divisor"], t["overlap"])
    tiles = len(boxes) * (2 if t["flip"] else 1)
    flops = tiles * counts.model_flops(ctx.cell.config, 1, tile_h, tile_w, train=False)
    return 100.0 * flops * ctx.units / ctx.seconds / counts.BF16_FLOPS
