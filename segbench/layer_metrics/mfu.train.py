"""``mfu.train``: the training window's model FLOP utilisation, in percent.

The reference model's FLOPs of one step at the cell's batch and crop
(``counts.model_flops``: forward and backward, nothing recomputed), times
the steps of the window over its seconds on the host's clock, over the
card's dense bf16 peak (989 TFLOP/s).
"""

from segbench import counts

UNIT = "%"


def read(ctx):
    t = ctx.cell.traffic
    if t["kind"] != "train_step" or not ctx.units:
        return None
    flops = counts.model_flops(ctx.cell.config, t["batch"], t["crop"], t["crop"], train=True)
    return 100.0 * flops * ctx.units / ctx.seconds / counts.BF16_FLOPS
