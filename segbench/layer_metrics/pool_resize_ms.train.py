"""``pool_resize_ms.train``: device milliseconds a traced training step
spends in adaptive-average-pool and bilinear-resize kernels, forward and
backward (the trace's categories by kernel name)."""

from segbench.trace import category

UNIT = "ms"
CATEGORIES = ("adaptive average pool (PSP pyramid)", "bilinear resize")


def read(ctx):
    if ctx.cell.traffic["kind"] != "train_step":
        return None
    s = ctx.trace.kernel_s(lambda op: category(op.name) in CATEGORIES)
    return 1e3 * s / ctx.trace.units if s > 0 else None
