"""``bn_elementwise_ms.train``: device milliseconds a traced training step
spends in batch-norm and elementwise kernels (the trace's categories
"batch norm" and "elementwise and copies", by kernel name)."""

from segbench.trace import category

UNIT = "ms"
CATEGORIES = ("batch norm", "elementwise and copies")


def read(ctx):
    if ctx.cell.traffic["kind"] != "train_step":
        return None
    s = ctx.trace.kernel_s(lambda op: category(op.name) in CATEGORIES)
    return 1e3 * s / ctx.trace.units if s > 0 else None
