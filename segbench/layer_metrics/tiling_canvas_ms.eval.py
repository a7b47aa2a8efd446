"""``tiling_canvas_ms.eval``: device milliseconds a traced frame spends in
kernels launched outside the model's forward (the span
``segbench.forward`` around the predictor): the tiles' cut, pad and flip,
the flip average, the canvas's sums and division, and the argmax. Host-
device copies are not kernels and are left out."""

UNIT = "ms"
FORWARD = "segbench.forward"


def read(ctx):
    if ctx.cell.traffic["kind"] != "sliding_eval":
        return None
    if not any(op.span == FORWARD for op in ctx.trace.ops):
        return None
    return 1e3 * ctx.trace.kernel_s(lambda op: op.span != FORWARD) / ctx.trace.units
