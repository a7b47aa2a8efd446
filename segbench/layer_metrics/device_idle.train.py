"""``device_idle.train``: the share of a traced slice of training steps in
which no operation ran on the device, in percent: one less the union of the
device operations' intervals over the slice's seconds (the slice that
traces the device alone, ``trace.py``)."""

UNIT = "%"


def read(ctx):
    if ctx.cell.traffic["kind"] != "train_step":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
