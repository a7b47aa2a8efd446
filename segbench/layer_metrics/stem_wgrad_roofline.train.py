"""``stem_wgrad_roofline.train``: the stem weight-gradient kernel's share of
its roofline, in percent.

The bound is the kernel's bytes (``counts.stem_wgrad_bytes``: x and dy read
once in bf16, dW written once) over the card's HBM rate, at the cell's batch
and crop and the configuration's ``stem`` (kernel size, output channels);
the time is the device time of the kernels named ``stem_wgrad`` in the
traced slice per launch. The launches are the port's counter
``stem_conv_wgrad.launches`` over the slice, and must equal the traced
``stem_wgrad_tc`` kernels; a slice without launches gives nothing.
"""

import sys

from segbench import counts

UNIT = "%"


def read(ctx):
    t, stem = ctx.cell.traffic, ctx.cell.config.get("stem")
    launches = ctx.trace.counters.get("stem_conv_wgrad.launches", 0)
    if t["kind"] != "train_step" or stem is None or not launches:
        return None
    traced = sum(1 for op in ctx.trace.ops if "stem_wgrad_tc" in op.name)
    if traced != launches:
        print(f"stem_wgrad_roofline.train: {launches} launches counted, {traced} traced",
              file=sys.stderr)
        return None
    seconds = ctx.trace.kernel_s(lambda op: "stem_wgrad" in op.name) / launches
    nbytes = counts.stem_wgrad_bytes(t["batch"], t["crop"], t["crop"], 3,
                                     stem["out_channels"], stem["kernel"])
    return 100.0 * counts.bound_s(nbytes) / seconds
