"""``seg_stats_ms.train``: device milliseconds a traced step spends inside the
port's span ``segtpu_torch.step.seg_stats``: the prediction argmax and the
three ``bincount`` calls, which wait for the device. The span's interval
between its timing events on the stream, idle time within it included,
averaged over the first traced slice (``program_spans.py``)."""

from segbench import program_spans

UNIT = "ms"
SPANS = ["segtpu_torch.step.seg_stats"]


def read(ctx):
    return program_spans.mean_ms(ctx, "train_step", SPANS, "seg_stats_ms.train")
