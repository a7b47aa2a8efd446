"""``forward_ms.train``: device milliseconds a traced step spends inside the
port's span ``segtpu_torch.step.forward``: the model's forward and the loss
(with the aux head's) under autocast. The span's interval between its timing
events on the stream, idle time within it included, averaged over the first
traced slice (``program_spans.py``)."""

from segbench import program_spans

UNIT = "ms"
SPANS = ["segtpu_torch.step.forward"]


def read(ctx):
    return program_spans.mean_ms(ctx, "train_step", SPANS, "forward_ms.train")
