"""``optimizer_ms.train``: device milliseconds a traced step spends inside the
port's span ``segtpu_torch.step.optimizer``: the optimizer's update,
``TrainState.apply_gradients`` (the schedules' learning rates and the
foreach SGD). The span's interval between its timing events on the stream,
idle time within it included, averaged over the first traced slice
(``program_spans.py``)."""

from segbench import program_spans

UNIT = "ms"
SPANS = ["segtpu_torch.step.optimizer"]


def read(ctx):
    return program_spans.mean_ms(ctx, "train_step", SPANS, "optimizer_ms.train")
