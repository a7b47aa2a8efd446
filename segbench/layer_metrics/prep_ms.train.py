"""``prep_ms.train``: device milliseconds a traced step spends inside the
port's span ``segtpu_torch.step.prep``: the uint8 batch's normalisation,
``prep_images``: its permute, the two host-to-device copies of the mean and
std, the division and the cast. The span's interval between its timing
events on the stream, idle time within it included, averaged over the first
traced slice (``program_spans.py``)."""

from segbench import program_spans

UNIT = "ms"
SPANS = ["segtpu_torch.step.prep"]


def read(ctx):
    return program_spans.mean_ms(ctx, "train_step", SPANS, "prep_ms.train")
