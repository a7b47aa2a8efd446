"""``forward_ms.eval``: device milliseconds a traced frame spends inside the
port's span ``segtpu_torch.sliding.forward``: the tile forwards: each
chunk's padding and the predictor. The span's interval between its timing
events on the stream, idle time within it included, averaged over the first
traced slice (``program_spans.py``)."""

from segbench import program_spans

UNIT = "ms"
SPANS = ["segtpu_torch.sliding.forward"]


def read(ctx):
    return program_spans.mean_ms(ctx, "sliding_eval", SPANS, "forward_ms.eval")
