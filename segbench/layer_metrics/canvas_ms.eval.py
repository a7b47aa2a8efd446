"""``canvas_ms.eval``: device milliseconds a traced frame spends inside the
port's spans ``segtpu_torch.sliding.tiles`` and
``segtpu_torch.sliding.canvas``: the tiles' cut, pad, stack and flip and the
canvas: the concat of the chunks' logits, the flip average, the canvas and
count sums, the division, the argmax and its int32 cast; the inside twin of
``tiling_canvas_ms.eval``, with the device's waits inside those spans. The
span's interval between its timing events on the stream, idle time within it
included, averaged over the first traced slice (``program_spans.py``)."""

from segbench import program_spans

UNIT = "ms"
SPANS = ["segtpu_torch.sliding.tiles", "segtpu_torch.sliding.canvas"]


def read(ctx):
    return program_spans.mean_ms(ctx, "sliding_eval", SPANS, "canvas_ms.eval")
