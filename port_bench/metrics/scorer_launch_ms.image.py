"""Host ms per batch in ``ssad.scorer.launch`` (score_tensor: the host
enqueuing the path), mean over the profiled stretch (image cells)."""

from port_bench.core import spans


def read(ctx):
    return spans.span_ms(ctx, "image", "ssad.scorer.launch")
