"""Host ms per batch in ``ssad.batcher.fanout`` (rows back to the requests,
their events set, the counters), mean over the profiled stretch (image
cells)."""

from port_bench.core import spans


def read(ctx):
    return spans.span_ms(ctx, "image", "ssad.batcher.fanout")
