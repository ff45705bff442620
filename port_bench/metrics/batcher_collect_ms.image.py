"""Host ms per batch in ``ssad.batcher.collect`` (from asking the queue for
a batch's first request to the batch closing), mean over the profiled
stretch (image cells)."""

from port_bench.core import spans


def read(ctx):
    return spans.span_ms(ctx, "image", "ssad.batcher.collect")
