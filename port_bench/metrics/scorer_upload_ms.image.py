"""Host ms per batch in ``ssad.scorer.upload`` (the numpy chunk to a device
tensor), mean over the profiled stretch (image cells)."""

from port_bench.core import spans


def read(ctx):
    return spans.span_ms(ctx, "image", "ssad.scorer.upload")
