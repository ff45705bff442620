"""Host ms per batch in ``ssad.scorer.upload`` (the numpy chunk to a device
tensor), mean over the profiled stretch (patch cells)."""

from port_bench.core import spans


def read(ctx):
    return spans.span_ms(ctx, "patch", "ssad.scorer.upload")
