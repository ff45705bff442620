"""Host ms per batch in ``ssad.vit.blocks`` (the transformer trunk's blocks
enqueued), mean over the profiled stretch (image cells)."""

from port_bench.core import spans


def read(ctx):
    return spans.span_ms(ctx, "image", "ssad.vit.blocks")
