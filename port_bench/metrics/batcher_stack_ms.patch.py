"""Host ms per batch in ``ssad.batcher.stack`` (np.stack of the rows and the
pad to the batch), mean over the profiled stretch (patch cells)."""

from port_bench.core import spans


def read(ctx):
    return spans.span_ms(ctx, "patch", "ssad.batcher.stack")
