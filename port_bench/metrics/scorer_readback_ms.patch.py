"""Host ms per batch in ``ssad.scorer.readback`` (waiting for the device and
the copy back), mean over the profiled stretch (patch cells)."""

from port_bench.core import spans


def read(ctx):
    return spans.span_ms(ctx, "patch", "ssad.scorer.readback")
