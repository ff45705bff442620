"""Host ms per batch outside the scorer: from one scorer call's end to the
next one's start, mean over the window's patch batches."""

from port_bench.core import readers


def read(ctx):
    return readers.batcher_gap_ms(ctx, "patch")
