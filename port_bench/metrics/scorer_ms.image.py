"""Host ms of one ServedScorer call, its sync included, mean over the window (image cells)."""

from port_bench.core import readers


def read(ctx):
    return readers.scorer_ms(ctx, "image")
