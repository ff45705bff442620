"""Share of the profiled stretch with no device operation running, % (image cells)."""

from port_bench.core import readers


def read(ctx):
    return readers.idle_share(ctx, "image")
