"""csrc/stem_pool.cu: least time for its windows (counts/kernels.stem) over
its device time per call on the profiled stretch, %."""

from port_bench.core import readers
from port_bench.counts import kernels


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("mode") != "patch" or trace is None:
        return None
    return readers.roofline(trace.durations_s(readers.STEM),
                            kernels.stem(readers.windows_per_batch(ctx)))
