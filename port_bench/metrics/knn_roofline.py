"""csrc/knn.cu: least time for a batch's rows against the bank
(counts/kernels.knn at the dense bf16 peak) over its device time per call
on the profiled stretch, %."""

from port_bench.core import readers
from port_bench.counts import kernels


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("mode") != "image" or trace is None:
        return None
    ops_bytes = kernels.knn(ctx["traffic"]["batch"], ctx["bank_rows"],
                            ctx["config"]["latent_dim"])
    return readers.roofline(trace.durations_s(readers.KNN), ops_bytes)
