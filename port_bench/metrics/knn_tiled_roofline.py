"""csrc/knn_tiled.cu: least time for a batch's windows against the bank
(counts/kernels.knn at the dense bf16 peak) over the device time of its
two kernels per call on the profiled stretch, %."""

from port_bench.core import readers
from port_bench.counts import kernels


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("mode") != "patch" or trace is None:
        return None
    calls = trace.count(readers.KNN_TILED_CALL)
    if not calls:
        return None
    per_call = [trace.time_s(readers.KNN_TILED) / calls]
    ops_bytes = kernels.knn(readers.windows_per_batch(ctx), ctx["bank_rows"],
                            ctx["config"]["latent_dim"])
    return readers.roofline(per_call, ops_bytes)
