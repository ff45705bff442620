"""Device ms per patch batch outside the named kernels and the copies, on
the profiled stretch."""

from port_bench.core import readers


def read(ctx):
    return readers.model_device_ms(ctx, "patch")
