"""The algorithm's FLOPs for the image answers returned in the window, over
the window, against 989 TFLOP/s dense bf16, %."""

from port_bench.core import readers


def read(ctx):
    return readers.mfu(ctx, "image")
