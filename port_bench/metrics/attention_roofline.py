"""The transformer trunk's attention (FlashAttention-2 pinned through
``F.scaled_dot_product_attention``, models/vit.py): least time for one
block's attention over a batch (counts/vit.attention, bound by its
operations at the dense bf16 peak) over the kernel's mean device time per
call on the profiled stretch, %."""

from port_bench.core import readers
from port_bench.counts import vit
from port_bench.reference.vit import ARCHS

#: the pinned backend's forward kernel, by a part of its name
KERNEL = "flash_fwd"


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("mode") != "image" or trace is None or ctx["config"]["backbone"] not in ARCHS:
        return None
    tr = ctx["traffic"]
    return readers.roofline(trace.durations_s(KERNEL),
                            vit.attention(tr["batch"], ctx["config"]["backbone"], tr["imsize"],
                                          tr["imsize"]))
