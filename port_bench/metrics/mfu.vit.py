"""The algorithm's FLOPs (counts/vit.verdict_flops) for the image verdicts
of a transformer trunk returned in the window outside the profiled
stretch, over that time, against 989 TFLOP/s dense bf16, %."""

from port_bench.counts import PEAKS
from port_bench.counts import vit
from port_bench.reference.vit import ARCHS


def read(ctx):
    if ctx.get("mode") != "image" or ctx["config"]["backbone"] not in ARCHS:
        return None
    tr = ctx["traffic"]
    per = vit.verdict_flops(ctx["config"], tr["imsize"], tr["imsize"], ctx["bank_rows"])
    return 100.0 * ctx["window"].quiet_rate() * per / PEAKS["bf16_flop_per_s"]
