"""95th percentile of submit → verdict over the image requests of the
window outside the profiled stretch, from the clients' side (host-paced in
a closed loop: not a judge)."""


def read(ctx):
    if ctx.get("mode") != "image":
        return None
    return ctx["window"].quiet_p95_ms(ctx["traffic"]["timeout_s"])
