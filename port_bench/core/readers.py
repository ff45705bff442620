"""What the per-layer readers (``port_bench/metrics/<metric>.py``) share.

Each reader is ``read(ctx) -> float | None``; ``ctx`` is the driver's
context with the run's ``trace`` (a ``core.trace.Trace``, or None).  A
reader that finds nothing to read returns None, and the metric is left
out of the line: a share of a roofline or a peak is never read as 0.

Kernel names on the device trace: ``stem_pool_kernel`` (csrc/stem_pool.cu),
``knn_tiled_partial_kernel`` + ``knn_tiled_merge_kernel``
(csrc/knn_tiled.cu, one of each per call), ``knn_cluster_kernel``
(csrc/knn.cu)."""

from __future__ import annotations

from typing import Optional

from port_bench.counts import PEAKS, kernels, model

STEM = "stem_pool_kernel"
KNN_TILED = "knn_tiled_"
KNN_TILED_CALL = "knn_tiled_partial_kernel"
KNN = "knn_cluster_kernel"
COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def _mode(ctx, mode: str) -> bool:
    return ctx.get("mode") == mode


def batcher_gap_ms(ctx, mode: str) -> Optional[float]:
    """Mean host time from the end of one scorer call to the start of the
    next over the window, outside the profiled stretch: what the batcher
    spends per batch outside the scorer (fan out, collect, stack)."""
    if not _mode(ctx, mode):
        return None
    w = ctx["window"]
    quiet = set(w.quiet_calls())
    gaps = [b[0] - a[1] for a, b in zip(w.calls, w.calls[1:]) if a in quiet and b in quiet]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None


def scorer_ms(ctx, mode: str) -> Optional[float]:
    """Mean host time of one scorer call, its device sync included, outside
    the profiled stretch."""
    calls = ctx["window"].quiet_calls() if _mode(ctx, mode) else []
    if not calls:
        return None
    return sum(t1 - t0 for t0, t1 in calls) / len(calls) * 1e3


def windows_per_batch(ctx) -> int:
    tr = ctx["traffic"]
    side = (tr["imsize"] - tr["patch_dim"]) // tr["stride"] + 1
    return tr["batch"] * side * side


def batches_in_trace(ctx) -> int:
    trace = ctx.get("trace")
    if trace is None:
        return 0
    return trace.count(KNN_TILED_CALL if ctx["mode"] == "patch" else KNN)


def model_device_ms(ctx, mode: str) -> Optional[float]:
    """Device time per batch outside the named kernels and the copies: the
    model, the windows, the maps, the queries' split."""
    n = batches_in_trace(ctx) if _mode(ctx, mode) else 0
    if not n:
        return None
    named = (STEM, KNN_TILED, KNN) + COPIES
    rest = sum(e - s for name, s, e in ctx["trace"].device
               if not any(tag in name for tag in named))
    return rest / 1e3 / n


def idle_share(ctx, mode: str) -> Optional[float]:
    """Share of the profiled stretch in which no device operation ran, %."""
    trace = ctx.get("trace")
    if not _mode(ctx, mode) or trace is None or not trace.device or not trace.wall_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.wall_s)


def mfu(ctx, mode: str) -> Optional[float]:
    """The algorithm's FLOPs for the outputs returned in the window outside
    the profiled stretch, over that time, against the dense bf16 peak, %."""
    if not _mode(ctx, mode):
        return None
    cfg, tr = ctx["config"], ctx["traffic"]
    if mode == "patch":
        per = model.patch_map_flops(cfg, tr["imsize"], tr["patch_dim"], tr["stride"],
                                    ctx["bank_rows"])
    else:
        per = model.image_verdict_flops(cfg, tr["imsize"], ctx["bank_rows"])
    return 100.0 * ctx["window"].quiet_rate() * per / PEAKS["bf16_flop_per_s"]


def roofline(durations, ops_bytes) -> Optional[float]:
    """Least time over the measured device time per call, %."""
    if not durations:
        return None
    bound, _ = kernels.bound_s(*ops_bytes)
    return 100.0 * bound / (sum(durations) / len(durations))
