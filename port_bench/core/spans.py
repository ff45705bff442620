"""The per-layer readers of the port's own spans (``ssad_tpu_torch``'s
``utils/profiling.span``), from the profiled stretch's host ops.

A span is a host op of the thread that started the profiler (the
batcher's), on the profiler's clock.  Only spans that start inside the
stretch are recorded; each of the batcher's ``collect``, ``stack`` and
``fanout`` and the scorer's ``upload``, ``launch`` and ``readback`` runs
once a batch, so the mean of its recorded durations is its ms per batch.
A span still open when the profiler stops (the last batch's
``ssad.batcher.run``, inside which the harness stops it) is cut there:
no reader here reads one.  A program without the span, or a run
without a trace, reads None."""

from __future__ import annotations

from typing import Optional


def span_ms(ctx, mode: str, name: str) -> Optional[float]:
    """Mean duration of the host op ``name`` in the profiled stretch, ms."""
    trace = ctx.get("trace")
    if ctx.get("mode") != mode or trace is None:
        return None
    durations = [e - s for n, s, e in trace.host if n == name]
    return sum(durations) / len(durations) / 1e3 if durations else None
