"""Profiling and runtime introspection.

Counterpart of ssad_tpu/utils/profiling.py:

* ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (CPU and, with a card, CUDA activities) that writes a
  ``*.pt.trace.json`` into ``logdir`` when the block ends, readable by
  TensorBoard's PyTorch profiler plugin and by Perfetto;
* ``StepTimer``: wall-clock per-step stats, synchronising on the result's
  device (``block_until_ready``), reporting mean/p50/p95 and throughput;
* ``device_memory_stats()``: live per-card memory from
  ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with profiling.trace('/tmp/tb'): step()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ):
        yield


def block_until_ready(x):
    """Wait for the cards that hold the tensors of ``x`` (a tensor, or a
    dict / list / tuple of them; tensors on the CPU are ready) → ``x``."""
    if torch.is_tensor(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            block_until_ready(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            block_until_ready(v)
    return x


class StepTimer:
    """Accumulates per-step wall times (with an optional sync object)."""

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, sync=None):
        if sync is not None:
            block_until_ready(sync)
        if self._t0 is None:
            raise RuntimeError("start() before stop()")
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        box = {}
        yield box
        self.stop(box.get("sync"))

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times[1:] or self.times)  # the first step is dropped
        return {
            "steps": len(self.times),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "items_per_sec": float(self.items_per_step / t.mean()),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory in MiB of the caching allocator, for each card this
    process has used; empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[str(torch.device("cuda", i))] = {
                "bytes_in_use_mib": stats.get("allocated_bytes.all.current", 0) / 2**20,
                "peak_bytes_in_use_mib": stats.get("allocated_bytes.all.peak", 0) / 2**20,
            }
    return out
