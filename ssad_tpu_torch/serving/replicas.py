"""Multi-device serving: one replica of an artifact per device.

Counterpart of ssad_tpu/serving/replicas.py:37-86.  Scoring is
independent per image, so N devices serve N independent copies of the
same scorer, each running its own batches: a request's latency stays the
one-device number and throughput grows with the devices, with no traffic
between them.  ``BatchingScorer`` (serving/server.py) takes the replica
list: one collector assembles batches and one runner thread per replica
runs them.

The JAX replica shares one deserialized program and commits each batch
to its device.  PyTorch runs eagerly, so here each replica is its own
``ServedScorer``, rebuilt on its device from the artifact's tensors,
which are read from the file once: no weight is shared across devices.
A replica runs every call under ``torch.cuda.device(its device)``,
because the CUDA kernels are launched through ctypes on the calling
thread's current device (ops/knn.py, ops/stem_pool.py): without it a
replica on ``cuda:1`` would launch with ``cuda:0``'s context.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ssad_tpu_torch.serving.export import ServedScorer, read_artifact
from ssad_tpu_torch.utils.device import resolve_device


def pick_devices(n: Optional[int], kind: Union[str, torch.device] = "cuda") -> List[torch.device]:
    """The first ``n`` devices of ``kind``; ``n`` of 0 or None means all.

    ``cuda``: the first ``n`` of ``torch.cuda.device_count()`` cards,
    asking for more raises ``ValueError`` with the cards listed.
    ``cpu``: ``n`` entries of the CPU device (0 or None: one), so that
    several replicas can run on a host without a card.
    """
    kind = resolve_device(kind).type
    if n is not None and n < 0:
        raise ValueError(f"asked for {n} devices")
    if kind == "cpu":
        return [torch.device("cpu")] * (n or 1)
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n in (0, None):
        return devs
    if n > len(devs):
        names = [f"{d} ({torch.cuda.get_device_name(d)})" for d in devs]
        raise ValueError(f"asked for {n} devices but {len(devs)} are attached ({names})")
    return devs[:n]


def device_context(device: torch.device):
    """``torch.cuda.device(device)`` for a card (it becomes the calling
    thread's current device), nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class DeviceReplica:
    """One device's ``ServedScorer``, called under that device's context.

    Callable on a full (batch, H, W, 3) float32 array, the fixed-batch
    contract ``BatchingScorer`` feeds, returning host numpy arrays.
    """

    def __init__(self, scorer: ServedScorer):
        self.scorer = scorer
        self.device = scorer.device
        self.meta = scorer.meta
        self.batch = scorer.batch

    def __call__(self, x: np.ndarray) -> tuple:
        with device_context(self.device):
            return self.scorer(x)

    def warmup(self, max_calls: int = 16, settled_s: float = 0.25) -> float:
        """Warm this device's scorer (kernel builds, cuDNN's algorithm
        selection, the tiled bank's split); call it on the thread that
        will run the replica."""
        with device_context(self.device):
            return self.scorer.warmup(max_calls=max_calls, settled_s=settled_s)

    def __repr__(self) -> str:  # shows up in serve logs
        return f"DeviceReplica({self.device}, batch={self.batch})"


def device_replicas(path: Union[str, Path], devices: Sequence[torch.device]) -> List[DeviceReplica]:
    """One ``DeviceReplica`` of the artifact at ``path`` per device: the
    file is read once, and each scorer is built on its own device."""
    meta, payload = read_artifact(path)
    state_dict = payload.pop("state_dict")
    replicas = []
    for dev in devices:
        with device_context(dev):
            replicas.append(DeviceReplica(ServedScorer(meta, state_dict, dev, **payload)))
    return replicas
