"""Device resolution shared by every entry point of the port, and the
switch that keeps f32 matmuls IEEE f32 on the card.

The port runs on the CUDA device by default.  The CPU is reached only by
asking for it; a missing card never degrades silently to the CPU, because
a user who meant to serve on the GPU would otherwise get CPU latency with
no sign of why.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


@contextlib.contextmanager
def tf32_off():
    """Run f32 matmuls without TF32 inside the block (the k-NN scores and
    the anomaly maps are 1 − cos with cos close to 1; the stem's plain
    version must sum exact bf16 products in f32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class DeviceUnavailable(RuntimeError):
    """The requested (or default) CUDA device is not available."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None → ``cuda`` (raising when there is no card); an explicit device
    is returned as a ``torch.device`` after the same check for CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass device='cpu' (CLI: --device "
            "cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda | cpu)")
    return dev
