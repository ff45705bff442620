"""Label / tensor conversion helpers.

Counterpart of ssad_tpu/utils/convert.py:13-60 (the reference's
src/self_supervised/converters.py), as torch ops on the input's device;
``image_to_uint8`` and ``normalize_in_interval`` are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def gt2label(gt_masks, negative: int = 0, positive: int = 1) -> torch.Tensor:
    """Per-image label from ground-truth masks (converters.py:7-9):
    ``positive`` where any pixel is non-zero.  (B, H, W) or (B, H, W, C)."""
    g = torch.as_tensor(gt_masks)
    any_defect = g.reshape(g.shape[0], -1).sum(dim=1) > 0
    return torch.where(any_defect, positive, negative).to(torch.int32)


def multiclass2binary(labels) -> torch.Tensor:
    """Pretext labels {0..3} → binary anomaly labels (converters.py:11-12)."""
    return (torch.as_tensor(labels) > 0).to(torch.int32)


def image_to_uint8(img) -> np.ndarray:
    """Float image in [0,1] (H,W,C) → uint8 array (converters.py:27-30)."""
    arr = np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def heatmap2mask(heatmap, threshold: float = 0.7) -> torch.Tensor:
    """Threshold a [0,1] heatmap into a binary mask (converters.py:33)."""
    return torch.as_tensor(heatmap) > threshold


def prediction_class(logits) -> torch.Tensor:
    """Argmax class ids from logits (functional.py:27-29)."""
    return torch.argmax(torch.as_tensor(logits), dim=-1)


def minmax_normalize(x, eps: float = 0.0) -> torch.Tensor:
    """Min-max normalize to [0,1] (functional.py:85-88)."""
    x = torch.as_tensor(x)
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + eps) if eps else (x - lo) / (hi - lo)


def normalize_in_interval(x, lo: float, hi: float) -> np.ndarray:
    """Min-max rescale into [lo, hi], rounded to integers
    (functional.py:91-94)."""
    x = np.asarray(x, np.float64)
    span = x.max() - x.min()
    out = (x - x.min()) / (span if span else 1.0) * (hi - lo) + lo
    return np.rint(out)
