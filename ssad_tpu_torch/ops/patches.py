"""Sliding-window patch extraction.

Counterpart of ssad_tpu/ops/patches.py:20-94.  Patches come out in
row-major window order (rows of windows first), the order of the
reference's ``Tensor.unfold`` (functional.py:77-82), so a per-patch score
vector reshapes straight to a (side, side) anomaly map.
"""

from __future__ import annotations

from typing import Tuple

import torch


def grid_side(image_size: int, dim: int, stride: int) -> int:
    """Number of window positions along one axis."""
    return (image_size - dim) // stride + 1


def patch_grid_shape(h: int, w: int, dim: int, stride: int) -> Tuple[int, int]:
    return grid_side(h, dim, stride), grid_side(w, dim, stride)


def extract_patches(x: torch.Tensor, dim: int = 32, stride: int = 4) -> torch.Tensor:
    """(B, H, W, C) → (B, P, dim, dim, C) sliding windows, row-major
    position order; P = grid_side(H)·grid_side(W) (841 for 256 px images,
    32 px windows, stride 8)."""
    b, _, _, c = x.shape
    # unfold(1) → (B, oh, W, C, dim); unfold(2) → (B, oh, ow, C, dim, dim)
    p = x.unfold(1, dim, stride).unfold(2, dim, stride)
    oh, ow = p.shape[1], p.shape[2]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(b, oh * ow, dim, dim, c)
