"""Image primitives on channels-last float tensors in [0, 1].

Counterparts of ssad_tpu/ops/image.py:29-65.  The public layout stays the
JAX package's (H, W, C) / (B, H, W, C); the model converts to NCHW inside.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ssad_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the trailing channel axis (reference
    datasets.py:430-433)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def resize_nearest(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the two leading spatial axes of an (H, W, ...)
    tensor, with jax.image.resize's source index floor((i + ½)·in/out)
    (the index math runs in float32, as jax's does).  Integer upscale
    factors are a plain repeat, which that rule reduces to."""
    h, w = size
    ih, iw = img.shape[0], img.shape[1]
    if h % ih == 0 and w % iw == 0 and (h > ih or w > iw):
        out = img.repeat_interleave(h // ih, dim=0)
        return out.repeat_interleave(w // iw, dim=1)
    for axis, (n_in, n_out) in enumerate(((ih, h), (iw, w))):
        if n_in == n_out:
            continue
        offsets = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        idx = torch.floor(offsets).to(torch.int64).clamp_(max=n_in - 1)
        img = img.index_select(axis, idx.to(img.device))
    return img
