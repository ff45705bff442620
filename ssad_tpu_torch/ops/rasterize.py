"""Fixed-shape rasterisers of the defect synthesizer.

Counterpart of ssad_tpu/ops/rasterize.py: the reference draws its
defects with PIL (ImageDraw.polygon, dataset_generator.py:99; the rotated
scar's alpha, datasets.py:344-355; ImageDraw.line, datasets.py:383-388).
Each shape is a per-pixel test over a static (H, W) canvas in f32, so a
batch of shapes is one broadcast.  Coordinates are (x, y) floats; every
function takes one shape or a batch (leading axes) and returns float
{0, 1} masks.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ssad_tpu_torch.utils.device import tf32_off


def _pixel_grid(shape: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    h, w = shape
    py = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    px = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return px, py


def polygon_mask(vertices: torch.Tensor, num_vertices: torch.Tensor,
                 shape: Tuple[int, int]) -> torch.Tensor:
    """Even-odd fill of a simple polygon with up to MAX vertices.

    vertices: (..., MAX, 2) f32; entries at index ≥ num_vertices (...,)
    repeat the last valid vertex, so their edges are degenerate.  A
    per-pixel crossing-number test in f32, as PIL's polygon fill (reference
    dataset_generator.py:99-100).  Returns (..., H, W)."""
    max_v = vertices.shape[-2]
    n = num_vertices
    idx = torch.arange(max_v, device=vertices.device)
    last_i = (n - 1).clamp(min=0)[..., None, None].expand(*vertices.shape[:-2], 1, 2)
    last = torch.gather(vertices, -2, last_i)
    verts = torch.where((idx < n[..., None])[..., None], vertices, last)

    px, py = _pixel_grid(shape, vertices.device)
    nxt = torch.roll(verts, -1, dims=-2)
    x1, y1 = verts[..., 0, None, None], verts[..., 1, None, None]
    x2, y2 = nxt[..., 0, None, None], nxt[..., 1, None, None]
    cond = (y1 > py) != (y2 > py)
    denom = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    xint = x1 + (py - y1) * (x2 - x1) / denom
    crossings = torch.sum(cond & (px < xint), dim=-3)
    return (crossings % 2).float()


def polyline_mask(points: torch.Tensor, num_points, width: float,
                  shape: Tuple[int, int]) -> torch.Tensor:
    """Thick polyline: pixels within width/2 of an active segment.

    points: (..., MAX, 2) f32; segment i → i+1 is active for
    i < num_points - 1 (num_points: an int or (...,)).  Stands for PIL's
    ImageDraw.line of width 1 or 3 (reference datasets.py:383-388).
    Returns (..., H, W)."""
    px, py = _pixel_grid(shape, points.device)
    half = width / 2.0
    a, b = points[..., :-1, :], points[..., 1:, :]
    ax, ay = a[..., 0, None, None], a[..., 1, None, None]
    abx = (b[..., 0] - a[..., 0])[..., None, None]
    aby = (b[..., 1] - a[..., 1])[..., None, None]
    denom = torch.clamp(abx * abx + aby * aby, min=1e-12)
    t = torch.clamp(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
    dx = px - (ax + t * abx)
    dy = py - (ay + t * aby)
    d2 = dx * dx + dy * dy
    n = num_points[..., None] if isinstance(num_points, torch.Tensor) else num_points
    active = torch.arange(points.shape[-2] - 1, device=points.device) < (n - 1)
    hit = torch.any(active[..., None, None] & (d2 <= half * half), dim=-3)
    return hit.float()


def rotated_rect_mask(center: torch.Tensor, rect_w, rect_h, angle_deg,
                      shape: Tuple[int, int]) -> torch.Tensor:
    """Mask of a w×h rectangle rotated by ``angle_deg`` about ``center``
    (x, y): the alpha of PIL's Image.rotate(angle, expand=True) of an
    opaque rectangle (reference datasets.py:344, :355).  One rectangle.
    No path calls it: the synthesizer rotates the scar's tile with its
    shears, as the JAX package does; kept as the counterpart of the JAX
    module's function, held to it by tests/test_torch_augment.py."""
    px, py = _pixel_grid(shape, center.device)
    theta = torch.as_tensor(angle_deg, dtype=torch.float32) * (np.pi / 180.0)
    c, s = torch.cos(theta), torch.sin(theta)
    dx = px - center[0]
    dy = py - center[1]
    u = c * dx - s * dy
    v = s * dx + c * dy
    return ((torch.abs(u) <= rect_w / 2.0) & (torch.abs(v) <= rect_h / 2.0)).float()


@functools.lru_cache(maxsize=None)
def savgol_matrix(n: int, window: int = 10, polyorder: int = 2) -> np.ndarray:
    """Savitzky–Golay smoothing as an (n, n) f32 operator: scipy's
    savgol_filter applied to the identity, edges and even window included
    (the reference smooths its line points with savgol_filter(points, 10,
    2, axis=0), datasets.py:373).  Without scipy: a centred moving average
    of the same window, as the JAX package falls back."""
    try:
        from scipy.signal import savgol_filter

        return savgol_filter(np.eye(n), window, polyorder, axis=0).astype(np.float32)
    except ImportError:
        m = np.zeros((n, n), dtype=np.float32)
        half = window // 2
        for i in range(n):
            lo, hi = max(0, i - half), min(n, i + half + 1)
            m[i, lo:hi] = 1.0 / (hi - lo)
        return m


def smooth_polyline(points: torch.Tensor, operator: torch.Tensor) -> torch.Tensor:
    """Savitzky–Golay smoothing of (..., N, 2) points in f32 (TF32 off).
    ``operator``: ``savgol_matrix(N, ...)`` already on the points' device,
    made once by the caller so that no call copies from the host."""
    with tf32_off():
        return torch.matmul(operator, points)
