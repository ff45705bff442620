"""Host-side object masks of the defect synthesizer.

Counterpart of ssad_tpu/data/masks.py (a copy: the port imports nothing
of the JAX package).  The reference segments the object of a subject, or
of each image of a NON_FIXED_OBJECTS subject, with skimage Canny + binary
morphology + the largest connected component (dataset_generator.py:27-39),
after a SLIC posterization for 'cable' (datasets.py:201-205).  This runs
once per subject or image on the host, with OpenCV where it imports and a
numpy path where it does not; both packages take the same path on the
same machine, so they give the same masks.  The masks and their packed
coordinates are uploaded once.

Packing: ``np.nonzero(mask)`` row-major order as (x, y) pairs, the
reference's coords_map (datasets.py:263-264).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ssad_tpu_torch import constants

try:
    import cv2

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


def mask_backend() -> str:
    """'cv2' or 'numpy': which path object_mask takes here."""
    return "cv2" if _HAS_CV2 else "numpy"


def object_mask(image_u8: np.ndarray) -> np.ndarray:
    """Binary (H, W) uint8 object mask of an RGB uint8 image.

    gray → blur(σ=1.5) → Canny(5, 15) → dilate 3×3 → close 3×3 → fill
    holes → erode 4×4 → largest connected component; all ones when no
    component survives (the reference's argmax over an empty bincount
    gives labels == 0, full white)."""
    if not _HAS_CV2:
        return _object_mask_numpy(image_u8)

    gray = cv2.cvtColor(image_u8, cv2.COLOR_RGB2GRAY)
    blurred = cv2.GaussianBlur(gray, (0, 0), sigmaX=1.5)
    edges = cv2.Canny(blurred, 5, 15)

    k3 = np.ones((3, 3), np.uint8)
    m = cv2.dilate(edges, k3)
    m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, k3)
    m = fill_holes(m > 0).astype(np.uint8) * 255
    m = cv2.erode(m, np.ones((4, 4), np.uint8))

    mask = (m > 0).astype(np.uint8)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(mask, connectivity=8)
    if n <= 1:
        return np.ones_like(mask)
    largest = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
    return (labels == largest).astype(np.uint8)


def _object_mask_numpy(image_u8: np.ndarray) -> np.ndarray:
    """The path without OpenCV: gradient-magnitude threshold + fill."""
    gray = image_u8.astype(np.float32).mean(axis=-1)
    gy, gx = np.gradient(gray)
    mag = np.hypot(gx, gy)
    mask = (mag > 5).astype(np.uint8)
    mask = fill_holes(mask > 0).astype(np.uint8)
    return mask if mask.any() else np.ones_like(mask)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Background not 4-connected to the border is a hole and is filled."""
    h, w = mask.shape
    m = mask.astype(np.uint8).copy()
    if _HAS_CV2:
        # a zero ring 4-connects every border background region, so one
        # flood fill from (0, 0) reaches them all
        ff = np.pad(m, 1)
        cv2.floodFill(ff, np.zeros((h + 4, w + 4), np.uint8), (0, 0), 1)
        holes = (ff[1:-1, 1:-1] == 0) & (m == 0)
        return mask | holes
    outside = np.zeros((h, w), bool)
    dq = deque()
    for i in range(h):
        for j in (0, w - 1):
            if not m[i, j] and not outside[i, j]:
                outside[i, j] = True
                dq.append((i, j))
    for j in range(w):
        for i in (0, h - 1):
            if not m[i, j] and not outside[i, j]:
                outside[i, j] = True
                dq.append((i, j))
    while dq:
        i, j = dq.popleft()
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ni, nj = i + di, j + dj
            if 0 <= ni < h and 0 <= nj < w and not m[ni, nj] and not outside[ni, nj]:
                outside[ni, nj] = True
                dq.append((ni, nj))
    return mask | (~outside & (m == 0))


def posterize_cable(image_u8: np.ndarray, n_segments: int = 5) -> np.ndarray:
    """Colour-quantise an image into ~n_segments LAB clusters, each pixel
    painted with its cluster's mean RGB: the stand-in for the reference's
    SLIC(n_segments=5, sigma=2, lab) + label2rgb(kind='avg') of 'cable'
    (datasets.py:201-205).  The identity without OpenCV."""
    if not _HAS_CV2:
        return image_u8
    blurred = cv2.GaussianBlur(image_u8, (0, 0), sigmaX=2.0)
    lab = cv2.cvtColor(blurred, cv2.COLOR_RGB2LAB).reshape(-1, 3).astype(np.float32)
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 20, 1.0)
    _, labels, _ = cv2.kmeans(lab, n_segments, None, criteria, 3, cv2.KMEANS_PP_CENTERS)
    labels = labels.reshape(-1)
    out = np.zeros_like(image_u8)
    flat = image_u8.reshape(-1, 3)
    for k in range(n_segments):
        sel = labels == k
        if sel.any():
            out.reshape(-1, 3)[sel] = flat[sel].mean(axis=0).astype(np.uint8)
    return out


def subject_mask(image_u8: np.ndarray, subject: str) -> np.ndarray:
    """Object mask of one subject image, all ones for a texture, with the
    cable posterization (reference datasets.py:195-206)."""
    if constants.is_texture(subject):
        return np.ones(image_u8.shape[:2], np.uint8)
    src = posterize_cable(image_u8) if subject == "cable" else image_u8
    return object_mask(src)


def pack_coords(mask: np.ndarray, max_coords: int | None = None) -> tuple[np.ndarray, int]:
    """Mask → ((max_coords, 2) int32 (x, y) in row-major order, count).
    The padding repeats the last coordinate (the centre for an empty
    mask), so a gather past the count stays on the canvas."""
    h, w = mask.shape
    if max_coords is None:
        max_coords = h * w
    ys, xs = np.nonzero(mask)
    out = np.zeros((max_coords, 2), np.int32)
    if xs.size == 0:
        out[:] = (w // 2, h // 2)
        return out, 0
    n = min(int(xs.size), max_coords)
    out[:n, 0] = xs[:n]
    out[:n, 1] = ys[:n]
    out[n:] = out[n - 1]
    return out, n
