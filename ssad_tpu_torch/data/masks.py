"""Host-side object masks of the defect synthesizer.

Counterpart of ssad_tpu/data/masks.py (a copy: the port imports nothing
of the JAX package).  The reference segments the object of a subject, or
of each image of a NON_FIXED_OBJECTS subject, with skimage Canny + binary
morphology + the largest connected component (dataset_generator.py:27-39),
after a SLIC posterization for 'cable' (datasets.py:201-205).  The JAX
package does that with OpenCV where it imports, and otherwise takes a
numpy path: a gradient-magnitude threshold and a hole fill, with no
posterization.  The port has only that numpy path, so every machine, the
card's (which has no OpenCV) included, gives the same masks; on a bright
disc over a noisy background it agrees with the OpenCV path to an IoU of
0.88–0.90 (tests/test_torch_masks.py).  This runs once per subject or
image on the host; the masks and their packed coordinates are uploaded
once.

Packing: ``np.nonzero(mask)`` row-major order as (x, y) pairs, the
reference's coords_map (datasets.py:263-264).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_fill_holes

from ssad_tpu_torch import constants


def object_mask(image_u8: np.ndarray) -> np.ndarray:
    """Binary (H, W) uint8 object mask of an RGB uint8 image: the gray
    gradient's magnitude above 5, holes filled; all ones when nothing
    passes."""
    gray = image_u8.astype(np.float32).mean(axis=-1)
    gy, gx = np.gradient(gray)
    mag = np.hypot(gx, gy)
    mask = (mag > 5).astype(np.uint8)
    mask = fill_holes(mask > 0).astype(np.uint8)
    return mask if mask.any() else np.ones_like(mask)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Background not 4-connected to the border is a hole and is filled."""
    m = mask.astype(bool)
    return mask | (binary_fill_holes(m) & ~m)


def subject_mask(image_u8: np.ndarray, subject: str) -> np.ndarray:
    """Object mask of one subject image, all ones for a texture
    (reference datasets.py:195-206)."""
    if constants.is_texture(subject):
        return np.ones(image_u8.shape[:2], np.uint8)
    return object_mask(image_u8)


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
