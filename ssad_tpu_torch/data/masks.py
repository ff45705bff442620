"""Host-side object masks of the defect synthesizer.

Counterpart of ssad_tpu/data/masks.py (the port imports nothing of the
JAX package).  The reference segments the object of a subject, or of each
image of a NON_FIXED_OBJECTS subject, with skimage Canny + binary
morphology + the largest connected component (dataset_generator.py:27-39),
after a SLIC posterization for 'cable' (datasets.py:201-205).  The JAX
package does that with OpenCV; this module computes the same masks, bit
for bit, with numpy and scipy alone, one function per OpenCV call, each
following that call's 8-bit arithmetic: fixed-point colour conversions and
blur, its Canny's suppression and hysteresis, its rectangular morphology
and its numbering of connected components.  Only the k-means of the cable
posterization differs: OpenCV draws its seeds from a per-thread generator
that the JAX function never seeds, so its masks vary from call to call;
here the draws come from ``numpy.random.Generator(seed)``.

This runs once per subject or image on the host; the masks and their
packed coordinates are uploaded once.  Packing: ``np.nonzero(mask)``
row-major order as (x, y) pairs, the reference's coords_map
(datasets.py:263-264).
"""

from __future__ import annotations

import functools
import math

import numpy as np
from scipy import ndimage

from ssad_tpu_torch import constants

_EIGHT = np.ones((3, 3), bool)


def rgb_to_gray(image_u8: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2GRAY)``: OpenCV's 15-bit fixed-point
    weights (0.299, 0.587, 0.114 scaled by 2¹⁵ and rounded), rounded half up."""
    x = image_u8.astype(np.int32)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15
            ).astype(np.uint8)


def gaussian_taps_u8(sigma: float) -> np.ndarray:
    """The 8-bit Gaussian kernel OpenCV derives from σ for ``ksize=(0, 0)``:
    ``cvRound(σ·3·2 + 1) | 1`` taps (``σ·4`` is its rule for float images),
    the exact Gaussian normalised to 1, then quantised to 8 fractional bits
    with the rounding error carried from tap to tap and the centre taking
    the rest, so the taps sum to 256."""
    n = int(np.rint(sigma * 3 * 2 + 1)) | 1
    half = n // 2
    scale = -0.125 / (sigma * sigma)  # the offsets x run over odd numbers: (x/2)² = x²/4
    vals = [math.exp(x * x * scale) for x in range(1 - n, 0, 2)]
    inv = 1.0 / (2.0 * sum(vals) + 1.0)
    taps = np.zeros(n, np.int64)
    err = 0.0
    for i, v in enumerate(vals):
        adj = v * inv * 256.0 + err
        taps[i] = taps[n - 1 - i] = int(np.rint(adj))
        err = adj - float(taps[i])
    taps[half] = 256 - 2 * int(taps[:half].sum())
    return taps


def gaussian_blur_u8(image_u8: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(image, (0, 0), sigmaX=σ)`` of a uint8 image (2-D
    or channels last): the taps of ``gaussian_taps_u8`` across the rows,
    then down the columns, in exact integers (8 + 8 fractional bits, at
    most 255·2¹⁶), the sum rounded half up; border reflect-101."""
    taps = gaussian_taps_u8(sigma)
    r = len(taps) // 2
    x = image_u8.astype(np.int32)
    h, w = x.shape[:2]
    pad = [(0, 0)] * x.ndim
    pad[1] = (r, r)
    p = np.pad(x, pad, mode="reflect")
    rows = sum(int(t) * p[:, j:j + w] for j, t in enumerate(taps) if t)
    pad[1], pad[0] = (0, 0), (r, r)
    p = np.pad(rows, pad, mode="reflect")
    both = sum(int(t) * p[i:i + h] for i, t in enumerate(taps) if t)
    return ((both + (1 << 15)) >> 16).astype(np.uint8)


def _shifted(p: np.ndarray, r: int, h: int, w: int):
    """View ``(dy, dx) → p[r+dy : r+dy+h, r+dx : r+dx+w]`` of an array
    padded by ``r`` on every side."""
    return lambda dy, dx: p[r + dy:r + dy + h, r + dx:r + dx + w]


def canny(gray_u8: np.ndarray, low: int, high: int) -> np.ndarray:
    """``cv2.Canny(gray, low, high)`` (aperture 3, L1 gradient): {0, 255} uint8.

    The 3×3 Sobel derivatives with a replicated border; magnitude
    |dx| + |dy|; non-maximum suppression along the gradient's direction,
    binned at 22.5° and 67.5° in OpenCV's 15-bit fixed point, a pixel kept
    when it is above its neighbour behind and at least its neighbour ahead
    (above both on the diagonals), the magnitude outside the image 0;
    then the kept pixels above ``low`` whose 8-connected component holds
    one above ``high``."""
    h, w = gray_u8.shape
    g = _shifted(np.pad(gray_u8.astype(np.int32), 1, mode="edge"), 1, h, w)
    dx = g(-1, 1) - g(-1, -1) + 2 * (g(0, 1) - g(0, -1)) + g(1, 1) - g(1, -1)
    dy = g(1, -1) - g(-1, -1) + 2 * (g(1, 0) - g(-1, 0)) + g(1, 1) - g(-1, 1)
    mag = np.abs(dx) + np.abs(dy)
    m = _shifted(np.pad(mag, 1), 1, h, w)

    ax, ay = np.abs(dx), np.abs(dy) << 15  # |d| ≤ 1020: int32 holds ax·2¹⁶ + ax·tg22
    tg22 = ax * int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)
    horizontal = ay < tg22
    vertical = ~horizontal & (ay > tg22 + (ax << 16))
    diagonal = ~horizontal & ~vertical
    rising = (dx ^ dy) < 0  # the gradient's components of opposite sign
    behind = np.select([horizontal, vertical, rising], [m(0, -1), m(-1, 0), m(-1, 1)], m(-1, -1))
    ahead = np.select([horizontal, vertical, rising], [m(0, 1), m(1, 0), m(1, -1)], m(1, 1))
    kept = (mag > behind) & np.where(diagonal, mag > ahead, mag >= ahead)

    weak = kept & (mag > low)
    labels, n = ndimage.label(weak, structure=_EIGHT)
    holds_strong = np.zeros(n + 1, bool)
    holds_strong[labels[weak & (mag > high)]] = True
    holds_strong[0] = False
    return holds_strong[labels].astype(np.uint8) * 255


def _morph(mask_u8: np.ndarray, ksize: int, reduce, border: int) -> np.ndarray:
    """``reduce`` over a ksize × ksize window anchored at
    (ksize // 2, ksize // 2) — rows y − a … y + ksize − 1 − a — with the
    outside at ``border``, the value that never wins (OpenCV's default
    border value for erosion and dilation)."""
    anchor = ksize // 2
    before, after = anchor, ksize - 1 - anchor
    h, w = mask_u8.shape
    p = np.pad(mask_u8, ((before, after), (0, 0)), constant_values=border)
    rows = reduce.reduce([p[i:i + h] for i in range(ksize)])
    p = np.pad(rows, ((0, 0), (before, after)), constant_values=border)
    return reduce.reduce([p[:, j:j + w] for j in range(ksize)])


def dilate(mask_u8: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((ksize, ksize)))``."""
    return _morph(mask_u8, ksize, np.maximum, 0)


def erode(mask_u8: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.erode(mask, np.ones((ksize, ksize)))``: the border never erodes."""
    return _morph(mask_u8, ksize, np.minimum, 255)


def close(mask_u8: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_CLOSE, np.ones((ksize, ksize)))``."""
    return erode(dilate(mask_u8, ksize), ksize)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Background not 4-connected to the border is a hole and is filled."""
    background, _ = ndimage.label(~mask.astype(bool))
    rim = np.concatenate([background[0], background[-1], background[:, 0], background[:, -1]])
    return mask | ((background > 0) & ~np.isin(background, rim))


def largest_component(mask: np.ndarray) -> np.ndarray:
    """The largest 8-connected component of a binary mask as uint8 {0, 1},
    or all ones when the mask is empty (the JAX package's, and the
    reference's, fallback).

    ``cv2.connectedComponentsWithStats`` numbers the components in the
    order of their first 2×2 block (rows 2i, 2i+1 × columns 2j, 2j+1) in a
    raster scan of blocks, and ``argmax`` over the areas keeps the first
    of equal ones, so that order breaks ties."""
    labels, n = ndimage.label(mask > 0, structure=_EIGHT)
    if n == 0:
        return np.ones(mask.shape, np.uint8)
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    area = np.bincount(lab, minlength=n + 1)[1:]
    first_block = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first_block, lab, (ys // 2).astype(np.int64) * mask.shape[1] + xs // 2)
    tied = np.flatnonzero(area == area.max()) + 1
    return (labels == tied[np.argmin(first_block[tied])]).astype(np.uint8)


def object_mask(image_u8: np.ndarray) -> np.ndarray:
    """Binary (H, W) uint8 object mask of an RGB uint8 image
    (dataset_generator.py:27-39): gray → blur(σ = 1.5) → Canny(5, 15) →
    dilate 3×3 → close 3×3 → fill holes → erode 4×4 → the largest
    8-connected component; all ones when none is left."""
    edges = canny(gaussian_blur_u8(rgb_to_gray(image_u8), 1.5), 5, 15)
    m = close(dilate(edges, 3), 3)
    m = fill_holes(m > 0).astype(np.uint8) * 255
    return largest_component(erode(m, 4))


# --- the cable posterization ---------------------------------------------------


@functools.cache
def _lab_tables():
    """OpenCV's 8-bit RGB→Lab tables: the sRGB gamma at 3 fractional bits
    (``round(2040·γ(i/255))``), and f(t) (the cube root, linear below
    (6/29)³) at 15 fractional bits over t = i/2040, i < 3072, each in
    OpenCV's float32 steps; its cube root is a rational polynomial in double
    precision whose result is truncated, not rounded, to float32."""
    f32 = np.float32
    x = (f32(np.arange(256)) / f32(255)).astype(np.float64)
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4).astype(f32)
    gamma_tab = np.rint(f32(2040) * gamma).astype(np.int64)

    t = (f32(1) / f32(2040)) * np.arange(3072).astype(f32)
    bits = t.view(np.uint32).astype(np.int64)
    ex = ((bits >> 23) & 0xFF) - 127
    shx = np.fmod(ex, 3)
    shx = shx - np.where(shx >= 0, 3, 0)
    ex = (ex - shx) // 3 - 1
    fr = ((shx + 1023) << 52 | (bits & 0x7FFFFF) << 29).astype(np.uint64).view(np.float64)
    fr = ((((45.2548339756803022511987494 * fr + 192.2798368355061050458134625) * fr
            + 119.1654824285581628956914143) * fr + 13.43250139086239872172837314) * fr
          + 0.1636161226585754240958355063) / (
        (((14.80884093219134573786480845 * fr + 151.9714051044435648658557668) * fr
          + 168.5254414101568283957668343) * fr + 33.9905941350215598754191872) * fr + 1.0)
    cbrt = ((ex + 127) << 23 | (fr.view(np.uint64) & ((1 << 52) - 1)).astype(np.int64) >> 29)
    cbrt = np.where(bits != 0, cbrt, 0).astype(np.uint32).view(f32)
    linear = (t.astype(np.float64) * f32(841 / 108) + f32(16 / 116)).astype(f32)  # one rounding
    f = np.where(t < f32(216) / f32(24389), linear, cbrt)
    return gamma_tab, np.rint(f32(1 << 15) * f).astype(np.int64)


#: sRGB → XYZ (D65) over the white point, at 12 fractional bits, rows X, Y, Z
_XYZ = np.rint(4096 * np.array([[0.412453, 0.357580, 0.180423],
                                [0.212671, 0.715160, 0.072169],
                                [0.019334, 0.119193, 0.950227]])
               / np.array([[0.950456], [1.0], [1.088754]])).astype(np.int64)


def rgb_to_lab(image_u8: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2LAB)`` of a uint8 image: OpenCV's
    fixed-point 8-bit path (L·255/100, a + 128, b + 128)."""
    gamma_tab, f_tab = _lab_tables()
    rgb = gamma_tab[image_u8.astype(np.int64)]
    fx, fy, fz = (f_tab[(rgb @ row + (1 << 11)) >> 12] for row in _XYZ)
    half = 1 << 14
    lum = ((116 * 255 + 50) // 100 * fy - (16 * 255 * (1 << 15) + 50) // 100 + half) >> 15
    a = (500 * (fx - fy) + (128 << 15) + half) >> 15
    b = (200 * (fy - fz) + (128 << 15) + half) >> 15
    return np.clip(np.stack([lum, a, b], axis=-1), 0, 255).astype(np.uint8)


def _sq_dist(data: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Squared distance of float32 rows to a float32 centre (one, or one per
    row), summed in float32 from the first coordinate."""
    t = data - center
    d = t[:, 0] * t[:, 0]
    for j in range(1, data.shape[1]):
        d = d + t[:, j] * t[:, j]
    return d


def _first_crossing(p: float, dist: np.ndarray) -> int:
    """The first i at which ``p − dist[0] − … − dist[i]`` (subtracted in that
    order, in double) is ≤ 0, else the last index."""
    run = np.cumsum(np.concatenate([[p], -dist.astype(np.float64)]))[1:]
    hit = np.flatnonzero(run <= 0)
    return int(hit[0]) if hit.size else len(dist) - 1


def _centers_pp(data: np.ndarray, k: int, rng) -> np.ndarray:
    """k-means++ seeding as ``cv2.kmeans(..., KMEANS_PP_CENTERS)``: the first
    centre uniform, each next the best of 3 draws proportional to the
    squared distance, by the sum of the distances it leaves."""
    n = len(data)
    picks = [int(rng.integers(n))]
    dist = _sq_dist(data, data[picks[0]])
    total = float(np.cumsum(dist.astype(np.float64))[-1])
    for _ in range(1, k):
        best = None
        for _ in range(3):
            ci = _first_crossing(rng.random() * total, dist)
            cand = np.minimum(_sq_dist(data, data[ci]), dist)
            s = float(np.cumsum(cand.astype(np.float64))[-1])
            if best is None or s < best[0]:
                best = (s, ci, cand)
        total, ci, dist = best
        picks.append(ci)
    return data[picks].copy()


def _assign(data: np.ndarray, centers: np.ndarray) -> np.ndarray:
    d = np.stack([_sq_dist(data, c) for c in centers], axis=1)
    return np.argmin(d, axis=1)


def _update(data_i: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    """Each cluster's float32 mean from exact integer sums; an empty cluster
    takes the point of the largest cluster farthest from its mean."""
    dims = data_i.shape[1]
    counts = np.bincount(labels, minlength=k)
    sums = np.stack([np.bincount(labels, weights=data_i[:, j], minlength=k)
                     for j in range(dims)], axis=1).astype(np.int64)
    for c in np.flatnonzero(counts == 0):
        big = int(np.argmax(counts))
        base = sums[big].astype(np.float32) * (np.float32(1) / np.float32(counts[big]))
        members = np.flatnonzero(labels == big)
        d = _sq_dist(data_i[members].astype(np.float32), base).astype(np.float64)
        far = members[len(d) - 1 - int(np.argmax(d[::-1]))]  # the last of the farthest
        counts[big] -= 1
        counts[c] += 1
        labels[far] = c
        sums[big] -= data_i[far]
        sums[c] += data_i[far]
    return sums.astype(np.float32) * (np.float32(1) / counts.astype(np.float32))[:, None]


def kmeans(data_u8: np.ndarray, k: int, rng) -> np.ndarray:
    """Labels of ``cv2.kmeans(data, k, None, (EPS + MAX_ITER, 20, 1.0), 3,
    KMEANS_PP_CENTERS)`` over integer-valued rows, with the draws from
    ``rng`` (``integers``, ``random``).  Each of 3 attempts seeds by
    k-means++, then alternates assignment and update until 20 rounds or a
    largest squared centre shift ≤ 1; the last update keeps its labels.
    The attempt of least compactness (the summed squared distance to the
    own centre, in double) wins, the first of equal ones."""
    data_i = data_u8.astype(np.int64)
    data = data_u8.astype(np.float32)
    best = None
    for _ in range(3):
        centers = _centers_pp(data, k, rng)
        labels = _assign(data, centers)
        for it in range(1, 20):
            old, centers = centers, _update(data_i, labels, k)
            shift = ((centers - old).astype(np.float64) ** 2).sum(axis=1).max()
            if it == 19 or shift <= 1.0:
                break
            labels = _assign(data, centers)
        compact = math.fsum(_sq_dist(data, centers[labels]).astype(np.float64))
        if best is None or compact < best[0]:
            best = (compact, labels.copy())
    return best[1]


def posterize_cable(image_u8: np.ndarray, n_segments: int = 5, seed: int = 0) -> np.ndarray:
    """Colour-quantise an RGB image into ``n_segments`` Lab clusters (the JAX
    package's stand-in for the reference's SLIC + label2rgb posterization
    of 'cable', datasets.py:201-205): blur σ = 2, RGB → Lab, k-means++ over
    the Lab pixels (20 rounds or ε = 1, 3 attempts), each pixel painted
    with its cluster's mean RGB, truncated to uint8.  The k-means draws
    come from ``numpy.random.Generator(seed)``."""
    lab = rgb_to_lab(gaussian_blur_u8(image_u8, 2.0)).reshape(-1, 3)
    return paint_clusters(image_u8, kmeans(lab, n_segments, np.random.default_rng(seed)))


def paint_clusters(image_u8: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Each pixel of an RGB image painted with the mean colour of its
    cluster (``labels``: one per pixel, row-major), truncated to uint8."""
    flat = image_u8.reshape(-1, 3).astype(np.int64)
    k = int(labels.max()) + 1
    counts = np.bincount(labels, minlength=k)
    sums = np.stack([np.bincount(labels, weights=flat[:, j], minlength=k)
                     for j in range(3)], axis=1).astype(np.int64)
    means = sums // np.maximum(counts, 1)[:, None]
    return means.astype(np.uint8)[labels].reshape(image_u8.shape)


def subject_mask(image_u8: np.ndarray, subject: str) -> np.ndarray:
    """Object mask of one subject image: all ones for a texture, the
    posterized image's for 'cable' (reference datasets.py:195-206)."""
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
