"""Curves, overlays, visual-QA figures and training curves.

Counterpart of ssad_tpu/evaluation/visualization.py's ``plot_history``
(:48-66), ``plot_curve`` (:69-84), ``plot_multiple_curves`` (:86-101),
``plot_tsne`` (:113-135), ``heatmap_overlay`` (:138-145),
``segmentation_overlay`` (:148-163), ``save_image`` (:166-171),
``localization_panel`` (:174-208) and ``augmentation_grid`` (:211-235).
The JAX package draws with matplotlib (and scikit-learn's t-SNE, and
OpenCV's Canny border when it is installed); the port draws with PIL,
which every machine the port runs on has: the grid is one uint8 mosaic
(one row per pretext class in PRETEXT_CLASSES order, its name at the
row's left, up to GRID_COLUMNS samples), the history two line-chart
panels, loss and accuracy, a curve plot one square panel on [0, 1]² with
the chance diagonal and a legend, the t-SNE figure one square scatter
panel (the embedding from evaluation/tsne.py), a localization panel one
row of titled tiles.  The heatmap colours come from ``MAGMA``,
matplotlib's magma table as uint8 constants, indexed as matplotlib
indexes it, so an overlay equals the JAX package's bit for bit, and so
does a segmentation overlay's tint; its border is the mask's own edge
(mask pixels with a 4-neighbour outside the mask), where the JAX package
draws Canny's edges of the mask.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from ssad_tpu_torch.constants import PRETEXT_CLASSES

GRID_COLUMNS = 6
_LABEL_W, _GAP = 96, 4
_PANEL_W, _PANEL_H, _MARGIN = 480, 320, 40
_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b")
_CURVE_SIZE = 480

#: matplotlib's "magma" colormap, 256 entries of RRGGBB (its float table
#: × 255, truncated to uint8 as the JAX package's overlay truncates it)
MAGMA = (
    "00000300000400000601000701010901010b02020d02020f"
    "03031104031304041505041706051907051b08061d09071f"
    "0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31"
    "120d33140d35150e38160e3a170f3c180f3f1a10411b1044"
    "1c10461e10491f114b20114d221150231152251155261157"
    "2811592a115c2b115e2d10602f1062301065321067341068"
    "350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74"
    "430f75450f76470f774810784a10794b10794d117a4f117b"
    "50127b52127c53137c55137d57147d58157e5a157e5b167e"
    "5d177e5e177f60187f61187f63197f651a80661a80681b80"
    "691c806b1c806c1d806e1e816f1e81711f81731f81742081"
    "7621817721817922817a22817c23817e24817f2481812581"
    "8225818426818526818727818928818a28818c29808d2980"
    "8f2a80912a80922b80942b80952c80972c7f992d7f9a2d7f"
    "9c2e7f9e2e7e9f2f7ea12f7ea3307ea4307da6317da7317d"
    "a9327cab337cac337bae347bb0347bb1357ab3357ab53679"
    "b63679b83778b93778bb3877bd3977be3976c03a75c23a75"
    "c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070"
    "d0416fd1426ed3426dd4436dd6446cd7456bd9466ada4769"
    "dc4869dd4968de4a67e04b66e14c66e24d65e44e64e55063"
    "e65162e75262e85461ea5560eb5660ec585fed595fee5b5e"
    "ee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685b"
    "f56a5bf56c5bf66e5bf6705bf7715bf7735cf8755cf8775c"
    "f9795cf97b5df97d5dfa7f5efa805efa825ffb8460fb8660"
    "fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567"
    "fd9768fd9969fd9b6afd9d6bfd9f6cfda16efda26ffda470"
    "fea671fea873feaa74feac75feae76feaf78feb179feb37b"
    "feb57cfeb77dfeb97ffebb80febc82febe83fec085fec286"
    "fec488fec689fec78bfec98dfecb8efdcd90fdcf92fdd193"
    "fdd295fdd497fdd698fdd89afdda9cfddc9dfddd9ffddfa1"
    "fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0"
    "fcf0b1fcf1b3fcf3b5fcf5b7fbf7b9fbf9bbfbfabdfbfcbf"
)


@functools.lru_cache(maxsize=1)
def _magma_u8() -> np.ndarray:
    return np.frombuffer(bytes.fromhex("".join(MAGMA)), np.uint8).reshape(256, 3)


def _line_panel(draw, left: int, title: str, series: Dict[str, Sequence[float]]) -> None:
    """One panel: axes, a line per series over its epochs, the legend."""
    x0, y0 = left + _MARGIN, _MARGIN
    x1, y1 = left + _PANEL_W - 10, _PANEL_H - _MARGIN
    draw.rectangle((x0, y0, x1, y1), outline="black")
    draw.text((x0, 10), title, fill="black")
    draw.text((x1 - 40, y1 + 12), "epoch", fill="black")
    vals = [float(v) for vs in series.values() for v in vs if np.isfinite(v)]
    if not vals:
        return
    lo, hi = min(vals), max(vals)
    hi = hi if hi > lo else lo + 1.0
    draw.text((left + 2, y0), f"{hi:.3g}", fill="black")
    draw.text((left + 2, y1 - 10), f"{lo:.3g}", fill="black")
    for i, (name, vs) in enumerate(series.items()):
        color = _COLORS[i % len(_COLORS)]
        n = max(len(vs) - 1, 1)
        pts = [(x0 + (x1 - x0) * j / n, y1 - (y1 - y0) * (float(v) - lo) / (hi - lo))
               for j, v in enumerate(vs) if np.isfinite(v)]
        if len(pts) > 1:
            draw.line(pts, fill=color, width=2)
        for px, py in pts:
            draw.ellipse((px - 2, py - 2, px + 2, py + 2), fill=color)
        draw.text((x0 + 6, y0 + 4 + 12 * i), name, fill=color)


def _xy_panel(draw, size: int, title: str, curves, x_label: str, y_label: str) -> None:
    """A square [0, 1]² panel: axes, the chance diagonal, one polyline per
    (label, x, y) curve and the legend in the lower right."""
    x0, y0, x1, y1 = _MARGIN, _MARGIN, size - 10, size - _MARGIN

    def at(x, y):
        return x0 + (x1 - x0) * float(x), y1 - (y1 - y0) * float(y)

    draw.rectangle((x0, y0, x1, y1), outline="black")
    draw.text((x0, 10), title, fill="black")
    draw.text(((x0 + x1) // 2 - 10, y1 + 12), x_label, fill="black")
    draw.text((4, y0 - 14), y_label, fill="black")
    for v in (0.0, 0.5, 1.0):
        draw.text((x0 - 24, at(0, v)[1] - 6), f"{v:.1f}", fill="black")
        draw.text((at(v, 0)[0] - 8, y1 + 2), f"{v:.1f}", fill="black")
    draw.line([at(0, 0), at(1, 1)], fill="gray", width=1)
    for i, (label, xs, ys) in enumerate(curves):
        color = _COLORS[i % len(_COLORS)]
        pts = [at(x, y) for x, y in zip(np.asarray(xs, np.float64), np.asarray(ys, np.float64))
               if np.isfinite(x) and np.isfinite(y)]
        if len(pts) > 1:
            draw.line(pts, fill=color, width=2)
        draw.text((x1 - 150, y1 - 14 * (len(curves) - i)), label, fill=color)


def _save(canvas, path) -> str:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    canvas.save(out)
    return str(out)


def plot_curve(x, y, area: float, saving_path, title: str, name: str) -> str:
    """One ROC/PRO curve with its area (reference visualization.py:51-77)
    → ``saving_path/name``."""
    from PIL import Image, ImageDraw

    canvas = Image.new("RGB", (_CURVE_SIZE, _CURVE_SIZE), "white")
    _xy_panel(ImageDraw.Draw(canvas), _CURVE_SIZE, title, [(f"area = {area:.4f}", x, y)],
              "FPR", "TPR / PRO")
    return _save(canvas, Path(saving_path) / name)


def plot_multiple_curves(curves: Sequence[tuple], saving_path, title: str, name: str) -> str:
    """Overlaid (label, x, y, area) curves (reference
    visualization.py:80-106) → ``saving_path/name``."""
    from PIL import Image, ImageDraw

    canvas = Image.new("RGB", (_CURVE_SIZE, _CURVE_SIZE), "white")
    _xy_panel(ImageDraw.Draw(canvas), _CURVE_SIZE, title,
              [(f"{label} ({area:.3f})", x, y) for label, x, y, area in curves], "FPR", "TPR")
    return _save(canvas, Path(saving_path) / name)


def heatmap_overlay(image, anomaly_map) -> np.ndarray:
    """uint8 overlay of a [0,1] anomaly map on a [0,1] RGB image in the
    magma colours, half and half (reference visualization.py:274-283)."""
    img = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
    return (0.5 * img + 0.5 * _magma(anomaly_map)).astype(np.uint8)


def _magma(values) -> np.ndarray:
    """Values in [0, 1] → uint8 RGB by matplotlib's lookup: floor(v · 256),
    1.0 → the last entry, NaN → black."""
    v = np.clip(np.asarray(values), 0, 1)
    idx = np.minimum(np.nan_to_num(v * 256, nan=0.0).astype(int), 255)
    return np.where(np.isnan(v)[..., None], np.uint8(0), _magma_u8()[idx])


def mask_border(mask) -> np.ndarray:
    """The pixels of a boolean mask that have a 4-neighbour outside it
    (the image's edge counts as outside)."""
    m = np.asarray(mask).astype(bool)
    inner = np.pad(m, 1, constant_values=False)
    interior = inner[:-2, 1:-1] & inner[2:, 1:-1] & inner[1:-1, :-2] & inner[1:-1, 2:]
    return m & ~interior


def segmentation_overlay(image, mask, color=(255, 0, 0), alpha: float = 0.35) -> np.ndarray:
    """Tint the predicted-anomalous region of a [0,1] RGB image and draw
    its border (reference visualization.py:169-177) → uint8."""
    img = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8).copy()
    m = np.asarray(mask).astype(bool)
    tint = np.zeros_like(img)
    tint[...] = color
    img[m] = (img[m] * (1 - alpha) + tint[m] * alpha).astype(np.uint8)
    img[mask_border(m)] = color
    return img


def _magma_image(a) -> np.ndarray:
    """A 2-D array as matplotlib's ``imshow(a, cmap="magma")`` shows it:
    min-max normalised, then the magma lookup → uint8 RGB."""
    a = np.asarray(a, np.float64)
    finite = a[np.isfinite(a)]
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 0.0)
    return _magma((a - lo) / (hi - lo) if hi > lo else np.zeros_like(a))


def localization_panel(original, anomaly_map, gt_mask, predicted_mask, saving_path,
                       name: str) -> str:
    """One row of titled tiles — original, heatmap overlay, anomaly map,
    ground truth (when given), predicted mask, segmentation (reference
    localizer.py:164-186) → ``saving_path/name``."""
    from PIL import Image, ImageDraw

    original = np.asarray(original)
    tiles = [("original", (np.clip(original, 0, 1) * 255).astype(np.uint8)),
             ("heatmap", heatmap_overlay(original, anomaly_map)),
             ("anomaly map", _magma_image(anomaly_map))]
    if gt_mask is not None:
        tiles.append(("ground truth", _magma_image(gt_mask)))
    tiles.append(("predicted mask", _magma_image(np.asarray(predicted_mask).astype(float))))
    tiles.append(("segmentation", segmentation_overlay(original, predicted_mask)))
    h, w = original.shape[:2]
    title_h = 16
    canvas = Image.new("RGB", (len(tiles) * (w + _GAP), h + title_h), "white")
    draw = ImageDraw.Draw(canvas)
    for i, (title, tile) in enumerate(tiles):
        left = i * (w + _GAP)
        draw.text((left + 2, 2), title, fill="black")
        canvas.paste(Image.fromarray(np.asarray(tile, np.uint8)), (left, title_h))
    return _save(canvas, Path(saving_path) / name)


#: the t-SNE figure's label names and colours (the JAX package's
#: matplotlib ``tab:`` colours): pretext classes 0-3, real good -1, real
#: defect 4
TSNE_LABELS = {
    0: ("good", "#2ca02c"),
    1: ("polygon", "#ff7f0e"),
    2: ("scar", "#d62728"),
    3: ("line", "#9467bd"),
    -1: ("mvtec good", "#1f77b4"),
    4: ("mvtec defect", "#8c564b"),
}


def plot_tsne(embeddings, labels, saving_path, title: str, name: str, seed: int = 0) -> str:
    """2-D t-SNE scatter of embeddings coloured by pretext / real label
    (reference visualization.py:109-145) → ``saving_path/name``.  The
    embedding runs on the device ``embeddings`` lie on
    (evaluation/tsne.py, perplexity min(30, max(5, n // 4)))."""
    import torch
    from PIL import Image, ImageDraw

    from ssad_tpu_torch.evaluation.tsne import tsne

    emb = torch.as_tensor(embeddings, dtype=torch.float32)
    pts = tsne(emb, seed=seed).cpu().numpy().astype(np.float64)
    labels = np.asarray(labels).astype(int).ravel()
    size = _CURVE_SIZE
    canvas = Image.new("RGB", (size, size), "white")
    draw = ImageDraw.Draw(canvas)
    x0, y0, x1, y1 = _MARGIN, _MARGIN, size - 10, size - _MARGIN
    draw.rectangle((x0, y0, x1, y1), outline="black")
    draw.text((x0, 10), title, fill="black")
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    at = (pts - lo) / span
    for i, val in enumerate(np.unique(labels)):
        label, color = TSNE_LABELS.get(int(val), (str(val), _COLORS[i % len(_COLORS)]))
        for px, py in at[labels == val]:
            cx, cy = x0 + 4 + (x1 - x0 - 8) * px, y1 - 4 - (y1 - y0 - 8) * py
            draw.ellipse((cx - 2, cy - 2, cx + 2, cy + 2), fill=color)
        draw.text((x1 - 110, y0 + 4 + 12 * i), label, fill=color)
    return _save(canvas, Path(saving_path) / name)


def save_image(array_u8: np.ndarray, path) -> str:
    from PIL import Image

    return _save(Image.fromarray(np.asarray(array_u8)), path)


def plot_history(history: Dict[str, Sequence[float]], saving_path, mode: str = "training") -> str:
    """Per-epoch loss (left) and accuracy (right) curves of a phase
    (reference visualization.py:20-49) → ``saving_path/{mode}_history.png``."""
    from PIL import Image, ImageDraw

    canvas = Image.new("RGB", (2 * _PANEL_W, _PANEL_H), "white")
    draw = ImageDraw.Draw(canvas)
    _line_panel(draw, 0, "loss", {k: v for k, v in history.items() if "loss" in k})
    _line_panel(draw, _PANEL_W, "accuracy",
                {k: v for k, v in history.items() if "accuracy" in k})
    out = Path(saving_path) / f"{mode}_history.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    canvas.save(out)
    return str(out)


def augmentation_grid(images_by_label: Dict[int, Sequence[np.ndarray]], saving_path,
                      name: str) -> str:
    """Write a grid of synthetic samples per pretext class (reference
    test_artificial_transformations.py:226-316) to ``saving_path/name``;
    images are (h, w, 3) floats in [0, 1].  Returns the file's path."""
    from PIL import Image, ImageDraw

    samples = [img for imgs in images_by_label.values() for img in imgs]
    if not samples:
        raise ValueError("augmentation_grid: no images")
    h, w = np.asarray(samples[0]).shape[:2]
    rows = len(PRETEXT_CLASSES)
    canvas = Image.new("RGB", (_LABEL_W + GRID_COLUMNS * (w + _GAP), rows * (h + _GAP)), "white")
    draw = ImageDraw.Draw(canvas)
    for r, cls in enumerate(PRETEXT_CLASSES):
        top = r * (h + _GAP)
        draw.text((4, top + h // 2 - 6), cls, fill="black")
        for c, img in enumerate(list(images_by_label.get(r, ()))[:GRID_COLUMNS]):
            u8 = (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255).round().astype(np.uint8)
            canvas.paste(Image.fromarray(u8), (_LABEL_W + c * (w + _GAP), top))
    out = Path(saving_path) / name
    out.parent.mkdir(parents=True, exist_ok=True)
    canvas.save(out)
    return str(out)
