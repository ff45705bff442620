"""Visual-QA figures and training curves.

Counterpart of ssad_tpu/evaluation/visualization.py's ``plot_history``
(:49-66) and ``augmentation_grid`` (:211-235).  The JAX package draws
with matplotlib; the port draws with PIL, which every machine the port
runs on has: the grid is one uint8 mosaic (one row per pretext class in
PRETEXT_CLASSES order, its name at the row's left, up to GRID_COLUMNS
samples), the history two line-chart panels, loss and accuracy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from ssad_tpu_torch.constants import PRETEXT_CLASSES

GRID_COLUMNS = 6
_LABEL_W, _GAP = 96, 4
_PANEL_W, _PANEL_H, _MARGIN = 480, 320, 40
_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b")


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
