"""Visual-QA figures.

Counterpart of ssad_tpu/evaluation/visualization.py's
``augmentation_grid`` (:211-235).  The JAX package draws with matplotlib;
the port tiles one uint8 mosaic with PIL, which every machine the port
runs on has: one row per pretext class in PRETEXT_CLASSES order, its name
at the row's left, up to GRID_COLUMNS samples.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from ssad_tpu_torch.constants import PRETEXT_CLASSES

GRID_COLUMNS = 6
_LABEL_W, _GAP = 96, 4


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
