"""Image decoding (counterpart of ssad_tpu/data/mvtec.py:25-38).

The dataset loaders wait for the training and evaluation slices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_image(path, imsize: Tuple[int, int]) -> np.ndarray:
    """Decode + resize one image (path or binary file object) to
    (H, W, 3) float32 in [0, 1], in the reference's PIL
    open → resize → convert('RGB') order (PIL's default resample)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.resize((imsize[1], imsize[0])).convert("RGB")
        return np.asarray(img, np.float32) / 255.0
