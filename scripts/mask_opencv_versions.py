#!/usr/bin/env python3
"""The port's object masks against the JAX package's OpenCV path under the
OpenCV installed here.

Run from the root of a checkout on any machine with OpenCV:

    python3 scripts/mask_opencv_versions.py

Loads ``ssad_tpu/data/masks.py`` from its file (numpy and cv2 only; the
rest of the JAX package, and JAX, need not be installed) and runs its
``object_mask`` and the port's over ``MASK_CORPUS``
(tests/_torch_card_fixtures.py) at 64² and 256² (the non-cable images).  Prints one JSON line: OpenCV's
version, the images whose masks differ, and the digest of the 256²
corpus with the reference's masks in place of the port's on the
non-cable images, beside ``MASK_DIGEST``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import _torch_card_fixtures as fx  # noqa: E402  (this checkout's tests/ on sys.path first)


def main() -> int:
    import cv2

    from ssad_tpu_torch.data import masks

    spec = importlib.util.spec_from_file_location(
        "reference_masks", ROOT / "ssad_tpu" / "data" / "masks.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    assert reference._HAS_CV2
    differ, compared = [], 0
    for size in (64, 256):
        for name, subject in fx.MASK_CORPUS:
            if subject == "cable":
                continue
            img = fx.mask_corpus_image(name, size)
            compared += 1
            if not np.array_equal(masks.object_mask(img), reference.object_mask(img)):
                differ.append(f"{name}@{size}")
    ours = fx.corpus_masks(256)
    mixed = [m if subject == "cable"
             else reference.object_mask(fx.mask_corpus_image(name, 256))
             for m, (name, subject) in zip(ours, fx.MASK_CORPUS)]
    digest = fx.mask_digest(mixed)
    print(json.dumps({"opencv": cv2.__version__, "compared": compared, "differ": differ,
                      "reference_digest": digest, "pinned": fx.MASK_DIGEST,
                      "equal": digest == fx.MASK_DIGEST and not differ}), flush=True)
    return 0 if digest == fx.MASK_DIGEST and not differ else 1


if __name__ == "__main__":
    sys.exit(main())
