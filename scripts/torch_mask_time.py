#!/usr/bin/env python3
"""Host time of the port's object masks and of ``prepare_pretext_data``.

Run from the root of a checkout (the masks run on the host; the card is
only named):

    python3 scripts/torch_mask_time.py [--images 4] [--repeats 3]

Draws ``--images`` seeded 256² images of each of the ten object subjects
with the parity generator (``ssad_tpu_torch.parity._make_image``), times
``data.masks.object_mask`` on each (after one warm-up call) and
``subject_mask(image, "cable")`` on the cable images, then writes the
parity generator's tree for hazelnut (non-fixed: a mask per image),
bottle (fixed) and cable (fixed, posterized) at its defaults (40
train-good PNGs each) and times ``mvtec.prepare_pretext_data`` on each
subject ``--repeats`` times.  Prints one JSON line: the median and sorted
ms per mask, the seconds of each ``prepare_pretext_data``, a SHA-256 of
the masks, the checkout's commit where git knows it, and the card's name
and power limit.  It uses only functions the port has had since its
parity harness, so the same file copied into an older checkout times that
checkout's masks: run it in a parent and a change within one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

OBJECTS = ("bottle", "cable", "capsule", "hazelnut", "metal_nut", "pill", "screw",
           "toothbrush", "transistor", "zipper")
PREPARED = ("hazelnut", "bottle", "cable")


def card_line() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    from ssad_tpu_torch import parity
    from ssad_tpu_torch.data import masks, mvtec

    rng = np.random.default_rng(0)
    images = {s: [parity._make_image(rng, s, 256) for _ in range(args.images)] for s in OBJECTS}
    masks.object_mask(images["bottle"][0])  # warm-up
    digest = hashlib.sha256()
    ms = {"object_mask": [], "cable_subject_mask": []}
    for subject, imgs in images.items():
        for img in imgs:
            t0 = time.perf_counter()
            m = masks.object_mask(img)
            ms["object_mask"].append((time.perf_counter() - t0) * 1e3)
            digest.update(m.tobytes())
    for img in images["cable"]:
        t0 = time.perf_counter()
        m = masks.subject_mask(img, "cable")
        ms["cable_subject_mask"].append((time.perf_counter() - t0) * 1e3)
        digest.update(m.tobytes())

    prepare_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = parity.generate_parity_dataset(Path(tmp) / "tree", subjects=PREPARED,
                                              imsize=256)
        for subject in PREPARED:
            runs = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                data = mvtec.prepare_pretext_data(root, subject, imsize=(256, 256))
                runs.append(time.perf_counter() - t0)
            masks_made = 1 + (0 if data.train_masks is None
                              else len(data.train_masks) + len(data.val_masks))
            prepare_s[subject] = {"seconds": runs, "median_s": float(np.median(runs)),
                                  "masks_made": masks_made}
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                                cwd=ROOT, timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        commit = None
    print(json.dumps({
        "checkout": str(ROOT), "commit": commit, "size": 256,
        "images": {k: len(v) for k, v in ms.items()},
        "median_ms": {k: float(np.median(v)) for k, v in ms.items()},
        "ms_sorted": {k: sorted(v) for k, v in ms.items()},
        "prepare_pretext_data": prepare_s, "masks_sha256": digest.hexdigest(),
        "card": card_line(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
