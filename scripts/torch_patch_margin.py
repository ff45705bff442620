#!/usr/bin/env python3
"""Spread over seeds of the patch path's k-NN agreement, on a card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_patch_margin.py [--seeds 1 2 3 4]

For each seed it runs chip_smoke.py's patch phase (a seeded MVTec-layout
PNG tree → ``cli export --mode patch`` with 50 normality images → the
``serve`` loader → HTTP) and prints the largest |served map − map rebuilt
from the same embeddings through the plain tiled k-NN|, beside the limit
chip_smoke.py holds it to.  The seed draws the train-good images, so the
29,435-row bank, and the requests.  Prints one JSON line per seed, then a
summary line and the card's name and power limit.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (repo root on sys.path first)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args(argv)

    import torch

    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = {}
    for seed in args.seeds:
        work = Path(tempfile.mkdtemp(prefix=".chip_smoke_margin_", dir=ROOT))
        try:
            _, serving = chip_smoke.drive_patch_path(device, work, seed=seed)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        readings[seed] = serving["served_vs_plain_tiled_knn_max_abs"]
        print(json.dumps({"seed": seed, "served_vs_plain_tiled_knn_max_abs": readings[seed],
                          "map_max_range": serving["map_max_range"]}), flush=True)
    worst = max(readings.values())
    print(json.dumps({"seeds": args.seeds, "largest": worst, "limit": chip_smoke.KNN_TOL,
                      "share_of_limit": worst / chip_smoke.KNN_TOL}), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
