#!/usr/bin/env python3
"""Spread over seeds of the patch path's k-NN agreement, on a card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_patch_margin.py [--seeds 1 2 3 4] [--group 4]

For each seed it runs chip_smoke.py's patch phase (a seeded MVTec-layout
PNG tree → ``cli export --mode patch`` with 50 normality images → the
``serve`` loader → HTTP) and prints the largest |served map − map rebuilt
from the same embeddings through the plain tiled k-NN|, beside the limit
chip_smoke.py holds it to.  The seed draws the train-good images, so the
29,435-row bank, and the requests.  ``--group`` builds every kernel with
``-DSSAD_KNN_TILED_GROUP=G`` (into its own library), which sets how many
16-deep steps csrc/knn_tiled.cu sums in a fresh accumulator before each
IEEE f32 add into the running sum (4 as shipped; 1 for the finest: the
kernel's accuracy against its speed).  Prints one JSON line per seed,
then a summary line with the built kernel's G and its device µs per call
at the request shape (6728 × 29435 × 512, k = 3), and the card's name and
power limit.  Imports nothing of JAX or of the JAX package.
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
    ap.add_argument("--group", type=int, choices=[1, 4], default=None,
                    help="16-deep steps per fresh accumulator (default: the kernel's 4)")
    args = ap.parse_args(argv)

    import torch

    from ssad_tpu_torch.ops import _cuda, knn
    from ssad_tpu_torch.utils.device import resolve_device

    if args.group is not None:  # before anything is built or bound
        _cuda.NVCC_FLAGS += (f"-DSSAD_KNN_TILED_GROUP={args.group}",)

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
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((chip_smoke.BATCH * chip_smoke.WINDOWS, 512), generator=gen, device=device)
    bank = knn.prepare_tiled_bank(torch.randn((29435, 512), generator=gen, device=device))
    us = chip_smoke.device_us(lambda: knn.knn_cosine_scores_tiled_cuda(q, bank, k=3),
                              "knn_tiled", 10)
    print(json.dumps({"seeds": args.seeds, "group": knn.knn_tiled_group_depth() // 16,
                      "largest": worst,
                      "limit": chip_smoke.KNN_TOL, "share_of_limit": worst / chip_smoke.KNN_TOL,
                      "device_us_6728x29435x512": us}), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
