#!/usr/bin/env python3
"""Wall time of the port's patch-mode export per subject on a card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_export_time.py [--subjects bottle hazelnut screw] [--repeats 3]

Writes a seeded 256² MVTec-layout tree (63 train-good PNGs per subject, as
chip_smoke.py's patch path, and a ``carpet`` texture category beside
them) and one seeded reference checkpoint per subject, then runs
``cli export --mode patch --n-normality-images 50`` in process: once for
the first subject to warm up (the kernels' build, the first imports),
then ``--repeats`` timed exports per subject.

Prints one JSON line per subject (the seconds of each timed export and
their median) and one line with the warm-up and the card's name and
power limit.  It uses only ``chip_smoke.reference_state_dict``,
``tests/_torch_card_fixtures.py``'s ``synthetic_images`` and the
``export`` command, so the same file copied into another checkout that
has them times that checkout's export: run it in a parent and a change
within one call to compare them.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402  (this checkout's root on sys.path first)
from _torch_card_fixtures import synthetic_images  # noqa: E402

IMAGES, NORMALITY_IMAGES = 63, 50


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subjects", nargs="+", default=["bottle", "hazelnut", "screw"])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import torch
    from PIL import Image

    from ssad_tpu_torch import cli
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="export_time_") as tmp:
        work = Path(tmp)
        rng = np.random.default_rng(1)
        for cat in [*args.subjects, "carpet"]:
            good = work / "mvtec" / cat / "train" / "good"
            good.mkdir(parents=True)
            for i, img in enumerate(synthetic_images(rng, IMAGES)):
                Image.fromarray((img * 255).astype(np.uint8)).save(good / f"{i:03d}.png")
        sd = chip_smoke.reference_state_dict(0)
        for subject in args.subjects:
            save_reference_checkpoint(work / "models" / subject / "best_model.ckpt", sd)

        def export(subject: str) -> float:
            argv = ["export", "--models-dir", str(work / "models"), "--subject", subject,
                    "--mode", "patch", "--dataset-dir", str(work / "mvtec"),
                    "--n-normality-images", str(NORMALITY_IMAGES),
                    "--out", str(work / f"{subject}.ssadpt")]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(argv)
            if rc != 0:
                raise SystemExit(f"export {subject} returned {rc}")
            return time.perf_counter() - t0

        warmup_s = export(args.subjects[0])
        for subject in args.subjects:
            times = [export(subject) for _ in range(args.repeats)]
            print(json.dumps({"subject": subject, "export_s": times,
                              "median_s": float(np.median(times))}), flush=True)
    print(json.dumps({"warmup_export_s": warmup_s, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
