#!/usr/bin/env python3
"""The port's ``cli parity --subjects all`` on a card, beside the JAX runs.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_parity_all.py [--out chiprun_out/parity_all] [--modes image,patch]

Runs ``python -m ssad_tpu_torch.cli parity --subjects all`` in process at
its defaults (the parity generator's 15 categories, 256², batch 96,
ResNet-18, bf16, 5 + 15 epochs, both modes, seed 0) under PyTorch's
default TF32 flags, its work (dataset, checkpoints) in a temporary
directory.  The three kernels' launch counts are set to 0 just before and
read just after.  Then each subject's and mode's metrics beside the JAX
package's committed summary of the same dataset at the same defaults
(``outputs/parity15/parity_summary.json``: accuracy only), the subjects
more than 0.05 below JAX on image or pixel AUROC, and the floors of
PERF.md §2 (mean image AUROC ≥ 0.80, pixel ≥ 0.90).  Prints one JSON line
(also written with the port's summary and tables under ``--out``) and
exits 1 when a floor is missed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (this checkout's root on sys.path first)

JAX_SUMMARY = ROOT / "outputs" / "parity15" / "parity_summary.json"
GAP = 0.05
KEYS = {"image": ("image_auroc", "image_f1"), "patch": ("pixel_auroc", "iou", "aupro")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/parity_all")
    ap.add_argument("--modes", default="image,patch")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    modes = [m for m in args.modes.split(",") if m]

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp) / "parity"
        chip_smoke._zero_launches()
        with chip_smoke.torch_default_tf32():
            t0 = time.perf_counter()
            _, wall = chip_smoke._run_cli(["parity", "--subjects", "all", "--modes", args.modes,
                                           "--outputs-dir", str(work), "--quiet"])
            launches = chip_smoke._eval_launches()
        summary = json.loads((work / "parity_summary.json").read_text())
        shutil.copy(work / "parity_summary.json", out / "parity_summary.json")
        shutil.copy(work / "PARITY_SUMMARY.md", out / "PARITY_SUMMARY.md")
        for tables in work.glob("*_level/tables"):
            shutil.copytree(tables, out / tables.parent.name / "tables", dirs_exist_ok=True)
        wall_total = time.perf_counter() - t0

    jax = json.loads(JAX_SUMMARY.read_text())
    rows, below = {}, []
    for mode in modes:
        for subject, ours in summary[mode]["per_subject"].items():
            theirs = jax[mode]["per_subject"][subject]
            row = rows.setdefault(subject, {})
            for k in KEYS[mode]:
                row[k] = {"port": ours[k], "jax": theirs[k], "gap": ours[k] - theirs[k]}
            auroc = KEYS[mode][0]
            if ours[auroc] < theirs[auroc] - GAP:
                below.append([subject, auroc, ours[auroc], theirs[auroc]])
    mean = {mode: {k: {"port": summary[mode][k], "jax": jax[mode][k]} for k in KEYS[mode]}
            for mode in modes}
    floors = {"image_auroc": chip_smoke.PARITY_IMAGE_AUROC_FLOOR,
              "pixel_auroc": chip_smoke.PARITY_PIXEL_AUROC_FLOOR}
    missed = [k for mode in modes for k in KEYS[mode][:1]
              if summary[mode][k] < floors[k]]
    rec = {"subjects": len(rows), "modes": modes, "mean": mean, "per_subject": rows,
           "below_jax_by_more_than": GAP, "below": below, "floors": floors,
           "missed_floors": missed, "launches": launches, "cli_wall_s": wall,
           "wall_s": wall_total, "jax_source": str(JAX_SUMMARY.relative_to(ROOT)),
           "card": chip_smoke.card_line()}
    (out / "parity_all.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
