#!/usr/bin/env python3
"""The port's ``cli parity --subjects all`` on a card, beside the JAX runs.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_parity_all.py [--out chiprun_out/parity_all] [--modes image,patch]
    python3 scripts/torch_parity_all.py --seeds 0,1,2 [--modes image]

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

``--seeds`` varies training only.  ``cli parity --seed s`` without a
dataset also seeds the synthetic dataset, so a second seed would run on
another tree than the seed-0 one the JAX summary was measured on.  Here
the tree is written once, by the port's ``generate_parity_dataset`` at
seed 0 (byte for byte the JAX package's; its manifest must equal
``JAX_MANIFEST``), and each seed runs ``cli parity --dataset-dir <tree>
--subjects all --seed s``, where the seed reaches the trainer, the
train/validation split and the evaluation's draws only.  Per subject and
mode: each seed's value, their mean, min and max beside JAX's seed 0, and
``faults``: the subjects whose mean over the seeds is more than 0.05 below
JAX with every seed below it (ROADMAP's rule for a fault of the port).
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
#: the manifest of the tree behind JAX_SUMMARY: ``parity --subjects all`` at
#: its defaults writes it (``generate_parity_dataset``'s counts, seed 0)
JAX_MANIFEST = {"subjects": None, "imsize": 256, "n_train": 40, "n_test_good": 10,
                "n_test_defect": 10, "seed": 0}
GAP = 0.05
KEYS = {"image": ("image_auroc", "image_f1"), "patch": ("pixel_auroc", "iou", "aupro")}


def run_parity(work: Path, argv) -> tuple:
    """``cli parity --subjects all`` with ``argv`` into ``work`` under the
    default TF32 flags → (summary, launches, cli wall s)."""
    chip_smoke._zero_launches()
    with chip_smoke.torch_default_tf32():
        _, wall = chip_smoke._run_cli(["parity", "--subjects", "all", "--outputs-dir", str(work),
                                       "--quiet", *argv])
        launches = chip_smoke._eval_launches()
    return json.loads((work / "parity_summary.json").read_text()), launches, wall


def keep(work: Path, out: Path) -> None:
    """The summary and tables of a parity run under ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(work / "parity_summary.json", out / "parity_summary.json")
    shutil.copy(work / "PARITY_SUMMARY.md", out / "PARITY_SUMMARY.md")
    for tables in work.glob("*_level/tables"):
        shutil.copytree(tables, out / tables.parent.name / "tables", dirs_exist_ok=True)


def one_seed(summary: dict, jax: dict, modes, launches, wall, t0) -> dict:
    """One parity run's metrics beside JAX's, the subjects below it by more
    than GAP and the floors missed."""
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
    missed = [k for mode in modes for k in KEYS[mode][:1] if summary[mode][k] < floors[k]]
    return {"subjects": len(rows), "modes": modes, "mean": mean, "per_subject": rows,
            "below_jax_by_more_than": GAP, "below": below, "floors": floors,
            "missed_floors": missed, "launches": launches, "cli_wall_s": wall,
            "wall_s": time.perf_counter() - t0,
            "jax_source": str(JAX_SUMMARY.relative_to(ROOT)), "card": chip_smoke.card_line()}


def over_seeds(summaries: dict, jax: dict, modes) -> dict:
    """Per subject and metric: each seed's value, mean, min, max, JAX's
    seed 0; and the subjects meeting the fault rule on an AUROC."""
    per_subject, faults = {}, []
    first = summaries[min(summaries)]
    for mode in modes:
        for subject in first[mode]["per_subject"]:
            theirs = jax[mode]["per_subject"][subject]
            row = per_subject.setdefault(subject, {})
            for k in KEYS[mode]:
                vals = {s: summaries[s][mode]["per_subject"][subject][k] for s in summaries}
                mean = sum(vals.values()) / len(vals)
                row[k] = {"seeds": vals, "mean": mean, "min": min(vals.values()),
                          "max": max(vals.values()), "jax_seed_0": theirs[k],
                          "mean_gap": mean - theirs[k]}
            auroc = row[KEYS[mode][0]]
            if auroc["mean"] < auroc["jax_seed_0"] - GAP and auroc["max"] < auroc["jax_seed_0"]:
                faults.append([subject, KEYS[mode][0], auroc["mean"], auroc["jax_seed_0"]])
    mean = {mode: {k: {"seeds": {s: summaries[s][mode][k] for s in summaries},
                       "jax_seed_0": jax[mode][k]} for k in KEYS[mode]} for mode in modes}
    return {"per_subject": per_subject, "mean": mean, "faults": faults,
            "fault_rule": f"mean over seeds more than {GAP} below JAX, every seed below"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/parity_all")
    ap.add_argument("--modes", default="image,patch")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated training seeds on the seed-0 tree")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    modes = [m for m in args.modes.split(",") if m]
    jax = json.loads(JAX_SUMMARY.read_text())
    t0 = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        if args.seeds is None:
            work = Path(tmp) / "parity"
            summary, launches, wall = run_parity(work, ["--modes", args.modes])
            keep(work, out)
            rec = one_seed(summary, jax, modes, launches, wall, t0)
            (out / "parity_all.json").write_text(json.dumps(rec, indent=1))
            print(json.dumps(rec), flush=True)
            return 1 if rec["missed_floors"] else 0

        from ssad_tpu_torch import constants
        from ssad_tpu_torch.parity import generate_parity_dataset

        tree = Path(tmp) / "synthetic_dataset"
        subjects = list(constants.ALL_CATEGORIES)  # cli parity --subjects all
        generate_parity_dataset(tree, subjects, imsize=256, seed=0)
        manifest = json.loads((tree / "manifest.json").read_text())
        if manifest != {**JAX_MANIFEST, "subjects": sorted(subjects)}:
            chip_smoke.fail(f"the tree's manifest {manifest} is not JAX's {JAX_MANIFEST}")
        summaries, per_seed = {}, {}
        for seed in [int(s) for s in args.seeds.split(",")]:
            work = Path(tmp) / f"seed{seed}"
            summary, launches, wall = run_parity(
                work, ["--modes", args.modes, "--dataset-dir", str(tree), "--seed", str(seed)])
            keep(work, out / f"seed{seed}")
            summaries[seed] = summary
            per_seed[seed] = {"launches": launches, "cli_wall_s": wall}
            rec = one_seed(summary, jax, modes, launches, wall, t0)
            print(f"seed {seed}: {json.dumps(rec)}", flush=True)
    rec = {"seeds": sorted(summaries), "dataset_seed": 0, "modes": modes,
           **over_seeds(summaries, jax, modes), "runs": per_seed,
           "wall_s": time.perf_counter() - t0, "jax_source": str(JAX_SUMMARY.relative_to(ROOT)),
           "card": chip_smoke.card_line()}
    (out / "parity_seeds.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    floors = {"image": chip_smoke.PARITY_IMAGE_AUROC_FLOOR,
              "patch": chip_smoke.PARITY_PIXEL_AUROC_FLOOR}
    return 1 if any(v < floors[m] for m in modes
                    for v in rec["mean"][m][KEYS[m][0]]["seeds"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
