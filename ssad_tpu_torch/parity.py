"""Accuracy-parity harness: one command runs the whole pipeline.

Counterpart of ssad_tpu/parity.py.  ``python -m ssad_tpu_torch.cli
parity`` runs the reference workflow, train (two phases) → image-level
evaluation → patch-level train + evaluation at 32/stride 8, and writes
the table set of ``BASELINE.md`` (reference evaluator.py:432-564 writes
{image,patch}_{all,textures,objects}_scores.{csv,tex,md}) with a summary
JSON and Markdown.

Two operating modes, as in the JAX package:

* **synthetic** (default, no MVTec download needed): a 3-category
  dataset with the MVTec folder layout covering the three synthesis
  regimes, a texture (``carpet``), a fixed-pose object (``bottle``) and a
  non-fixed object (``hazelnut``, per-image masks), made by numpy and PIL
  byte for byte as the JAX package makes it from the same seed; trained
  at the reference configuration (256 px, batch 96) with scaled-down
  epochs and evaluated in both modes;
* **real**: ``--dataset-dir /path/to/mvtec`` (and optionally
  ``--pretrained-backbone resnet18.pth``) runs the 15-category sweep.

The port's checkpoints are ``<models>/<subject>/best_model.ckpt``
(train/checkpoint.py); a rerun skips the subjects that have one.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ssad_tpu_torch import constants
from ssad_tpu_torch.config import DataConfig, EvalConfig, ModelConfig, OptimConfig, TrainConfig
from ssad_tpu_torch.utils.device import resolve_device

SYNTHETIC_SUBJECTS = ("carpet", "bottle", "hazelnut")

#: reference 15-category numbers to compare against
#: (BASELINE.md; outputs/*/tables/markdown in the reference repo)
REFERENCE_IMAGE_AUROC = 0.9401
REFERENCE_PIXEL_AUROC = 0.9205
REFERENCE_AUPRO = 0.8012
REFERENCE_IOU = 0.5915


# --- synthetic dataset with the MVTec-AD layout ------------------------------


def _save_png(path: Path, arr: np.ndarray) -> None:
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def _texture_image(rng, size: int) -> np.ndarray:
    """Woven-looking texture: crossed gratings + correlated noise."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    p1, p2 = rng.uniform(6, 9), rng.uniform(11, 14)
    ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
    base = 0.5 + 0.12 * np.sin(xx / p1 + ph1) + 0.12 * np.sin(yy / p2 + ph2)
    noise = rng.normal(0, 0.03, (size, size))
    img = np.stack([base + noise] * 3, axis=-1)
    img[..., 0] *= 0.85  # greenish-brown carpet tint
    img[..., 2] *= 0.6
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _object_image(rng, size: int, fixed: bool) -> np.ndarray:
    """A disc object with a ring highlight; centered when fixed,
    randomly placed/rotated when not (non-fixed regime)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    if fixed:
        cy = cx = size / 2 + rng.uniform(-1, 1)
        r = size * 0.33
    else:
        cy = size / 2 + rng.uniform(-size * 0.12, size * 0.12)
        cx = size / 2 + rng.uniform(-size * 0.12, size * 0.12)
        r = size * rng.uniform(0.26, 0.33)
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    img = np.full((size, size, 3), 0.08, np.float32)
    img += rng.normal(0, 0.01, (size, size, 1))
    disc = d < r
    ring = (d > r * 0.55) & (d < r * 0.7)
    tint = np.array([0.55, 0.42, 0.3] if not fixed else [0.35, 0.45, 0.6])
    img[disc] = tint * (1.0 + rng.normal(0, 0.04))
    img[ring] = np.clip(img[ring] + 0.25, 0, 1)
    # surface grain so the pretext crops carry signal
    grain = rng.normal(0, 0.035, (size, size, 1))
    img = np.where(disc[..., None], img + grain, img)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _make_image(rng, subject: str, size: int) -> np.ndarray:
    if constants.is_texture(subject):
        return _texture_image(rng, size)
    return _object_image(rng, size, fixed=not constants.is_non_fixed_object(subject))


def _apply_defect(rng, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Paste a contrasting defect; returns (image, gt_mask)."""
    size = img.shape[0]
    out = img.copy()
    gt = np.zeros((size, size), np.uint8)
    kind = rng.integers(0, 3)
    cy = int(rng.uniform(0.3, 0.7) * size)
    cx = int(rng.uniform(0.3, 0.7) * size)
    if kind == 0:  # blob
        h_, w_ = int(size * rng.uniform(0.06, 0.12)), int(size * rng.uniform(0.06, 0.12))
        color = rng.integers(0, 255, 3)
        out[cy : cy + h_, cx : cx + w_] = color
        gt[cy : cy + h_, cx : cx + w_] = 255
    elif kind == 1:  # scratch line
        n = int(size * rng.uniform(0.15, 0.3))
        y, x = cy, cx
        for _ in range(n):
            y = int(np.clip(y + rng.integers(-1, 2), 1, size - 2))
            x = int(np.clip(x + 1, 1, size - 2))
            out[y - 1 : y + 2, x - 1 : x + 2] = 230
            gt[y - 1 : y + 2, x - 1 : x + 2] = 255
    else:  # dark ellipse
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        ry, rx = size * rng.uniform(0.04, 0.08), size * rng.uniform(0.04, 0.08)
        e = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        out[e] = (out[e] * 0.25).astype(np.uint8)
        gt[e] = 255
    return out, gt


def generate_parity_dataset(
    root: str | Path,
    subjects: Sequence[str] = SYNTHETIC_SUBJECTS,
    imsize: int = 256,
    n_train: int = 40,
    n_test_good: int = 10,
    n_test_defect: int = 10,
    seed: int = 0,
) -> Path:
    """Write a synthetic dataset tree with the MVTec-AD layout
    (<root>/<cat>/{train/good,test/good,test/defect,ground_truth/defect})."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    manifest = {
        "subjects": sorted(subjects), "imsize": imsize, "n_train": n_train,
        "n_test_good": n_test_good, "n_test_defect": n_test_defect, "seed": seed,
    }
    for subject in subjects:
        for i in range(n_train):
            _save_png(
                root / subject / "train" / "good" / f"{i:03d}.png",
                _make_image(rng, subject, imsize),
            )
        for i in range(n_test_good):
            _save_png(
                root / subject / "test" / "good" / f"{i:03d}.png",
                _make_image(rng, subject, imsize),
            )
        for i in range(n_test_defect):
            img, gt = _apply_defect(rng, _make_image(rng, subject, imsize))
            _save_png(root / subject / "test" / "defect" / f"{i:03d}.png", img)
            _save_png(
                root / subject / "ground_truth" / "defect" / f"{i:03d}_mask.png", gt
            )
    (root / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return root


# --- the end-to-end run -------------------------------------------------------


def _train_subject(cfg: TrainConfig, subject: str, models_dir: Path, verbose: bool,
                   device) -> None:
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.train import checkpoint as ckpt
    from ssad_tpu_torch.train.trainer import Trainer

    sub_cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, subject=subject))
    data = mvtec.prepare_pretext_data(
        sub_cfg.data.dataset_dir, subject, imsize=sub_cfg.data.imsize,
        val_fraction=sub_cfg.data.train_val_split, seed=sub_cfg.data.seed,
        patch_localization=sub_cfg.data.patch_localization,
    )
    result = Trainer(sub_cfg, data, device).fit(seed=sub_cfg.seed, verbose=verbose)
    ckpt.save_checkpoint(models_dir / subject, result.state_dict, result.bank, sub_cfg)


def run_parity(
    dataset_dir: Optional[str],
    outputs_dir: str,
    subjects: Optional[Sequence[str]] = None,
    imsize: int = 256,
    batch_size: int = 96,
    projection_epochs: int = 5,
    fine_tune_epochs: int = 15,
    pretrained_backbone: Optional[str] = None,
    backbone: str = "resnet18",
    patch_dim: int = 32,
    stride: int = 8,
    modes: Sequence[str] = ("image", "patch"),
    seed: int = 0,
    verbose: bool = True,
    device=None,
) -> Dict[str, Dict[str, object]]:
    """Train + evaluate every subject in both modes on ``device`` (default
    cuda); write the BASELINE table set under <outputs_dir>/{image,patch}_level
    and a summary JSON/Markdown beside the reference's numbers."""
    from ssad_tpu_torch.evaluation import evaluator
    from ssad_tpu_torch.train.checkpoint import CHECKPOINT_NAME

    device = resolve_device(device)
    out_root = Path(outputs_dir)
    if dataset_dir is None:
        subjects = list(subjects or SYNTHETIC_SUBJECTS)
        dataset_dir = str(out_root / "synthetic_dataset")
        manifest_path = Path(dataset_dir) / "manifest.json"
        reusable = False
        if manifest_path.exists():
            m = json.loads(manifest_path.read_text())
            reusable = (
                set(subjects) <= set(m.get("subjects", []))
                and m.get("imsize") == imsize and m.get("seed") == seed
            )
        if Path(dataset_dir).exists() and not reusable:
            raise SystemExit(
                f"{dataset_dir} exists but does not cover subjects="
                f"{subjects} at imsize={imsize} seed={seed}; use a fresh "
                "--outputs-dir or delete the stale synthetic_dataset"
            )
        if not reusable:
            if verbose:
                print(f"generating synthetic dataset → {dataset_dir}")
            generate_parity_dataset(dataset_dir, subjects, imsize=imsize, seed=seed)
    else:
        subjects = list(subjects or constants.ALL_CATEGORIES)

    summary: Dict[str, Dict[str, object]] = {}
    for mode in modes:
        patch = mode == "patch"
        cfg = TrainConfig(
            data=DataConfig(
                dataset_dir=str(dataset_dir), imsize=(imsize, imsize),
                batch_size=batch_size, seed=seed, patch_localization=patch,
            ),
            model=ModelConfig(backbone=backbone, pretrained_backbone=pretrained_backbone),
            optim=OptimConfig(
                projection_epochs=projection_epochs,
                fine_tune_epochs=fine_tune_epochs,
            ),
            outputs_dir=str(out_root), seed=seed,
        )
        mode_dir = out_root / f"{mode}_level"
        models_dir = mode_dir / "models"
        # existing checkpoints are reused only for the SAME run config;
        # otherwise a rerun with e.g. another backbone would publish
        # results for the wrong model
        fingerprint = {
            "backbone": backbone, "pretrained": bool(pretrained_backbone),
            "imsize": imsize, "batch_size": batch_size,
            "projection_epochs": projection_epochs,
            "fine_tune_epochs": fine_tune_epochs, "seed": seed, "mode": mode,
        }
        fp_path = models_dir / "parity_run.json"
        if fp_path.exists() and json.loads(fp_path.read_text()) != fingerprint:
            raise SystemExit(
                f"{models_dir} holds checkpoints from a different parity "
                f"config ({fp_path}); use a fresh --outputs-dir"
            )
        models_dir.mkdir(parents=True, exist_ok=True)
        fp_path.write_text(json.dumps(fingerprint, indent=2))
        for subject in subjects:
            if (models_dir / subject / f"{CHECKPOINT_NAME}.ckpt").exists():
                if verbose:
                    print(f"[parity/{mode}] {subject}: checkpoint exists, skipping train")
                continue
            if verbose:
                print(f"[parity/{mode}] training {subject}")
            _train_subject(cfg, subject, models_dir, verbose, device)

        ecfg = EvalConfig(
            patch_localization=patch, patch_dim=patch_dim, stride=stride,
            imsize=(imsize, imsize), seed=seed,
            upsample_size=imsize,
        )
        results = evaluator.evaluate_categories(
            str(dataset_dir), str(models_dir), subjects, ecfg, str(mode_dir), device=device
        )
        if patch:
            summary[mode] = {
                "pixel_auroc": float(np.mean([results[s].pixel_auroc for s in subjects])),
                "iou": float(np.mean([results[s].iou for s in subjects])),
                "aupro": float(np.mean([results[s].aupro for s in subjects])),
                "reference": {
                    "pixel_auroc": REFERENCE_PIXEL_AUROC,
                    "iou": REFERENCE_IOU,
                    "aupro": REFERENCE_AUPRO,
                },
                "per_subject": {
                    s: {
                        "pixel_auroc": results[s].pixel_auroc,
                        "iou": results[s].iou,
                        "aupro": results[s].aupro,
                    }
                    for s in subjects
                },
            }
        else:
            summary[mode] = {
                "image_auroc": float(np.mean([results[s].image_auroc for s in subjects])),
                "image_f1": float(np.mean([results[s].image_f1 for s in subjects])),
                "reference": {"image_auroc": REFERENCE_IMAGE_AUROC},
                "per_subject": {
                    s: {
                        "image_auroc": results[s].image_auroc,
                        "image_f1": results[s].image_f1,
                    }
                    for s in subjects
                },
            }

    # merge with an existing summary so refreshing ONE mode keeps the
    # other mode's rows, and refreshing a subject subset keeps the other
    # subjects' rows (per subject within a mode, means recomputed over
    # the merged rows); rows never rerun persist (PARITY.md)
    summary_path = out_root / "parity_summary.json"
    prior = {}
    if summary_path.exists():
        try:
            prior = json.loads(summary_path.read_text())
        except json.JSONDecodeError:
            prior = {}
    merged = merge_summaries(prior, summary)
    summary_path.write_text(json.dumps(merged, indent=2))
    all_subjects = sorted(
        set(subjects).union(
            *(m.get("per_subject", {}).keys() for m in merged.values()
              if isinstance(m, dict))
        )
    )
    _write_summary_md(out_root, merged, dataset_dir, all_subjects)
    if verbose:
        print(json.dumps(summary, indent=2))
    return summary


def merge_summaries(prior: dict, summary: dict) -> dict:
    """Merge a fresh parity summary into a previously published one.

    Modes present only in `prior` are kept verbatim (a single-mode
    rerun must not drop the other mode's published rows).  For modes
    present in BOTH, the merge is PER-SUBJECT: the fresh run's rows win
    for the subjects it covered, prior rows survive for the rest, and
    the mode-level means are recomputed over the merged rows — so a
    subject-subset rerun can no longer silently drop its siblings.
    Rows from modes/subjects never rerun persist indefinitely
    (staleness semantics in PARITY.md)."""
    merged = {k: dict(v) if isinstance(v, dict) else v for k, v in summary.items()}
    for mode_name, rows in prior.items():
        if mode_name not in merged:
            merged[mode_name] = rows
            continue
        prior_rows = rows.get("per_subject", {}) if isinstance(rows, dict) else {}
        new = merged[mode_name]
        combined = {**prior_rows, **new.get("per_subject", {})}
        new["per_subject"] = combined
        for metric in [k for k in new if k not in ("reference", "per_subject")]:
            vals = [v[metric] for v in combined.values() if metric in v]
            if vals:
                new[metric] = float(np.mean(vals))
    return merged


def _write_summary_md(out_root: Path, summary, dataset_dir, subjects) -> None:
    lines = [
        "# Parity run summary",
        "",
        f"dataset: `{dataset_dir}`  ·  subjects: {', '.join(subjects)}",
        "",
        "| mode | metric | this run | reference (15-cat MVTec) |",
        "|---|---|---|---|",
    ]
    for mode, vals in summary.items():
        ref = vals.get("reference", {})
        for k, v in vals.items():
            if k in ("reference", "per_subject"):
                continue
            r = ref.get(k, "—")
            r = f"{r:.4f}" if isinstance(r, float) else r
            lines.append(f"| {mode} | {k} | {v:.4f} | {r} |")
    lines += [
        "",
        "Reference numbers are the committed MVTec tables",
        "(BASELINE.md); synthetic-dataset runs validate the *pipeline*,",
        "not MVTec accuracy — swap in `--dataset-dir` + ",
        "`--pretrained-backbone` for the real 15-category sweep.",
    ]
    (out_root / "PARITY_SUMMARY.md").write_text("\n".join(lines) + "\n")
