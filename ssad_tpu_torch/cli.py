"""Command line: ``python -m ssad_tpu_torch.cli export|serve|score|qa``.

Counterpart of ssad_tpu/cli.py for the commands ported so far (the
serving subcommands live in serving/cli.py, as in the JAX package).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ssad_tpu_torch.config import DataConfig
from ssad_tpu_torch.serving import cli as serving_cli
from ssad_tpu_torch.utils.device import DeviceUnavailable

#: samples a QA grid is drawn from (the JAX command's batch)
QA_BATCH = 64


def cmd_qa(args) -> int:
    """Render the augmentation visual-QA grid of one subject (reference
    test_artificial_transformations.py:226-435): one batch of synthetic
    samples with the subject's fixed mask, up to GRID_COLUMNS per pretext class."""
    import numpy as np
    import torch

    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.data.synthetic import SynthSpec, draw, synthesize
    from ssad_tpu_torch.evaluation import visualization as vis
    from ssad_tpu_torch.ops import image as im
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    imsize = (args.imsize, args.imsize)
    data = mvtec.prepare_pretext_data(args.dataset_dir, args.subject, imsize=imsize)
    spec = SynthSpec(subject=args.subject, imsize=imsize,
                     patch_localization=args.patch_level, patch_size=args.patch_size)
    idx = np.random.default_rng(args.seed).integers(0, data.train_images.shape[0], QA_BATCH)
    draws = draw(spec, QA_BATCH, torch.Generator().manual_seed(args.seed),
                 n_cut=data.cut_pool.shape[0]).to(device)
    x, y, _ = synthesize(
        spec, draws, torch.from_numpy(data.train_images[idx]).to(device),
        torch.from_numpy(data.cut_pool).to(device), torch.from_numpy(data.fixed_mask).to(device),
        torch.from_numpy(data.fixed_coords).to(device),
        torch.tensor(data.fixed_count, device=device),
    )
    x = im.denormalize_imagenet(x).clamp(0.0, 1.0).cpu().numpy()
    y = y.cpu().numpy()
    groups = {lbl: [x[i] for i in np.flatnonzero(y == lbl)] for lbl in range(4)}
    out = vis.augmentation_grid(groups, Path(args.outputs_dir) / args.subject / "dataset_analysis",
                                f"{args.subject}_augmentations.png")
    print(json.dumps({"grid": out, "label_counts": np.bincount(y, minlength=4).tolist()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ssad_tpu_torch",
        description="self-supervised anomaly detection, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="command", required=True)
    serving_cli.register(sub)

    q = sub.add_parser("qa", help="augmentation visual-QA grid")
    q.add_argument("--dataset-dir", required=True)
    q.add_argument("--subject", required=True)
    q.add_argument("--outputs-dir", default="outputs")
    q.add_argument("--imsize", type=int, default=DataConfig().imsize[0])
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--patch-level", action="store_true")
    q.add_argument("--patch-size", type=int, default=DataConfig().patch_size)
    serving_cli.add_device_flag(q)
    q.set_defaults(fn=cmd_qa)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except DeviceUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
