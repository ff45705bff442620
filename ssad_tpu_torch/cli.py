"""Command line: ``python -m ssad_tpu_torch.cli
train|import-ckpt|export|serve|score|qa``.

Counterpart of ssad_tpu/cli.py for the commands ported so far (the
serving subcommands live in serving/cli.py, as in the JAX package).
``train`` takes the JAX command's flags with ``--device`` in place of
``--platform``; ``--data-shards`` (multi-device) is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from ssad_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, TrainConfig
from ssad_tpu_torch.serving import cli as serving_cli
from ssad_tpu_torch.utils.device import DeviceUnavailable

#: samples a QA grid is drawn from (the JAX command's batch)
QA_BATCH = 64
#: exit code of a training run drained by SIGTERM (EX_TEMPFAIL)
EXIT_PREEMPTED = 75


def _train_cfg(args) -> TrainConfig:
    return TrainConfig(
        data=DataConfig(
            dataset_dir=args.dataset_dir, subject=args.subject,
            imsize=(args.imsize, args.imsize), batch_size=args.batch_size, seed=args.seed,
            patch_localization=args.patch_level, patch_size=args.patch_size,
            min_dataset_length=args.min_dataset_length,
        ),
        model=ModelConfig(backbone=args.backbone, pretrained_backbone=args.pretrained_backbone),
        optim=OptimConfig(
            projection_epochs=args.projection_epochs, projection_lr=args.projection_lr,
            fine_tune_epochs=args.fine_tune_epochs, fine_tune_lr=args.fine_tune_lr,
        ),
        outputs_dir=args.outputs_dir,
        seed=args.seed,
    )


def cmd_train(args) -> int:
    """Train one category: <outputs-dir>/<subject>/best_model.ckpt (+ the
    best-val copy in logs/best_model_so_far.ckpt), the two history plots
    and history.json.  With --resume-dir, SIGTERM drains at the next epoch
    boundary, prints a JSON resume hint and exits 75."""
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.evaluation import visualization as vis
    from ssad_tpu_torch.train import checkpoint as ckpt
    from ssad_tpu_torch.train.trainer import GracefulPreemption, Trainer, TrainingPreempted
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _train_cfg(args)
    data = mvtec.prepare_pretext_data(
        cfg.data.dataset_dir, cfg.data.subject, imsize=cfg.data.imsize,
        val_fraction=cfg.data.train_val_split, seed=cfg.data.seed,
        patch_localization=cfg.data.patch_localization,
    )
    trainer = Trainer(cfg, data, device)
    if args.resume_dir is not None:
        try:
            with GracefulPreemption() as guard:
                result = trainer.fit(seed=cfg.seed, verbose=not args.quiet,
                                     resume_dir=args.resume_dir, stop_requested=guard)
        except TrainingPreempted as p:
            print(json.dumps({
                "preempted": True, "subject": args.subject, "stage": p.stage,
                "epochs_done": p.epoch + 1, "resume_dir": args.resume_dir,
                "hint": "re-run the same command to continue",
            }), flush=True)
            return EXIT_PREEMPTED
    else:
        result = trainer.fit(seed=cfg.seed, verbose=not args.quiet)
    out = Path(args.outputs_dir) / args.subject
    path = ckpt.save_checkpoint(out, result.state_dict, result.bank, cfg)
    if result.best_state_dict is not None:
        ckpt.save_checkpoint(out / "logs", result.best_state_dict, None, cfg,
                             name="best_model_so_far")
    for stage, mode in (("projection", "training"), ("fine_tune", "fine_tune")):
        vis.plot_history({k: v for k, v in result.history.items() if k.startswith(stage)},
                         out, mode=mode)
    (out / "history.json").write_text(json.dumps(
        {k: [float(x) for x in v] for k, v in result.history.items()}, indent=1))
    print(f"checkpoint: {path}", flush=True)
    return 0


def cmd_import_ckpt(args) -> int:
    """A reference Lightning ``best_model.ckpt`` → the port's checkpoint
    <models-dir>/<subject>/best_model.ckpt, with a TrainConfig carrying
    the subject and imsize (host work only)."""
    from ssad_tpu_torch.train.checkpoint import save_checkpoint
    from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

    state_dict, bank, mcfg, _ = load_checkpoint(args.ckpt, allow_pickle=args.allow_pickle)
    cfg = TrainConfig(data=DataConfig(subject=args.subject, imsize=(args.imsize, args.imsize)),
                      model=mcfg)
    path = save_checkpoint(Path(args.models_dir) / args.subject, state_dict, bank, cfg)
    print(json.dumps({
        "subject": args.subject, "checkpoint": path,
        "bank_rows": int(bank.count) if bank is not None else 0,
        "model": dataclasses.asdict(mcfg),
    }))
    return 0


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
    data_cfg, optim_cfg = DataConfig(), OptimConfig()

    t = sub.add_parser("train", help="train one category")
    t.add_argument("--dataset-dir", required=True)
    t.add_argument("--subject", required=True)
    t.add_argument("--outputs-dir", default="outputs")
    t.add_argument("--imsize", type=int, default=data_cfg.imsize[0])
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--patch-level", action="store_true")
    t.add_argument("--patch-size", type=int, default=data_cfg.patch_size)
    t.add_argument("--batch-size", type=int, default=data_cfg.batch_size)
    t.add_argument("--projection-epochs", type=int, default=optim_cfg.projection_epochs)
    t.add_argument("--projection-lr", type=float, default=optim_cfg.projection_lr)
    t.add_argument("--fine-tune-epochs", type=int, default=optim_cfg.fine_tune_epochs)
    t.add_argument("--fine-tune-lr", type=float, default=optim_cfg.fine_tune_lr)
    t.add_argument("--backbone", default="resnet18",
                   choices=["resnet18", "resnet34", "resnet50", "wide_resnet50_2"],
                   help="resnet18 only is ported; the others raise")
    t.add_argument("--pretrained-backbone", default=None,
                   help="path to a torchvision resnet18 state_dict (.pth)")
    t.add_argument("--min-dataset-length", type=int, default=data_cfg.min_dataset_length,
                   help="duplicate the train file list up to this length per epoch "
                        "(reference datasets.py:410)")
    t.add_argument("--resume-dir", default=None,
                   help="write epoch-granular resume snapshots here and continue "
                        "from an existing one")
    t.add_argument("--quiet", action="store_true")
    serving_cli.add_device_flag(t)
    t.set_defaults(fn=cmd_train)

    ic = sub.add_parser("import-ckpt",
                        help="import a reference Lightning checkpoint as the port's checkpoint")
    ic.add_argument("--ckpt", required=True, help="path to the reference best_model.ckpt")
    ic.add_argument("--models-dir", required=True,
                    help="writes <models-dir>/<subject>/best_model.ckpt")
    ic.add_argument("--subject", required=True)
    ic.add_argument("--imsize", type=int, default=data_cfg.imsize[0])
    ic.add_argument("--allow-pickle", action="store_true",
                    help="permit full unpickling when the safe loader rejects the file "
                         "(trusted checkpoints only)")
    ic.set_defaults(fn=cmd_import_ckpt)

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
