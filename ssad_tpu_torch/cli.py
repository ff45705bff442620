"""Command line: ``python -m ssad_tpu_torch.cli train|sweep|train-multi|
import-ckpt|evaluate|infer|localize|export|serve|serve-bench|score|
evaluate-artifact|qa|parity|profile|doctor``.

Counterpart of ssad_tpu/cli.py (the serving subcommands live in
serving/cli.py, as in the JAX package).  Each takes the JAX command's
flags with ``--device`` in place of ``--platform``.  Checkpoints are
``<models-dir>/<subject>/best_model.ckpt`` (``train``, ``sweep``,
``train-multi``, ``import-ckpt``).

Multi-device (parallel/): ``train --data-shards N`` launches N local
ranks, one per device, that train one category data-parallel;
``train-multi`` trains categories in lockstep, over the ranks of this
host or, with ``--coordinator HOST:PORT --num-processes N --process-id
i``, of N processes (parallel/distributed.py gives the mapping);
``evaluate|infer --data-shards N`` split each scoring batch over N
devices, ``evaluate --category-shards N`` evaluates N categories at once.
More shards than devices, or both evaluate flags above 1, exit 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

from ssad_tpu_torch import constants
from ssad_tpu_torch.config import (
    DataConfig, EvalConfig, MeshConfig, ModelConfig, OptimConfig, TrainConfig,
)
from ssad_tpu_torch.parallel.mesh import ShardingError
from ssad_tpu_torch.serving import cli as serving_cli
from ssad_tpu_torch.utils.device import DeviceUnavailable

#: samples a QA grid is drawn from (the JAX command's batch)
QA_BATCH = 64
#: exit code of a training run drained by SIGTERM (EX_TEMPFAIL)
EXIT_PREEMPTED = 75


def _train_cfg(args, n_model: int = 1) -> TrainConfig:
    return TrainConfig(
        data=DataConfig(
            dataset_dir=args.dataset_dir, subject=args.subject,
            imsize=(args.imsize, args.imsize), batch_size=args.batch_size, seed=args.seed,
            patch_localization=args.patch_level, patch_size=args.patch_size,
            min_dataset_length=getattr(args, "min_dataset_length",
                                       DataConfig().min_dataset_length),
        ),
        model=ModelConfig(backbone=args.backbone, pretrained_backbone=args.pretrained_backbone),
        optim=OptimConfig(
            projection_epochs=args.projection_epochs, projection_lr=args.projection_lr,
            fine_tune_epochs=args.fine_tune_epochs, fine_tune_lr=args.fine_tune_lr,
        ),
        mesh=MeshConfig(data_axis=getattr(args, "data_shards", None) or -1, model_axis=n_model),
        outputs_dir=args.outputs_dir,
        seed=args.seed,
    )


def _write_artifacts(out: Path, cfg: TrainConfig, state_dict, bank, best_state_dict,
                     history) -> str:
    """A trained category's checkpoint (+ the best-val copy in
    logs/best_model_so_far.ckpt), the two history plots and history.json
    under ``out``; returns the checkpoint's path."""
    from ssad_tpu_torch.evaluation import visualization as vis
    from ssad_tpu_torch.train import checkpoint as ckpt

    path = ckpt.save_checkpoint(out, state_dict, bank, cfg)
    if best_state_dict is not None:
        ckpt.save_checkpoint(out / "logs", best_state_dict, None, cfg, name="best_model_so_far")
    for stage, mode in (("projection", "training"), ("fine_tune", "fine_tune")):
        vis.plot_history({k: v for k, v in history.items() if k.startswith(stage)}, out,
                         mode=mode)
    (out / "history.json").write_text(json.dumps(
        {k: [float(x) for x in v] for k, v in history.items()}, indent=1))
    return path


def _rank_args(args) -> argparse.Namespace:
    """``args`` without its command function, as a spawned rank takes it."""
    return argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "fn"})


def _drain_guard(guard):
    """The drain poll of a rank: every rank's SIGTERM flag OR-ed."""
    from ssad_tpu_torch.parallel import distributed as dist_mod

    return lambda: dist_mod.global_any(guard())


def cmd_train(args) -> int:
    """Train one category: <outputs-dir>/<subject>/best_model.ckpt (+ the
    best-val copy in logs/best_model_so_far.ckpt), the two history plots
    and history.json.  With --resume-dir, SIGTERM drains at the next epoch
    boundary, prints a JSON resume hint and exits 75.  With --data-shards
    N, N local ranks (one per device; NCCL on cards, gloo on the CPU)
    train the category data-parallel and rank 0 writes."""
    from ssad_tpu_torch.parallel import distributed as dist_mod
    from ssad_tpu_torch.parallel.mesh import local_devices
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    shards = getattr(args, "data_shards", None)
    if not shards:
        return _train(args, device)
    n_dev = len(local_devices(device.type))
    if shards > n_dev:
        raise ShardingError(f"--data-shards {shards} > {n_dev} available devices")
    coordinator = f"127.0.0.1:{dist_mod.free_port()}"
    return dist_mod.launch_local(_train_rank, shards, 0,
                                 (_rank_args(args), shards, coordinator))


def _train_rank(rank: int, args, world: int, coordinator: str) -> int:
    """Rank ``rank`` of ``train --data-shards``: its device, the process
    group, then the data-parallel fit."""
    import torch

    from ssad_tpu_torch.parallel import distributed as dist_mod
    from ssad_tpu_torch.train.trainer import DataGroup
    from ssad_tpu_torch.utils.device import resolve_device

    device = dist_mod.local_rank_device(resolve_device(args.device), rank)
    if device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    with dist_mod.process_group(coordinator, world, rank, device):
        return _train(args, device, DataGroup(None, rank, world))


def _train(args, device, data_group=None) -> int:
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.parallel import distributed as dist_mod
    from ssad_tpu_torch.train.trainer import GracefulPreemption, Trainer, TrainingPreempted

    cfg = _train_cfg(args)
    data = mvtec.prepare_pretext_data(
        cfg.data.dataset_dir, cfg.data.subject, imsize=cfg.data.imsize,
        val_fraction=cfg.data.train_val_split, seed=cfg.data.seed,
        patch_localization=cfg.data.patch_localization,
    )
    trainer = Trainer(cfg, data, device, data_group)
    writer = dist_mod.rank() == 0
    verbose = not args.quiet and writer
    if args.resume_dir is not None:
        try:
            with GracefulPreemption() as guard:
                result = trainer.fit(seed=cfg.seed, verbose=verbose,
                                     resume_dir=args.resume_dir, stop_requested=_drain_guard(guard))
        except TrainingPreempted as p:
            if writer:
                print(json.dumps({
                    "preempted": True, "subject": args.subject, "stage": p.stage,
                    "epochs_done": p.epoch + 1, "resume_dir": args.resume_dir,
                    "hint": "re-run the same command to continue",
                }), flush=True)
            return EXIT_PREEMPTED
    else:
        result = trainer.fit(seed=cfg.seed, verbose=verbose)
    if writer:
        path = _write_artifacts(Path(args.outputs_dir) / args.subject, cfg, result.state_dict,
                                result.bank, result.best_state_dict, result.history)
        print(f"checkpoint: {path}", flush=True)
    return 0


def cmd_sweep(args) -> int:
    """``train`` over --subjects in turn.  --skip-existing skips a subject
    whose <outputs-dir>/<subject>/best_model.ckpt exists; --resume-dir
    gives each subject <dir>/<subject> and arms the drain.  A SIGTERM
    between subjects exits 75 with the subjects left."""
    from ssad_tpu_torch.train.trainer import GracefulPreemption

    subjects = _subjects(args)
    base_resume = args.resume_dir
    with GracefulPreemption() as guard:
        for i, subject in enumerate(subjects):
            if guard():
                print(json.dumps({"preempted": True, "remaining": subjects[i:],
                                  "hint": "re-run with --skip-existing to continue"}),
                      flush=True)
                return EXIT_PREEMPTED
            if args.skip_existing and (Path(args.outputs_dir) / subject
                                       / "best_model.ckpt").exists():
                print(f"=== {subject}: checkpoint exists, skipping ===", flush=True)
                continue
            args.subject = subject
            if base_resume is not None:
                args.resume_dir = str(Path(base_resume) / subject)
            print(f"=== training {subject} ===", flush=True)
            rc = cmd_train(args)
            if rc:
                return rc
    return 0


def cmd_train_multi(args) -> int:
    """Train --subjects in lockstep chunks of --stack on a (model, data)
    grid of ranks (parallel/category_parallel.py).  Each process launches
    --local-devices ranks (default: one per card; one on the CPU); with
    --coordinator the N processes of --num-processes form one world, rank
    0 serving the store at HOST:PORT.  Process 0 writes every artifact;
    --resume-dir arms the coordinated drain (a SIGTERM to any process
    drains all at one persisted epoch boundary, exit 75)."""
    import torch

    from ssad_tpu_torch.parallel import distributed as dist_mod
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    n_local = args.local_devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit("--coordinator requires --num-processes and --process-id")
        world, first, coordinator = (args.num_processes * n_local, args.process_id * n_local,
                                     args.coordinator)
    else:
        world, first, coordinator = n_local, 0, f"127.0.0.1:{dist_mod.free_port()}"
    if world == 1:
        return _train_multi(args, device)
    return dist_mod.launch_local(_train_multi_rank, n_local, first,
                                 (_rank_args(args), world, coordinator, n_local))


def _train_multi_rank(rank: int, args, world: int, coordinator: str, n_local: int) -> int:
    import torch

    from ssad_tpu_torch.parallel import distributed as dist_mod
    from ssad_tpu_torch.utils.device import resolve_device

    device = dist_mod.local_rank_device(resolve_device(args.device), rank % n_local)
    if device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // n_local))
    with dist_mod.process_group(coordinator, world, rank, device):
        return _train_multi(args, device)


def _train_multi(args, device) -> int:
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.parallel import distributed as dist_mod
    from ssad_tpu_torch.parallel.category_parallel import fit_categories
    from ssad_tpu_torch.parallel.mesh import mesh_from_config, new_groups, world_size
    from ssad_tpu_torch.train.trainer import GracefulPreemption, TrainingPreempted

    subjects = _subjects(args)
    n_dev = world_size()
    if args.model_shards:
        n_model = args.model_shards
    else:
        # the largest divisor of the ranks ≤ the subject count that divides --stack
        n_model = max((d for d in range(1, n_dev + 1)
                       if not n_dev % d and d <= max(len(subjects), 1)
                       and (args.stack is None or args.stack % d == 0)), default=1)
    cfg = _train_cfg(argparse.Namespace(**{**vars(args), "subject": subjects[0]}), n_model)
    grid = mesh_from_config(cfg.mesh)
    groups = new_groups(grid)
    datas = [mvtec.prepare_pretext_data(args.dataset_dir, s, imsize=cfg.data.imsize,
                                        seed=args.seed, val_fraction=cfg.data.train_val_split,
                                        patch_localization=cfg.data.patch_localization)
             for s in subjects]
    writer = dist_mod.rank() == 0
    kw = dict(seed=args.seed, verbose=not args.quiet, stack_size=args.stack,
              resume_dir=args.resume_dir, device=device, groups=groups)
    failing = True
    try:
        if args.resume_dir is not None:
            try:
                with GracefulPreemption() as guard:
                    results = fit_categories(cfg, subjects, datas, grid,
                                             stop_requested=guard, **kw)
            except TrainingPreempted as p:
                if writer:
                    print(json.dumps({
                        "preempted": True, "stage": p.stage, "epochs_done": p.epoch + 1,
                        "resume_dir": args.resume_dir,
                        "hint": "re-run the same command on every host to continue",
                    }), flush=True)
                failing = False
                return EXIT_PREEMPTED
        else:
            results = fit_categories(cfg, subjects, datas, grid, **kw)
        if writer:
            for subject, r in results.items():
                # the saved config names this category: export and the
                # augmentation policy key on it
                sub_cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                            subject=subject))
                path = _write_artifacts(Path(args.outputs_dir) / subject, sub_cfg, r.state_dict,
                                        r.bank, r.best_state_dict, r.history)
                print(f"{subject}: {path}", flush=True)
        failing = False
        return 0
    finally:
        _train_multi_exit_barrier(failing)


def _train_multi_exit_barrier(failing: bool) -> None:
    """Hold every rank until process 0 has written its artifacts (a store
    rendezvous, no collective deadline).  After an error the peer that
    failed never arrives: wait 30 s only, and let the barrier's own error
    not mask the original one."""
    from ssad_tpu_torch.parallel import distributed as dist_mod

    try:
        dist_mod.barrier("train_multi_done", timeout_s=30.0 if failing else 1200.0)
    except Exception as e:
        if not failing:
            raise
        print(f"train-multi: exit barrier skipped after error: {e}", file=sys.stderr)


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


def _subjects(args):
    if args.subjects == "all":
        return list(constants.ALL_CATEGORIES)
    return [s.strip() for s in args.subjects.split(",") if s.strip()]


def cmd_evaluate(args) -> int:
    """Evaluate trained categories: per-category plots and the aggregate
    score tables under --outputs-dir; one line of scores per subject."""
    from ssad_tpu_torch.evaluation.evaluator import evaluate_categories

    cfg = EvalConfig(
        patch_localization=args.patch_level, patch_dim=args.patch_dim, stride=args.stride,
        imsize=(args.imsize, args.imsize), batch_size=args.batch_size, seed=args.seed,
        scorer=args.scorer, data_shards=args.data_shards,
        category_shards=args.category_shards, n_normality_images=args.n_normality_images,
        coreset=args.coreset, knn_k=args.knn_k,
        device_metrics=False if args.host_metrics else None,
    )
    # (a coreset with the Mahalanobis scorer gets its note from
    # attach_anomaly_scores, once per process)
    if args.coreset is not None and args.scorer == "knn" and args.knn_k > 1:
        print(f"note: --coreset with --knn-k {args.knn_k}: a maximin-spread bank makes the "
              "2nd/3rd neighbors far by construction, inflating normal scores — consider "
              "--knn-k 1", file=sys.stderr)
    results = evaluate_categories(args.dataset_dir, args.models_dir, _subjects(args), cfg,
                                  args.outputs_dir, device=args.device)
    for s, r in results.items():
        row = (f"pixel_auroc={r.pixel_auroc:.4f} iou={r.iou:.4f} aupro={r.aupro:.4f}"
               if args.patch_level else f"image_auroc={r.image_auroc:.4f} f1={r.image_f1:.4f}")
        print(f"{s}: {row}")
    return 0


def cmd_infer(args) -> int:
    """Reference tools.inference (tools.py:310-390): forward the MVTec
    test set (or synthetic pretext batches) with a trained checkpoint, fit
    the detector on normality, score; writes <outputs-dir>/<subject>/
    inference.npz (inference_artificial.npz) with anomaly, y_true, y_hat
    and threshold, and prints one JSON line."""
    import numpy as np

    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.data.synthetic import SynthSpec
    from ssad_tpu_torch.evaluation import inference as inf
    from ssad_tpu_torch.ops.patches import grid_side

    from ssad_tpu_torch.parallel.infer_parallel import maybe_shard_engine

    # the scorer flags are checked by EvalConfig
    EvalConfig(scorer=args.scorer, coreset=args.coreset, data_shards=args.data_shards)
    patch = args.patch_level
    if args.artificial and patch:
        raise SystemExit("--artificial and --patch-level are mutually exclusive")
    engine, bank, _ = inf.load_engine(
        Path(args.models_dir) / args.subject / "best_model.ckpt", args.device)
    engine = maybe_shard_engine(engine, args.data_shards)
    imsize = (args.imsize, args.imsize)
    data = mvtec.prepare_pretext_data(args.dataset_dir, args.subject, imsize=imsize)
    if args.artificial:
        outputs = inf.predict_artificial(
            engine, data, SynthSpec(subject=args.subject, imsize=imsize),
            num_samples=args.num_samples, batch_size=args.batch_size, seed=args.seed)
    else:
        test = mvtec.prepare_mvtec_test_data(args.dataset_dir, args.subject, imsize=imsize)
        outputs = inf.predict_mvtec(
            engine, test,
            # 841 windows an image in patch mode: the evaluator's cap
            batch_size=args.batch_size if not patch else max(1, min(8, args.batch_size)),
            patch_localization=patch, patch_dim=args.patch_dim, stride=args.stride)
    normality = inf.normality_embeddings(
        engine, None if patch else bank, data.train_images, patch_localization=patch,
        patch_dim=args.patch_dim, stride=args.stride, max_images=3 if patch else None,
        seed=args.seed)
    n_img = ppi = None
    if patch:
        ppi = grid_side(args.imsize, args.patch_dim, args.stride) ** 2
        n_img = outputs.embeddings.shape[0] // ppi
    outputs, detector = inf.attach_anomaly_scores(
        outputs, normality, patch_localization=patch, num_images=n_img, patches_per_image=ppi,
        k=args.knn_k, seed=args.seed, scorer=args.scorer, coreset=args.coreset)
    maps = outputs.anomaly_maps
    if patch:
        maps = inf.upsample(maps[:, 0], args.imsize)
    out = Path(args.outputs_dir) / args.subject
    out.mkdir(parents=True, exist_ok=True)
    path = out / ("inference_artificial.npz" if args.artificial else "inference.npz")
    host = outputs.to_host()
    np.savez_compressed(path, anomaly=maps.cpu().numpy(), y_true=host.y_true_binary,
                        y_hat=host.y_hat, threshold=detector.threshold)
    print(json.dumps({
        "subject": args.subject, "mode": "patch" if patch else "image",
        "n": int(host.y_hat.shape[0]), "threshold": float(detector.threshold),
        "outputs": str(path),
    }))
    return 0


def cmd_localize(args) -> int:
    """Localization panels of --num-images sampled test images of one
    subject under <outputs-dir>/<subject>/ (evaluation/localizer.py);
    prints their paths, one a line."""
    from ssad_tpu_torch.data import mvtec
    from ssad_tpu_torch.evaluation import inference as inf
    from ssad_tpu_torch.evaluation.localizer import Localizer

    cfg = EvalConfig(patch_localization=args.patch_level, patch_dim=args.patch_dim,
                     stride=args.stride, imsize=(args.imsize, args.imsize))
    engine, _, _ = inf.load_engine(
        Path(args.models_dir) / args.subject / "best_model.ckpt", args.device)
    data = mvtec.load_split(args.dataset_dir, args.subject, imsize=cfg.imsize)
    test = mvtec.prepare_mvtec_test_data(args.dataset_dir, args.subject, imsize=cfg.imsize)
    loc = Localizer(engine, cfg).setup(data)
    paths = loc.localize(test, str(Path(args.outputs_dir) / args.subject), args.num_images,
                         seed=args.seed)
    print("\n".join(paths))
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


def _backend_probe(device) -> str:
    """The doctor's device probe, run as ``python -c``: resolves ``device``
    as the entry points do, runs one op there and prints one JSON line."""
    root = str(Path(__file__).resolve().parent.parent)
    return (
        f"import json, sys; sys.path.insert(0, {root!r})\n"
        "import torch\n"
        "from ssad_tpu_torch.utils.device import resolve_device\n"
        f"dev = resolve_device({device!r})\n"
        "torch.ones(8, device=dev).sum().item()\n"
        "cuda = dev.type == 'cuda'\n"
        "print(json.dumps({'platform': dev.type,"
        " 'device_kind': torch.cuda.get_device_name(dev) if cuda else 'cpu',"
        " 'n_devices': torch.cuda.device_count() if cuda else 1}))\n"
    )


def cmd_doctor(args) -> int:
    """Environment self-check, printed as one JSON line; exit 0 iff the
    device was reached and the kernel build directory is writable.

    The device probe runs in a subprocess with a timeout, so a device
    that hangs on its first call cannot hang the doctor.  The build
    directory ``ssad_tpu_torch/_build/`` takes the place of the JAX
    package's compile cache: the CUDA kernels (with nvcc, whose path is
    reported) and the native libraries are compiled there at first use.
    ``native_loader.available`` says whether the threaded PNG/JPEG loader
    was built; without it data/mvtec.py decodes with PIL."""
    import subprocess

    import torch

    from ssad_tpu_torch import native
    from ssad_tpu_torch.ops import _cuda

    report = {"python": sys.version.split()[0], "torch": torch.__version__}
    try:
        out = subprocess.run(
            [sys.executable, "-c", _backend_probe(args.device)], capture_output=True,
            text=True, timeout=args.probe_timeout,
        )
        if out.returncode == 0:
            report["backend"] = json.loads(out.stdout.strip().splitlines()[-1])
        else:
            report["backend"] = {"error": (out.stderr or "").strip().splitlines()[-1:]}
    except subprocess.TimeoutExpired:
        report["backend"] = {
            "error": f"unreachable: the device probe hung >{args.probe_timeout}s"
        }

    cache = _cuda.BUILD_DIR
    try:
        nvcc = _cuda.nvcc_path()
    except _cuda.KernelBuildError:
        nvcc = None
    try:
        cache.mkdir(parents=True, exist_ok=True)
        probe_file = cache / f".doctor_probe.{os.getpid()}"
        probe_file.write_text("ok")
        probe_file.unlink()
        report["compile_cache"] = {"dir": str(cache), "writable": True, "nvcc": nvcc}
    except OSError as e:
        report["compile_cache"] = {"dir": str(cache), "writable": False, "nvcc": nvcc,
                                   "error": repr(e)}

    try:
        report["native_loader"] = {"available": bool(native.available())}
    except Exception as e:  # a broken build must not hide the rest of the report
        report["native_loader"] = {"available": False, "error": repr(e)}

    ok = (
        isinstance(report.get("backend"), dict)
        and "error" not in report["backend"]
        and report["compile_cache"]["writable"]
    )
    report["ok"] = bool(ok)
    print(json.dumps(report))
    return 0 if ok else 1


def cmd_profile(args) -> int:
    """Trace a hot program with torch.profiler into --profile-dir: the
    fine-tune train step with the bank fill (--what train), or patch
    scoring (--what patch: windows → fused stem → PeraNet → resident k-NN
    → blurred, upsampled maps, random weights and a seeded 1,000-row
    bank; timing does not depend on the weights).  One warm-up step
    outside the timer, then --steps steps; prints one JSON line with the
    trace directory, the StepTimer summary and the card's memory."""
    import numpy as np
    import torch

    from ssad_tpu_torch.utils import profiling
    from ssad_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _train_cfg(args)

    if args.what == "patch":
        from ssad_tpu_torch.evaluation.inference import InferenceEngine
        from ssad_tpu_torch.models.peranet import build_model, init_model

        h, _ = cfg.data.imsize
        bs = args.profile_batch
        model = init_model(build_model(cfg.model), torch.Generator().manual_seed(cfg.seed))
        engine = InferenceEngine(model, device)
        rng = np.random.default_rng(cfg.seed)
        bank = torch.from_numpy(rng.random((1000, 512), dtype=np.float32)).to(device)
        x = torch.from_numpy(rng.random((bs, h, h, 3), dtype=np.float32)).to(device)

        def run():
            return engine.score_patch_maps(x, bank, dim=args.patch_dim, stride=args.stride,
                                           upsample_to=h)

        profiling.block_until_ready(run())  # warm-up, outside the timer
        timer = profiling.StepTimer(items_per_step=bs)
        with profiling.trace(args.profile_dir):
            for _ in range(args.steps):
                timer.start()
                maps = run()
                timer.stop(sync=maps)
    else:
        from ssad_tpu_torch.data import mvtec
        from ssad_tpu_torch.train.trainer import Trainer, stage_generator

        data = mvtec.prepare_pretext_data(
            cfg.data.dataset_dir, cfg.data.subject, imsize=cfg.data.imsize,
            patch_localization=cfg.data.patch_localization,
        )
        trainer = Trainer(cfg, data, device)
        state = trainer.init_state("fine_tune", seed=cfg.seed)
        tr = trainer.device_data("train")
        gen = stage_generator(cfg.seed, 2)
        state, m = trainer.train_step(state, trainer.upload_draws(gen, tr), tr, True)
        profiling.block_until_ready(m["loss"])  # warm-up, outside the timer
        timer = profiling.StepTimer(items_per_step=cfg.data.batch_size)
        with profiling.trace(args.profile_dir):
            for _ in range(args.steps):
                timer.start()
                state, m = trainer.train_step(state, trainer.upload_draws(gen, tr), tr, True)
                timer.stop(sync=m["loss"])
    print(json.dumps({
        "trace_dir": args.profile_dir,
        **timer.summary(),
        "memory": profiling.device_memory_stats(),
    }))
    return 0


def cmd_parity(args) -> int:
    """End-to-end accuracy-parity run (ssad_tpu_torch/parity.py)."""
    from ssad_tpu_torch.parity import run_parity

    subjects = None
    if args.subjects and args.subjects != "default":
        subjects = _subjects(args)
    run_parity(
        dataset_dir=args.dataset_dir,
        outputs_dir=args.outputs_dir,
        subjects=subjects,
        imsize=args.imsize,
        batch_size=args.batch_size,
        projection_epochs=args.projection_epochs,
        fine_tune_epochs=args.fine_tune_epochs,
        pretrained_backbone=args.pretrained_backbone,
        backbone=args.backbone,
        patch_dim=args.patch_dim,
        stride=args.stride,
        modes=[m.strip() for m in args.modes.split(",") if m.strip()],
        seed=args.seed,
        verbose=not args.quiet,
        device=args.device,
    )
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
                   choices=["resnet18", "resnet34", "resnet50", "wide_resnet50_2"])
    t.add_argument("--pretrained-backbone", default=None,
                   help="path to a torchvision state_dict (.pth) of the --backbone "
                        "architecture")
    t.add_argument("--min-dataset-length", type=int, default=data_cfg.min_dataset_length,
                   help="duplicate the train file list up to this length per epoch "
                        "(reference datasets.py:410)")
    t.add_argument("--resume-dir", default=None,
                   help="write epoch-granular resume snapshots here and continue "
                        "from an existing one")
    t.add_argument("--data-shards", type=int, default=None,
                   help="train data-parallel on N local ranks, one per device "
                        "(single-category data parallelism)")
    t.add_argument("--quiet", action="store_true")
    serving_cli.add_device_flag(t)
    t.set_defaults(fn=cmd_train)

    def training_args(sp):
        sp.add_argument("--dataset-dir", required=True)
        sp.add_argument("--outputs-dir", default="outputs")
        sp.add_argument("--subjects", default="all")
        sp.add_argument("--imsize", type=int, default=data_cfg.imsize[0])
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--patch-level", action="store_true")
        sp.add_argument("--patch-size", type=int, default=data_cfg.patch_size)
        sp.add_argument("--batch-size", type=int, default=data_cfg.batch_size)
        sp.add_argument("--projection-epochs", type=int, default=optim_cfg.projection_epochs)
        sp.add_argument("--projection-lr", type=float, default=optim_cfg.projection_lr)
        sp.add_argument("--fine-tune-epochs", type=int, default=optim_cfg.fine_tune_epochs)
        sp.add_argument("--fine-tune-lr", type=float, default=optim_cfg.fine_tune_lr)
        sp.add_argument("--backbone", default="resnet18",
                        choices=["resnet18", "resnet34", "resnet50", "wide_resnet50_2"])
        sp.add_argument("--pretrained-backbone", default=None)
        sp.add_argument("--min-dataset-length", type=int, default=data_cfg.min_dataset_length,
                        help="duplicate the train file list up to this length per epoch "
                             "(reference datasets.py:410)")
        sp.add_argument("--quiet", action="store_true")
        serving_cli.add_device_flag(sp)

    s = sub.add_parser("sweep", help="train several categories, one after another")
    training_args(s)
    s.add_argument("--skip-existing", action="store_true",
                   help="skip subjects whose best_model.ckpt already exists (restartable "
                        "sweeps)")
    s.add_argument("--resume-dir", default=None,
                   help="base directory of per-subject resume snapshots (<dir>/<subject>); "
                        "also arms the SIGTERM drain")
    s.set_defaults(fn=cmd_sweep)

    tm = sub.add_parser("train-multi", help="train categories in lockstep on a (model, data) "
                                            "grid of ranks")
    training_args(tm)
    tm.add_argument("--model-shards", type=int, default=None,
                    help="the grid's model axis (default: the largest divisor of the ranks "
                         "not above the subject count)")
    tm.add_argument("--stack", type=int, default=None,
                    help="categories trained together per chunk (a multiple of "
                         "--model-shards; several can share one device)")
    tm.add_argument("--resume-dir", default=None,
                    help="per-group epoch-granular resume snapshots; also arms the "
                         "coordinated SIGTERM drain (a signal to any process drains all at "
                         "one persisted epoch boundary; exit 75)")
    tm.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="join a multi-process run: every process runs this command "
                         "against one address, where rank 0 serves the rendezvous store")
    tm.add_argument("--num-processes", type=int, default=None,
                    help="processes in the --coordinator run")
    tm.add_argument("--process-id", type=int, default=None,
                    help="this process's index (0-based; process 0 writes every artifact)")
    tm.add_argument("--local-devices", type=int, default=None,
                    help="ranks this process launches, one per device (default: one per "
                         "card; one on the CPU, where N gives N CPU ranks)")
    tm.set_defaults(fn=cmd_train_multi)

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

    eval_cfg = EvalConfig()

    def scoring_args(sp):
        sp.add_argument("--dataset-dir", required=True)
        sp.add_argument("--outputs-dir", default="outputs")
        sp.add_argument("--models-dir", required=True,
                        help="reads <models-dir>/<subject>/best_model.ckpt")
        sp.add_argument("--imsize", type=int, default=data_cfg.imsize[0])
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--patch-level", action="store_true")
        sp.add_argument("--patch-dim", type=int, default=eval_cfg.patch_dim)
        sp.add_argument("--patch-size", type=int, default=data_cfg.patch_size)
        sp.add_argument("--stride", type=int, default=eval_cfg.stride)
        sp.add_argument("--batch-size", type=int, default=data_cfg.batch_size)
        sp.add_argument("--knn-k", type=int, default=eval_cfg.knn_k,
                        help="k-NN neighbours for anomaly scoring (reference models.py:354)")
        sp.add_argument("--scorer", default="knn", choices=["knn", "mahalanobis"],
                        help="anomaly scorer: the reference's k-NN cosine detector or "
                             "a Gaussian scored by Mahalanobis distance")
        sp.add_argument("--coreset", type=int, default=None,
                        help="distil the k-NN bank to N rows by k-center-greedy coreset "
                             "selection after the 70/30 split (default: every row)")
        sp.add_argument("--data-shards", type=int, default=None,
                        help="split each scoring batch over the first N devices")
        serving_cli.add_device_flag(sp)

    e = sub.add_parser("evaluate", help="evaluate trained categories")
    scoring_args(e)
    e.add_argument("--subjects", default="all")
    e.add_argument("--category-shards", type=int, default=None,
                   help="evaluate N categories concurrently, one whole category per device "
                        "(no collectives; mutually exclusive with --data-shards)")
    e.add_argument("--n-normality-images", type=int, default=eval_cfg.n_normality_images,
                   help="patch mode: training images re-embedded for normality")
    e.add_argument("--host-metrics", action="store_true",
                   help="the host numpy metric oracles instead of the fused pixel-metrics "
                        "program (default: that program when the maps are on a card)")
    e.set_defaults(fn=cmd_evaluate)

    inf_p = sub.add_parser("infer", help="score a category with a trained model")
    scoring_args(inf_p)
    inf_p.add_argument("--subject", required=True)
    inf_p.add_argument("--artificial", action="store_true",
                       help="score synthetic pretext data instead of the MVTec test set")
    inf_p.add_argument("--num-samples", type=int, default=256)
    inf_p.set_defaults(fn=cmd_infer)

    lo = sub.add_parser("localize", help="qualitative localization panels")
    lo.add_argument("--dataset-dir", required=True)
    lo.add_argument("--outputs-dir", default="outputs")
    lo.add_argument("--models-dir", required=True,
                    help="reads <models-dir>/<subject>/best_model.ckpt")
    lo.add_argument("--subject", required=True)
    lo.add_argument("--imsize", type=int, default=data_cfg.imsize[0])
    lo.add_argument("--seed", type=int, default=0,
                    help="seed of the sampled test images")
    lo.add_argument("--patch-level", action="store_true")
    lo.add_argument("--patch-dim", type=int, default=eval_cfg.patch_dim)
    lo.add_argument("--patch-size", type=int, default=data_cfg.patch_size)
    lo.add_argument("--stride", type=int, default=eval_cfg.stride)
    lo.add_argument("--batch-size", type=int, default=data_cfg.batch_size)
    lo.add_argument("--num-images", type=int, default=5)
    serving_cli.add_device_flag(lo)
    lo.set_defaults(fn=cmd_localize)

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

    pr = sub.add_parser("profile", help="trace the fine-tune train step or patch scoring "
                                        "with torch.profiler")
    pr.add_argument("--dataset-dir", required=True)
    pr.add_argument("--outputs-dir", default="outputs")
    pr.add_argument("--subject", required=True)
    pr.add_argument("--imsize", type=int, default=data_cfg.imsize[0])
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--patch-level", action="store_true")
    pr.add_argument("--patch-dim", type=int, default=eval_cfg.patch_dim)
    pr.add_argument("--patch-size", type=int, default=data_cfg.patch_size)
    pr.add_argument("--stride", type=int, default=eval_cfg.stride)
    pr.add_argument("--batch-size", type=int, default=data_cfg.batch_size)
    pr.add_argument("--profile-dir", required=True)
    pr.add_argument("--steps", type=int, default=5)
    pr.add_argument("--what", default="train", choices=["train", "patch"],
                    help="program to trace: the fine-tune train step, or patch scoring "
                         "(random weights and bank at the served geometry)")
    pr.add_argument("--profile-batch", type=int, default=8, help="image batch for --what patch")
    pr.add_argument("--projection-epochs", type=int, default=10)
    pr.add_argument("--projection-lr", type=float, default=optim_cfg.projection_lr)
    pr.add_argument("--fine-tune-epochs", type=int, default=30)
    pr.add_argument("--fine-tune-lr", type=float, default=optim_cfg.fine_tune_lr)
    pr.add_argument("--backbone", default="resnet18",
                    choices=["resnet18", "resnet34", "resnet50", "wide_resnet50_2"])
    pr.add_argument("--pretrained-backbone", default=None)
    serving_cli.add_device_flag(pr)
    pr.set_defaults(fn=cmd_profile)

    dr = sub.add_parser("doctor", help="environment self-check (hang-proof device probe, "
                                       "kernel build directory, native loader); exit 0 "
                                       "iff healthy")
    dr.add_argument("--probe-timeout", type=float, default=60.0,
                    help="seconds before the device is declared unreachable")
    serving_cli.add_device_flag(dr)
    dr.set_defaults(fn=cmd_doctor)

    pa = sub.add_parser("parity", help="end-to-end accuracy-parity run (synthetic "
                                       "3-category dataset by default; --dataset-dir runs "
                                       "the real MVTec sweep)")
    pa.add_argument("--dataset-dir", default=None,
                    help="MVTec root; omit to generate the synthetic dataset")
    pa.add_argument("--outputs-dir", default="outputs/parity")
    pa.add_argument("--subjects", default="default",
                    help="'default' (synthetic trio or all 15), 'all', or a list")
    pa.add_argument("--imsize", type=int, default=256)
    pa.add_argument("--batch-size", type=int, default=96)
    pa.add_argument("--projection-epochs", type=int, default=5)
    pa.add_argument("--fine-tune-epochs", type=int, default=15)
    pa.add_argument("--pretrained-backbone", default=None)
    pa.add_argument("--backbone", default="resnet18",
                    choices=["resnet18", "resnet34", "resnet50", "wide_resnet50_2"])
    pa.add_argument("--patch-dim", type=int, default=32)
    pa.add_argument("--stride", type=int, default=8)
    pa.add_argument("--modes", default="image,patch")
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--quiet", action="store_true")
    serving_cli.add_device_flag(pa)
    pa.set_defaults(fn=cmd_parity)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (DeviceUnavailable, NotImplementedError, ShardingError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
