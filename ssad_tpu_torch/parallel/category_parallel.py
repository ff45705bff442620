"""Category-parallel training (``train-multi``): C categories in lockstep.

Counterpart of ssad_tpu/parallel/category_parallel.py.  The JAX package
stacks C category models along a leading axis and vmaps one train step
over them, the stack sharded over the mesh's 'model' axis.  The vmap is
a TPU idiom; what it computes is each category's own ``Trainer`` step.
Here each category keeps its ``Trainer`` (train/trainer.py) and the C
steps run in lockstep, one after another, each on its own category's
draws; an epoch ends for all of them together, with a validation pass
each.  On a (model, data) grid of ranks (parallel/mesh.py) row i trains
positions [i·C/n_model, (i+1)·C/n_model) of every chunk, and the ranks
of a row train each of those categories data-parallel (its trainer's
``DataGroup``).  Categories never communicate.

The JAX policies are kept, each of which changes what a category learns:
subjects are grouped by synthesis flags and non-fixed objects go to the
single-category ``Trainer`` (``group_compatible_subjects``); the last
chunk of a group is padded with duplicates of its last category, with a
printed note; a group's image counts are cut to its smallest and it
shares its first category's cut pool (``stack_category_data``);
``steps_per_epoch`` comes from that common count; a validation pass every
epoch; best-validation copies at the fine-tune cadence; atomic resume
snapshots per group, a snapshot of another stack or backbone failing
loudly; a fresh optimizer and bank between the stages.

Deliberate difference: category p of a chunk draws from its own CPU
generators, ``category_generator(seed, stage, p)`` (JAX splits one key per
position, ``make_stacked_keys``).  Position 0 draws as the single-category
``Trainer`` does, so a one-category chunk trains that trainer's batches.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ssad_tpu_torch import constants
from ssad_tpu_torch.config import TrainConfig
from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.data.synthetic import PATCH_MODE_PRECROPS, SynthSpec
from ssad_tpu_torch.parallel import distributed as dist_mod
from ssad_tpu_torch.parallel.mesh import Groups, Mesh
from ssad_tpu_torch.train.memory_bank import MemoryBank
from ssad_tpu_torch.train.trainer import (
    DataGroup, Trainer, TrainingPreempted, _cpu_state_dict, _epoch_steps,
)

#: stage → its generator index (0 is the model's init)
STAGES = {"projection": 1, "fine_tune": 2}


class CategoryData(NamedTuple):
    """C categories' synthesizer inputs stacked on axis 0 (host arrays)."""

    images: np.ndarray  # (C, N, H, W, 3)
    cut_pool: np.ndarray  # (K, H, W, 3), shared
    masks: np.ndarray  # (C, H, W)
    coords: np.ndarray  # (C, H·W, 2)
    counts: np.ndarray  # (C,)


def stack_category_data(datas, split: str = "train") -> CategoryData:
    """Stack per-category PretextData: image counts cut to the smallest
    (sampling is with replacement, so this only narrows the variety), the
    first category's cut pool for all; ``split='val'`` stacks the
    held-out images (the train split where a category has none)."""
    if split == "train":
        per_cat = [d.train_images for d in datas]
    else:
        per_cat = [d.val_images if len(d.val_images) else d.train_images for d in datas]
    n = min(imgs.shape[0] for imgs in per_cat)
    return CategoryData(
        images=np.stack([imgs[:n] for imgs in per_cat]),
        cut_pool=np.asarray(datas[0].cut_pool),
        masks=np.stack([d.fixed_mask for d in datas]),
        coords=np.stack([d.fixed_coords for d in datas]),
        counts=np.asarray([d.fixed_count for d in datas], np.int32),
    )


def group_compatible_subjects(subjects, patch_localization: bool = False):
    """(groups sharing one set of synthesis flags, non-fixed subjects).

    Textures (random cut source, all-ones mask) and fixed-pose objects form
    a group each; in patch mode capsule and screw have their own pre-crops
    and form a group each.  Non-fixed objects need per-image masks, which
    the stacked layout does not carry: they go to the single-category
    ``Trainer``."""
    textures = [s for s in subjects if constants.is_texture(s)]
    non_fixed = [s for s in subjects if constants.is_non_fixed_object(s)]
    precrop = [s for s in subjects
               if patch_localization and s in PATCH_MODE_PRECROPS and s not in non_fixed]
    fixed = [s for s in subjects if s not in textures and s not in non_fixed and s not in precrop]
    groups = [g for g in ([textures, fixed] + [[s] for s in precrop]) if g]
    return groups, non_fixed


def category_generator(seed: int, stage: int, position: int) -> torch.Generator:
    """The CPU generator of chunk position ``position`` in ``stage`` (0
    init, 1 projection, 2 fine-tune); position 0's is the single-category
    Trainer's ``stage_generator(seed, stage)``."""
    key = [seed, stage] + ([position] if position else [])
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


class CategoryFitResult(NamedTuple):
    """One category's outcome: final weights and bank, per-epoch history,
    the best-validation copy (train/trainer.py ``TrainResult``)."""

    state_dict: Dict[str, torch.Tensor]
    bank: MemoryBank
    history: dict
    best_state_dict: Optional[Dict[str, torch.Tensor]] = None
    best_val_loss: float = float("inf")


def _group_snapshot_path(resume_dir, group) -> Path:
    return Path(resume_dir) / ("multi_" + "-".join(group)) / "resume_snapshot.pt"


def _save_group_snapshot(path: Path, payload: dict) -> None:
    """Atomic write of a group's snapshot (a .tmp file, then a rename)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


def _chunk_data(datas: List[mvtec.PretextData]) -> List[mvtec.PretextData]:
    """Each category's data as the stack trains it: the common image
    counts and the first category's cut pool."""
    train, val = stack_category_data(datas), stack_category_data(datas, split="val")
    return [dataclasses.replace(d, train_images=train.images[i], val_images=val.images[i],
                                cut_pool=train.cut_pool)
            for i, d in enumerate(datas)]


def stacked_step(trainers, states, generators, dds, fill: bool):
    """One lockstep step: each category's ``Trainer.train_step`` on its
    own draws → (states, metrics)."""
    out = [t.train_step(s, t.upload_draws(g, dd), dd, fill)
           for t, s, g, dd in zip(trainers, states, generators, dds)]
    return [o[0] for o in out], [o[1] for o in out]


def fit_categories(cfg: TrainConfig, subjects, datas, mesh: Mesh, seed: int = 0,
                   verbose: bool = True, stack_size: Optional[int] = None,
                   resume_dir: Optional[str] = None, stop_requested=None, device=None,
                   groups: Optional[Groups] = None) -> Dict[str, CategoryFitResult]:
    """Train ``subjects`` in chunks of ``stack_size`` (default: the mesh's
    model extent, of which it must be a multiple), with the two-phase
    schedule applied to every category.

    ``groups``: this rank's place in ``mesh`` and its process groups
    (parallel/mesh.py ``new_groups``; None: a world of one).
    ``stop_requested``: a zero-argument callable polled at each epoch
    boundary after the snapshot; the ranks' answers are OR-ed
    (``distributed.global_any``) so every rank raises ``TrainingPreempted``
    at the same boundary.  Process 0 writes the snapshots (``resume_dir``
    must be shared between hosts).

    Returns {subject: CategoryFitResult}, complete on rank 0 (other ranks
    hold their non-fixed subjects' results only)."""
    n_model = mesh.n_model
    stack = stack_size or n_model
    if stack % n_model:
        raise ValueError(f"stack_size={stack} not a multiple of model={n_model}")
    if groups is None:
        groups = Groups(mesh, 0, None, None)
    data_group = (DataGroup(groups.data, groups.data_index, mesh.n_data)
                  if groups.data is not None else None)
    per_rank = stack // n_model
    own = range(groups.model_index * per_rank, (groups.model_index + 1) * per_rank)
    writer = dist_mod.rank() == 0
    data_by_subject = dict(zip(subjects, datas))
    results: Dict[str, CategoryFitResult] = {}
    drain_check = None
    if stop_requested is not None:
        drain_check = lambda: dist_mod.global_any(stop_requested())  # noqa: E731

    spec_groups, non_fixed = group_compatible_subjects(subjects, cfg.data.patch_localization)
    for subject in non_fixed:
        # per-image object masks: the single-category Trainer, on every rank
        sub_cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, subject=subject))
        r = Trainer(sub_cfg, data_by_subject[subject], device).fit(
            seed=seed, verbose=verbose and writer,
            resume_dir=str(Path(resume_dir) / subject) if resume_dir else None,
            stop_requested=drain_check)
        results[subject] = CategoryFitResult(r.state_dict, r.bank, r.history,
                                             r.best_state_dict, r.best_val_loss)

    for group in (g[lo:lo + stack] for g in spec_groups for lo in range(0, len(g), stack)):
        chunk = [data_by_subject[s] for s in group]
        if len(chunk) < stack and verbose and writer:
            print(f"[{'+'.join(group)}] padding {len(chunk)}-category chunk to stack={stack} "
                  f"with duplicates ({stack - len(chunk)}/{stack} of this chunk's compute is "
                  "discarded)", flush=True)
        chunk += [chunk[-1]] * (stack - len(chunk))
        results.update(_fit_chunk(cfg, group, _chunk_data(chunk), own, data_group, seed,
                                  verbose and writer, stack, resume_dir, drain_check, device,
                                  writer))
    return results


def _fit_chunk(cfg, group, chunk, own, data_group, seed, verbose, stack, resume_dir,
               drain_check, device, writer) -> Dict[str, CategoryFitResult]:
    """Both stages of one chunk; this rank trains the positions ``own``."""
    spec = SynthSpec(subject=group[0], imsize=cfg.data.imsize,
                     patch_localization=cfg.data.patch_localization,
                     patch_size=cfg.data.patch_size, aug=cfg.aug)
    names = [group[min(p, len(group) - 1)] for p in range(stack)]
    trainers = {}
    for p in own:
        sub_cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, subject=names[p]))
        trainers[p] = Trainer(sub_cfg, chunk[p], device, data_group)
        trainers[p].spec = spec  # the group's flags, as the JAX stack compiles one branch
    histories = {s: {} for s in group}
    best = {p: {"loss": float("inf"), "state_dict": None} for p in own}

    resume, snap_path = None, None
    if resume_dir is not None:
        snap_path = _group_snapshot_path(resume_dir, group)
        if snap_path.exists():
            resume = torch.load(snap_path, map_location="cpu", weights_only=True)
            if (resume.get("stack") not in (None, stack)
                    or resume.get("backbone") not in (None, cfg.model.backbone)):
                raise SystemExit(
                    f"{snap_path}: snapshot was written with stack={resume.get('stack')}, "
                    f"backbone={resume.get('backbone')!r} but this run uses stack={stack}, "
                    f"backbone={cfg.model.backbone!r} — rerun with the original settings or "
                    "delete the snapshot")
            histories = resume["histories"]
            best = {p: resume["categories"][p]["best"] for p in own}

    states, gens = {}, {}
    for p, t in trainers.items():
        states[p] = t.init_state("projection", generator=category_generator(seed, 0, p))

    def restore(stage):
        for p, t in trainers.items():
            snap = resume["categories"][p]
            t.model.load_state_dict(snap["model"], strict=True)
            st = t.make_state(stage)
            st.optimizer.load_state_dict(snap["optimizer"])
            st.bank = MemoryBank(*(snap["bank"][k].to(t.device)
                                   for k in ("data", "cursor", "count")))
            states[p] = st
            gens[p] = torch.Generator()
            gens[p].set_state(snap["generator"])
        return resume["epoch"]

    for stage, epochs in (("projection", cfg.optim.projection_epochs),
                          ("fine_tune", cfg.optim.fine_tune_epochs)):
        start = 0
        if resume is not None and resume["stage"] == stage:
            start, resume = restore(stage), None
        elif resume is not None:  # the snapshot is past the projection stage
            continue
        else:
            for p, t in trainers.items():
                if stage == "fine_tune":  # parameters carried; fresh optimizer and bank
                    states[p] = t.make_state(stage)
                gens[p] = category_generator(seed, STAGES[stage], p)
        for epoch in range(start, epochs):
            _run_epoch(cfg, group, names, trainers, states, gens, histories, best, stage,
                       epoch, epochs, verbose, stack)
            if snap_path is not None:
                parts = dist_mod.to_host(
                    {p: {"model": _cpu_state_dict(states[p].model),
                         "optimizer": states[p].optimizer.state_dict(),
                         "bank": {k: getattr(states[p].bank, k).cpu()
                                  for k in ("data", "cursor", "count")},
                         "generator": gens[p].get_state(), "best": best[p]}
                     for p in trainers} if data_group is None or data_group.index == 0
                    else {}, everywhere=False)
                if writer:
                    cats = {p: c for part in parts for p, c in part.items()}
                    _save_group_snapshot(snap_path, {
                        "stage": stage, "epoch": epoch + 1, "categories": cats,
                        "histories": histories, "stack": stack,
                        "backbone": cfg.model.backbone})
            # drain after the snapshot: the boundary resumed from is the one
            # that just persisted; the consensus keeps every rank on one branch
            if drain_check is not None and epoch < epochs - 1 and drain_check():
                raise TrainingPreempted(stage, epoch)

    mine = {p: CategoryFitResult(_cpu_state_dict(states[p].model),
                                 MemoryBank(*(getattr(states[p].bank, k).cpu()
                                              for k in ("data", "cursor", "count"))),
                                 {}, best[p]["state_dict"], best[p]["loss"])
            for p in trainers if p < len(group)}
    parts = dist_mod.to_host(mine if data_group is None or data_group.index == 0 else {},
                             everywhere=False)
    if parts is None:
        return {}
    out = {}
    for part in parts:
        for p, r in part.items():
            out[group[p]] = r._replace(history=histories[group[p]])
    return out


def _run_epoch(cfg, group, names, trainers, states, gens, histories, best, stage, epoch,
               epochs, verbose, stack) -> None:
    """One lockstep epoch of this rank's categories and their validation;
    every rank's numbers go into every rank's histories."""
    fill = epoch > epochs // 2  # models.py:270
    tr = {p: t.device_data("train") for p, t in trainers.items()}
    va = {p: t.device_data("val") for p, t in trainers.items()}
    order = list(trainers)
    steps = trainers[order[0]].steps_per_epoch if order else 0
    losses = {p: [] for p in order}
    accs = {p: [] for p in order}
    t0 = time.perf_counter()
    for _ in range(steps):
        new, metrics = stacked_step([trainers[p] for p in order], [states[p] for p in order],
                                    [gens[p] for p in order], [tr[p] for p in order], fill)
        for p, s, m in zip(order, new, metrics):
            states[p] = s
            losses[p].append(m["loss"])
            accs[p].append(m["accuracy"])
    rows = {}
    for p in order:
        rows[p] = [float(torch.stack(losses[p]).mean()), float(torch.stack(accs[p]).mean())]
    dt = time.perf_counter() - t0
    ips = steps * cfg.data.batch_size / max(dt, 1e-9)  # per category
    for p, t in trainers.items():
        val_steps = max(_epoch_steps(max(va[p].images.shape[0], 1), cfg.data.min_dataset_length,
                                     cfg.data.batch_size), 1)
        if cfg.optim.val_batches is not None:
            val_steps = min(val_steps, cfg.optim.val_batches)
        val = [t.eval_step(states[p].model, t.upload_draws(gens[p], va[p]), va[p])
               for _ in range(val_steps)]
        rows[p] += [float(torch.stack([v["loss"] for v in val]).mean()),
                    float(torch.stack([v["accuracy"] for v in val]).mean()), ips]
        if (stage == "fine_tune" and (epoch + 1) % cfg.optim.checkpoint_every_n_epochs == 0
                and rows[p][2] < best[p]["loss"]):
            best[p] = {"loss": rows[p][2], "state_dict": _cpu_state_dict(states[p].model)}
    every = {p: r for part in dist_mod.to_host(rows) for p, r in part.items()}
    for p, subject in enumerate(group):
        h = histories[subject]
        loss, acc, val_loss, val_acc, cat_ips = every[p]
        h.setdefault(f"{stage}_train_loss", []).append(loss)
        h.setdefault(f"{stage}_train_accuracy", []).append(acc)
        h.setdefault(f"{stage}_val_loss", []).append(val_loss)
        h.setdefault(f"{stage}_val_accuracy", []).append(val_acc)
        h.setdefault(f"{stage}_images_per_sec", []).append(cat_ips)
    if verbose:
        m = [every[p] for p in range(stack)]
        total = sum(r[4] for r in m)
        print(f"[{'+'.join(group)}/{stage}] epoch {epoch + 1}/{epochs} "
              f"loss {np.round([r[0] for r in m], 3).tolist()} "
              f"val_loss {np.round([r[2] for r in m], 3).tolist()} "
              f"({total:,.0f} img/s across {stack} categories)", flush=True)
