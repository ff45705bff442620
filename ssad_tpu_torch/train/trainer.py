"""Two-phase PeraNet training on one device.

Counterpart of ssad_tpu/train/trainer.py (reference tools.py:204-306):
phase 1 'projection' trains the head on a frozen backbone at a constant
lr; phase 2 'fine_tune' trains everything under the per-step cosine
schedule, keeping a copy of the best-val-loss weights every
``checkpoint_every_n_epochs`` epochs; in the second half of each phase's
epochs (epoch > epochs // 2, 0-based) the memory bank takes eval-mode
embeddings of the clean originals of the samples with y == 0 ∧ ŷ == 0
(models.py:270-275).

A step: the batch's indices and synthesis draws are made on the host from
the stage's CPU ``torch.Generator`` and uploaded (``upload_draws``); the
batch is synthesized on the device from inputs uploaded once per stage
(``device_data``); forward, softmax cross-entropy, backward, SGD; then,
in a fill epoch, the bank fill with the UPDATED weights and statistics.
Per-step metrics stay on the device and are read once per epoch; the step
itself never reads the device from the host.

Data parallelism (``train --data-shards N``; JAX: a 'data' mesh axis and
a sharding constraint on the synthesized batch): one rank per device, the
trainer given its ``DataGroup``.  JAX writes global-view code, so its
sharded step is the single-device step, and so is this one.  Every rank
draws the whole batch from the same generator and synthesizes it, then
keeps its slice of the rows; the BatchNorm statistics are the whole
batch's (models/resnet.py ``sync_batch_stats``), the gradients are
all-reduced to the global mean, and the bank fill sees the whole batch
(the logits gathered in rank order; every rank embeds the accepted
originals itself, so the banks stay equal).  A plain per-rank BatchNorm
(DDP's) would compute another function.

Deliberate differences from the JAX package:
* the stage generators are CPU ``torch.Generator``s, so the same seed
  trains on other batches than the JAX package's ``jax.random`` keys do
  (the policies are the same: data/synthetic.py);
* the checkpoint is the reference layout plus the TrainConfig
  (train/checkpoint.py), not an Orbax directory;
* the step runs eagerly, op by op, not as one compiled program.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ssad_tpu_torch.config import TrainConfig
from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.data.synthetic import SynthSpec, draw, synthesize
from ssad_tpu_torch.models.peranet import PeraNet, build_model, init_model, require_cnn
from ssad_tpu_torch.models.resnet import sync_batch_stats
from ssad_tpu_torch.ops.image import normalize_imagenet
from ssad_tpu_torch.train.memory_bank import MemoryBank, init_bank, insert
from ssad_tpu_torch.train.optim import StageOptimizer
from ssad_tpu_torch.utils.device import resolve_device
from ssad_tpu_torch.utils.profiling import span

#: the step's spans (utils/profiling.span), in the order it runs them
STEP_GROUPS = ("ssad.train.synthesis", "ssad.train.forward", "ssad.train.backward",
               "ssad.train.optimizer", "ssad.train.bank_fill")


def bank_fill_embeddings(model: PeraNet, originals: torch.Tensor) -> torch.Tensor:
    """Eval-mode f32 embeddings of the clean, ImageNet-normalised originals
    (B, H, W, 3), without gradients; the model's mode is restored after.

    Train-mode embeddings of augmented samples live in another space than
    inference-time queries and score at chance (ssad_tpu/train/trainer.py
    :40-62)."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(normalize_imagenet(originals))["latent_space"].float()
    finally:
        model.train(was_training)


def bank_fill_subset(bank_fill_rows: Optional[int], y: torch.Tensor, y_hat: torch.Tensor,
                     orig: torch.Tensor):
    """(originals, accept mask) of the first ``bank_fill_rows`` rows (all
    when None): a row is accepted when y == 0 ∧ ŷ == 0."""
    rows = orig.shape[0] if bank_fill_rows is None else min(bank_fill_rows, orig.shape[0])
    return orig[:rows], (y[:rows] == 0) & (y_hat[:rows] == 0)


class TrainingPreempted(Exception):
    """Raised at an epoch boundary after a drain signal arrived; the resume
    snapshot of exactly that boundary has been written."""

    def __init__(self, stage: str, epoch: int):
        super().__init__(f"preempted after {stage} epoch {epoch + 1}")
        self.stage = stage
        self.epoch = epoch


class GracefulPreemption:
    """SIGTERM-aware drain: inside the block a SIGTERM only sets a flag;
    the trainer finishes the epoch, writes its snapshot and raises
    :class:`TrainingPreempted` (the CLI exits 75 with a resume hint).  The
    previous handler is restored on exit.  Callable: True once a drain
    was requested."""

    def __init__(self):
        self.requested = False
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            self.requested = True

        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def __exit__(self, *exc):
        signal.signal(signal.SIGTERM, self._prev)
        return False

    def __call__(self) -> bool:
        return self.requested


@dataclasses.dataclass
class DataGroup:
    """The ranks that train one category's batch together: ``group`` (a
    process group; None: the whole world), this rank's ``index`` in it
    and its ``size``.  Rank i keeps rows [i·b/size, (i+1)·b/size)."""

    group: Optional[object]
    index: int
    size: int

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        b = t.shape[0] // self.size
        return t[self.index * b:(self.index + 1) * b]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t / self.size

    def average_gradients(self, params) -> None:
        """Each ``.grad`` ← the group's mean: one all-reduce of them all."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.size
        lo = 0
        for g in grads:
            g.copy_(flat[lo:lo + g.numel()].view_as(g))
            lo += g.numel()


@dataclasses.dataclass
class TrainState:
    model: PeraNet  # parameters and BatchNorm statistics
    optimizer: StageOptimizer  # momentum buffers and the schedule's step count
    bank: MemoryBank


@dataclasses.dataclass
class TrainResult:
    state_dict: Optional[Dict[str, torch.Tensor]]
    bank: Optional[MemoryBank]
    history: Dict[str, list]
    best_state_dict: Optional[Dict[str, torch.Tensor]] = None
    best_val_loss: float = float("inf")


def _epoch_steps(n_train_files: int, min_len: int, batch_size: int) -> int:
    """Reference epoch length: the file list duplicated to ≥ min_len, then
    drop_last batches (datasets.py:447-457, :501-508)."""
    if n_train_files == 0:
        return 0
    dup = n_train_files * max(math.ceil(min_len / n_train_files), 1)
    return max(dup // batch_size, 1)


def stage_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator of stage ``index`` (0 init, 1 projection, 2
    fine-tune): fixed per (seed, stage), not drawn from a running stream,
    so a run resumed in fine-tune enters it with the same state as an
    uninterrupted one."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _cpu_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


class DeviceData(NamedTuple):
    """One split's synthesizer inputs on the device (uploaded once per stage)."""

    images: torch.Tensor  # (N, H, W, 3)
    masks: torch.Tensor  # (H, W) shared, or (N, H, W) per image
    coords: torch.Tensor
    counts: torch.Tensor
    pool: torch.Tensor  # the cut pool

    @property
    def per_image(self) -> bool:
        return self.masks.ndim == 3


class Trainer:
    """Trains one category on one device, or on the ranks of a
    ``data_group`` (each on its own device); see ``fit``."""

    def __init__(self, cfg: TrainConfig, data: mvtec.PretextData, device=None,
                 data_group: Optional[DataGroup] = None):
        if data_group is not None and cfg.data.batch_size % data_group.size:
            raise ValueError(f"batch {cfg.data.batch_size} does not split over "
                             f"{data_group.size} data shards")
        self.cfg = cfg
        self.data = data
        self.data_group = data_group
        self.device = resolve_device(device)
        self.model = build_model(cfg.model)
        require_cnn(self.model, "training")
        if data_group is not None:
            sync_batch_stats(self.model, data_group.group or dist.group.WORLD)
        self.spec = SynthSpec(subject=cfg.data.subject, imsize=cfg.data.imsize,
                              patch_localization=cfg.data.patch_localization,
                              patch_size=cfg.data.patch_size, aug=cfg.aug)
        self.steps_per_epoch = _epoch_steps(data.train_images.shape[0],
                                            cfg.data.min_dataset_length, cfg.data.batch_size)

    # --- the batch ----------------------------------------------------------

    def device_data(self, split: str) -> DeviceData:
        d = self.data
        images, masks, coords, counts = (
            (d.train_images, d.train_masks, d.train_coords, d.train_counts) if split == "train"
            else (d.val_images, d.val_masks, d.val_coords, d.val_counts))
        if masks is None:  # fixed pose: the subject's mask
            masks, coords, counts = d.fixed_mask, d.fixed_coords, np.int32(d.fixed_count)
        return DeviceData(*(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                            for a in (images, masks, coords, counts, d.cut_pool)))

    def upload_draws(self, generator: torch.Generator, dd: DeviceData):
        """The host half of a batch: sample indices and synthesis draws from
        ``generator``, uploaded → (indices, SynthDraws) on the device."""
        b = self.cfg.data.batch_size
        idx = torch.randint(0, dd.images.shape[0], (b,), generator=generator)
        draws = draw(self.spec, b, generator, n_cut=dd.pool.shape[0])
        return idx.to(self.device), draws.to(self.device)

    def make_batch(self, dd: DeviceData, idx: torch.Tensor, draws) -> tuple:
        """The device half: (x normalised, y, clean originals)."""
        images = dd.images.index_select(0, idx)
        if dd.per_image:
            m, c, n = (t.index_select(0, idx) for t in (dd.masks, dd.coords, dd.counts))
        else:
            m, c, n = dd.masks, dd.coords, dd.counts
        return synthesize(self.spec, draws, images, dd.pool, m, c, n)

    # --- the steps ----------------------------------------------------------

    def train_step(self, state: TrainState, uploaded, dd: DeviceData, fill: bool):
        """One step from uploaded draws → (state, metrics as device tensors:
        loss, accuracy, logits).  The parameters' ``.grad`` keep the step's
        gradients until the next step."""
        model, opt, dp = state.model, state.optimizer, self.data_group
        model.train()
        with span("ssad.train.synthesis"):
            x, y, orig = self.make_batch(dd, *uploaded)
        with span("ssad.train.forward"):
            xs, ys = (x, y) if dp is None else (dp.rows(x), dp.rows(y))
            logits = model(xs)["classifier"]
            loss = F.cross_entropy(logits, ys)
        with span("ssad.train.backward"):
            opt.zero_grad()
            loss.backward()
            if dp is not None:
                dp.average_gradients(opt.params)
        with span("ssad.train.optimizer"):
            opt.step()
        logits = logits.detach()
        if dp is not None:
            logits, loss = dp.gather(logits), dp.mean(loss)
        y_hat = logits.argmax(dim=-1)
        bank = state.bank
        if fill:
            with span("ssad.train.bank_fill"):
                rows, mask = bank_fill_subset(self.cfg.model.bank_fill_rows, y, y_hat, orig)
                bank = insert(bank, bank_fill_embeddings(model, rows), mask)
        metrics = {"loss": loss.detach(), "accuracy": (y_hat == y).float().mean(),
                   "logits": logits}
        return TrainState(model, opt, bank), metrics

    def eval_step(self, model: PeraNet, uploaded, dd: DeviceData) -> dict:
        model.eval()
        dp = self.data_group
        try:
            with torch.no_grad():
                x, y, _ = self.make_batch(dd, *uploaded)
                if dp is not None:
                    x, y = dp.rows(x), dp.rows(y)
                logits = model(x)["classifier"]
                out = {"loss": F.cross_entropy(logits, y),
                       "accuracy": (logits.argmax(dim=-1) == y).float().mean()}
                return out if dp is None else {k: dp.mean(v) for k, v in out.items()}
        finally:
            model.train()

    # --- state ----------------------------------------------------------------

    def make_state(self, stage: str) -> TrainState:
        """The model as it is, a fresh optimizer of ``stage`` and an empty bank."""
        m = self.cfg.model
        return TrainState(self.model,
                          StageOptimizer(self.model, self.cfg.optim, stage, self.steps_per_epoch),
                          init_bank(m.memory_bank_size, m.latent_dim, self.device))

    def init_state(self, stage: str, seed: int = 0,
                   generator: Optional[torch.Generator] = None) -> TrainState:
        """Initialise the model (the JAX package's distribution, from
        ``generator`` or else the seed's init generator, on the CPU; then
        the pretrained backbone when configured) and move it to the
        device."""
        init_model(self.model.cpu(), generator or stage_generator(seed, 0))
        if self.cfg.model.pretrained_backbone:
            from ssad_tpu_torch.utils.torch_weights import load_resnet18_into

            load_resnet18_into(self.model, self.cfg.model.pretrained_backbone)
        self.model.to(self.device)
        return self.make_state(stage)

    def run_stage(self, state: TrainState, stage: str, epochs: int,
                  generator: torch.Generator, result: TrainResult,
                  log_every: Optional[int] = None, start_epoch: int = 0,
                  on_epoch_end=None, stop_requested=None) -> TrainState:
        cfg = self.cfg
        tr, va = self.device_data("train"), self.device_data("val")
        val_steps = max(_epoch_steps(max(va.images.shape[0], 1), cfg.data.min_dataset_length,
                                     cfg.data.batch_size), 1)
        if cfg.optim.val_batches is not None:
            val_steps = min(val_steps, cfg.optim.val_batches)
        hist = result.history
        for epoch in range(start_epoch, epochs):
            fill = epoch > epochs // 2  # models.py:270
            losses, accs = [], []
            t0 = time.perf_counter()
            for _ in range(self.steps_per_epoch):
                state, m = self.train_step(state, self.upload_draws(generator, tr), tr, fill)
                losses.append(m["loss"])
                accs.append(m["accuracy"])
            train_loss = float(torch.stack(losses).mean())  # the epoch's one read
            dt = time.perf_counter() - t0
            train_acc = float(torch.stack(accs).mean())
            hist.setdefault(f"{stage}_images_per_sec", []).append(
                self.steps_per_epoch * cfg.data.batch_size / max(dt, 1e-9))
            val = [self.eval_step(state.model, self.upload_draws(generator, va), va)
                   for _ in range(val_steps)]
            val_loss = float(torch.stack([v["loss"] for v in val]).mean())
            val_acc = float(torch.stack([v["accuracy"] for v in val]).mean())
            hist.setdefault(f"{stage}_train_loss", []).append(train_loss)
            hist.setdefault(f"{stage}_train_accuracy", []).append(train_acc)
            hist.setdefault(f"{stage}_val_loss", []).append(val_loss)
            hist.setdefault(f"{stage}_val_accuracy", []).append(val_acc)

            # the best-val copy, fine-tune only (tools.py:284-290)
            if (stage == "fine_tune" and (epoch + 1) % cfg.optim.checkpoint_every_n_epochs == 0
                    and val_loss < result.best_val_loss):
                result.best_val_loss = val_loss
                result.best_state_dict = _cpu_state_dict(state.model)
            if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
                ips = hist[f"{stage}_images_per_sec"][-1]
                print(f"[{cfg.data.subject}/{stage}] epoch {epoch + 1}/{epochs} "
                      f"loss {train_loss:.4f} acc {train_acc:.3f} "
                      f"val_loss {val_loss:.4f} val_acc {val_acc:.3f} "
                      f"bank {int(state.bank.count)} ({ips:,.0f} img/s)", flush=True)
            if on_epoch_end is not None:
                on_epoch_end(stage, epoch, state, generator, result)
            # drain after the snapshot: the boundary resumed from is the one
            # that just persisted
            if stop_requested is not None and epoch < epochs - 1 and stop_requested():
                raise TrainingPreempted(stage, epoch)
        return state

    # --- resume snapshots -----------------------------------------------------

    @staticmethod
    def snapshot_path(resume_dir) -> Path:
        return Path(resume_dir) / "resume_snapshot.pt"

    def save_resume_snapshot(self, resume_dir, stage: str, epoch: int, state: TrainState,
                             generator: torch.Generator, result: TrainResult) -> str:
        """Everything a run needs to continue after ``epoch`` of ``stage``,
        written atomically (a .tmp file, then a rename)."""
        bank = state.bank
        payload = {
            "stage": stage, "epoch": epoch,
            "model": _cpu_state_dict(state.model),
            "optimizer": state.optimizer.state_dict(),
            "bank": {"data": bank.data.cpu(), "cursor": bank.cursor.cpu(),
                     "count": bank.count.cpu()},
            "generator": generator.get_state(),
            "history": result.history,
            "best_val_loss": result.best_val_loss,
            "best_state_dict": result.best_state_dict,
        }
        path = self.snapshot_path(resume_dir)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(path)
        return str(path)

    def _restore(self, snap: dict, stage: str) -> tuple:
        """(state, generator) of a snapshot, the model loaded in place."""
        self.model.load_state_dict(snap["model"], strict=True)
        state = self.make_state(stage)
        state.optimizer.load_state_dict(snap["optimizer"])
        b = snap["bank"]
        state.bank = MemoryBank(*(b[k].to(self.device) for k in ("data", "cursor", "count")))
        generator = torch.Generator()
        generator.set_state(snap["generator"])
        return state, generator

    def fit(self, seed: int = 0, verbose: bool = True, resume_dir=None,
            stop_requested=None) -> TrainResult:
        """The two phases (reference tools.training, :204-306).

        resume_dir: an end-of-epoch snapshot is written there, and an
        existing one is continued from.  stop_requested: a zero-argument
        callable polled at each epoch boundary after the snapshot; True
        raises TrainingPreempted."""
        result = TrainResult(state_dict=None, bank=None, history={})
        resume = None
        if resume_dir is not None and self.snapshot_path(resume_dir).exists():
            resume = torch.load(self.snapshot_path(resume_dir), map_location="cpu",
                                weights_only=True)
            result.history = resume["history"]
            result.best_val_loss = resume["best_val_loss"]
            result.best_state_dict = resume["best_state_dict"]
        on_epoch_end = None
        # one writer: the ranks of a data-parallel run hold the same state
        if resume_dir is not None and (not dist.is_initialized() or dist.get_rank() == 0):
            def on_epoch_end(stage, epoch, state, generator, res):
                self.save_resume_snapshot(resume_dir, stage, epoch + 1, state, generator, res)
        log = 1 if verbose else None
        opt = self.cfg.optim

        state = self.init_state("projection", seed)
        if resume is None or resume["stage"] == "projection":
            generator, start = stage_generator(seed, 1), 0
            if resume is not None:
                state, generator = self._restore(resume, "projection")
                start = resume["epoch"]
            self.run_stage(state, "projection", opt.projection_epochs, generator, result,
                           log_every=log, start_epoch=start, on_epoch_end=on_epoch_end,
                           stop_requested=stop_requested)
            # the bank is cleared between phases (tools.py:273); fine-tune
            # gets a fresh optimizer
            state = self.make_state("fine_tune")
            generator, ft_start = stage_generator(seed, 2), 0
        else:
            state, generator = self._restore(resume, "fine_tune")
            ft_start = resume["epoch"]
        state = self.run_stage(state, "fine_tune", opt.fine_tune_epochs, generator, result,
                               log_every=log, start_epoch=ft_start, on_epoch_end=on_epoch_end,
                               stop_requested=stop_requested)
        result.state_dict = _cpu_state_dict(state.model)
        result.bank = state.bank
        return result


def train_category(cfg: TrainConfig, data: Optional[mvtec.PretextData] = None,
                   verbose: bool = True, device=None) -> TrainResult:
    """Discover the data, train, return the result."""
    if data is None:
        data = mvtec.prepare_pretext_data(
            cfg.data.dataset_dir, cfg.data.subject, imsize=cfg.data.imsize,
            val_fraction=cfg.data.train_val_split, seed=cfg.data.seed,
            patch_localization=cfg.data.patch_localization)
    return Trainer(cfg, data, device).fit(seed=cfg.seed, verbose=verbose)
