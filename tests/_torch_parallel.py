"""Shared parts of the port's multi-device tests (tests/test_torch_parallel_*.py).

No JAX here: this module is also the rank program of the two-rank tests,
``python tests/_torch_parallel.py dp_step RANK WORLD PORT IN OUT``, run
as its own process per rank (gloo on the CPU).  ``run_ranks`` starts
them, each with its own timeout.

The data-parallel step is compared under pinned decisions (``Pin``):
every ReLU passes exactly the units whose pre-activation in a reference
forward is > 0, and the stem's max-pool takes each window's argmax there,
so a unit within rounding of its boundary cannot take the other side when
the summation order changes (tests/_torch_train.py ``Pinned`` says why);
rank r pins to its rows of the reference's decisions.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parent.parent
SIZE, BATCH, BANK = 64, 8, 6
#: seconds one rank may take (it imports torch and runs a ResNet-18 step)
RANK_TIMEOUT_S = 120


def step_cfg():
    from ssad_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, TrainConfig

    return TrainConfig(data=DataConfig(imsize=(SIZE, SIZE), batch_size=BATCH,
                                       min_dataset_length=BATCH),
                       model=ModelConfig(compute_dtype="float32", memory_bank_size=BANK),
                       optim=OptimConfig(fine_tune_epochs=3))


#: what the trainer reads of PretextData here: one epoch step of BATCH
DATA = types.SimpleNamespace(train_images=np.zeros((BATCH, SIZE, SIZE, 3), np.float32),
                             cut_pool=np.zeros((1, SIZE, SIZE, 3), np.float32))


def seeded_inputs(seed: int = 0) -> dict:
    """A seeded state dict (the port's init) and batch (x, y, originals)."""
    from ssad_tpu_torch.models.peranet import build_model, init_model

    model = init_model(build_model(step_cfg().model), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32))
    y = torch.tensor([0, 0, 0, 0, 0, 1, 2, 3])
    orig = torch.from_numpy(rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32))
    return {"state_dict": model.state_dict(), "batch": (x, y, orig)}


class Pin(TorchFunctionMode):
    """With ``relus``/``pool_in`` None: records the forward's ReLU inputs
    and the stem max-pool's input.  Given them: pins the forward to them
    (calls past the recorded ones, as the bank fill's eval forward, run as
    they are)."""

    def __init__(self, relus=None, pool_in=None):
        super().__init__()
        self.record = relus is None
        self.relus, self.pool_in = ([], None) if self.record else (relus, pool_in)
        self.seen, self.pooled = 0, False

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.relu and (self.record or self.seen < len(self.relus)):
            x = args[0]
            if self.record:
                self.relus.append(x.detach().clone())
                return func(*args, **kwargs)
            ref = self.relus[self.seen]
            self.seen += 1
            return torch.where(ref > 0, x, torch.zeros_like(x))
        if func is F.max_pool2d and not self.pooled:
            self.pooled = True
            if self.record:
                self.pool_in = args[0].detach().clone()
                return func(*args, **kwargs)
            x = args[0]
            _, idx = F.max_pool2d(self.pool_in, 3, 2, 1, return_indices=True)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        return func(*args, **kwargs)


def decisions(state_dict, x) -> dict:
    """The train-mode forward's ReLU inputs and stem max-pool input on
    ``x`` (a copy of the model, so no statistic moves)."""
    from ssad_tpu_torch.models.peranet import build_model

    model = build_model(step_cfg().model)
    model.load_state_dict(state_dict)
    model.train()
    with Pin() as rec, torch.no_grad():
        model(x)
    return {"relus": rec.relus, "pool_in": rec.pool_in}


def dp_step(inputs: dict, data_group=None, per_rank_bn: bool = False) -> dict:
    """One fine-tune fill step of the port's Trainer on the given batch
    (``data_group``: this rank's DataGroup), pinned to ``inputs``'
    decisions (this rank's rows of them) → host copies of the loss,
    logits, gradients, state and bank.  ``per_rank_bn``: the planted
    fault, each rank's BatchNorm statistics its own (plain DDP)."""
    from ssad_tpu_torch.models.resnet import sync_batch_stats
    from ssad_tpu_torch.train.trainer import Trainer

    tr = Trainer(step_cfg(), DATA, "cpu", data_group)
    tr.model.load_state_dict(inputs["state_dict"], strict=True)
    state = tr.make_state("fine_tune")
    x, y, orig = inputs["batch"]
    tr.make_batch = lambda dd, idx, draws: (x, y, orig)
    if per_rank_bn:
        sync_batch_stats(tr.model, None)
    d = inputs["decisions"]
    rows = slice(None)
    if data_group is not None:
        b = BATCH // data_group.size
        rows = slice(data_group.index * b, (data_group.index + 1) * b)
    with Pin([r[rows] for r in d["relus"]], d["pool_in"][rows]):
        state, m = tr.train_step(state, (None, None), None, fill=True)
    return {
        "loss": m["loss"].double(), "logits": m["logits"].double(),
        "grads": {n: p.grad.double().clone() for n, p in tr.model.named_parameters()},
        "state": {k: v.double().clone() for k, v in tr.model.state_dict().items()
                  if not k.endswith("num_batches_tracked")},
        "bank": [t.double().clone() for t in state.bank],
    }


def deltas(a: dict, b: dict) -> dict:
    """Largest |a − b| per quantity in CPU_LIMITS' terms: gradients
    relative to each tensor's largest |g| in ``b`` (at least GRAD_FLOOR);
    a bank whose cursor or count differs reads inf."""
    from _torch_step_parity import GRAD_FLOOR

    def mx(u, v):
        return float((u - v).abs().max()) if u.numel() else 0.0

    (ad, ac, an), (bd, bc, bn) = a["bank"], b["bank"]
    return {
        "loss": mx(a["loss"], b["loss"]), "logits": mx(a["logits"], b["logits"]),
        "state": max(mx(a["state"][k], v) for k, v in b["state"].items()),
        "grad_rel": max(mx(a["grads"][n], g) / max(float(g.abs().max()), GRAD_FLOOR)
                        for n, g in b["grads"].items()),
        "bank": mx(ad, bd) if int(ac) == int(bc) and int(an) == int(bn) else float("inf"),
    }


def write_tree(root: Path, subjects=("bottle", "cable", "carpet"), n: int = 6) -> Path:
    """A seeded 64² MVTec-layout tree: ``n`` train-good images a subject
    (objects a bright disc, textures noise), 2 good and 2 defective test
    images with their masks (tests/conftest.py ``fake_mvtec``'s layout)."""
    from PIL import Image

    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    disc = (yy - 32) ** 2 + (xx - 32) ** 2 < 24 ** 2

    def save(path, arr):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr).save(path)

    for k, cat in enumerate(subjects):
        base = 90 if cat == "carpet" else 150 + 10 * k
        for i in range(n):
            img = np.full((SIZE, SIZE, 3), base, np.uint8)
            img += rng.integers(0, 20, (SIZE, SIZE, 3), dtype=np.uint8)
            if cat != "carpet":
                img[disc] = np.clip(img[disc].astype(int) + 60, 0, 255).astype(np.uint8)
            save(root / cat / "train" / "good" / f"{i:03d}.png", img)
        for i in range(2):
            save(root / cat / "test" / "good" / f"{i:03d}.png",
                 np.full((SIZE, SIZE, 3), base, np.uint8))
            img = np.full((SIZE, SIZE, 3), base, np.uint8)
            img[20:30, 20:40] = 250
            save(root / cat / "test" / "broken" / f"{i:03d}.png", img)
            gt = np.zeros((SIZE, SIZE), np.uint8)
            gt[20:30, 20:40] = 255
            save(root / cat / "ground_truth" / "broken" / f"{i:03d}_mask.png", gt)
    return root


def free_port() -> int:
    from ssad_tpu_torch.parallel.distributed import free_port as fp

    return fp()


def run_ranks(task: str, world: int, inp: Path, out_dir: Path) -> list:
    """``task`` on ``world`` gloo ranks, a process each (each with its own
    timeout) → their outputs in rank order."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), task, str(r), str(world),
                               str(port), str(inp), str(out_dir / f"rank{r}.pt")],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _main(task, rank, world, port, inp, out):
    from ssad_tpu_torch.parallel import distributed as dist_mod
    from ssad_tpu_torch.train.trainer import DataGroup

    torch.set_num_threads(1)
    inputs = torch.load(inp, weights_only=False)
    with dist_mod.process_group(f"127.0.0.1:{port}", world, rank, "cpu", timeout_s=90):
        if task == "dp_step":
            group = DataGroup(None, rank, world)
            result = {"step": dp_step(inputs, group),
                      "per_rank_bn": dp_step(inputs, group, per_rank_bn=True)}
        elif task == "global_any":
            result = {"any": [dist_mod.global_any(rank == r) for r in range(world)]
                      + [dist_mod.global_any(False)]}
        else:
            raise ValueError(task)
    torch.save(result, out)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
          sys.argv[6])
