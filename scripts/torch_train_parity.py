#!/usr/bin/env python3
"""The train step's card-vs-CPU check, with planted faults, on a card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_train_parity.py

One f32 fine-tune step (fill on) on the card against the CPU port from the
same weights and draws (tests/_torch_step_parity.py), in two
cases: 64², batch 8 on the disc images of ``disc_data`` under
``CPU_LIMITS``, and 256², batch 16 on chip_smoke.py's seeded bottle tree
under ``TREE_256_LIMITS``.  In each case the card step runs three ways:

* ``clean``: TF32 off, as chip_smoke.py runs it;
* ``tf32_on``: TF32 on for cuBLAS and cuDNN;
* ``unbiased_running_var``: every BatchNorm updates its running variance
  with the unbiased batch variance, as ``F.batch_norm(training=True)``
  does, in place of Flax's biased one.

Prints one JSON line per case and way, with the largest |Δ| of each
compared quantity and the keys beyond the limits (a clean step must have
none, a planted fault at least one), then the card's name and power limit.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402  (repo root on sys.path first)
from _torch_card_fixtures import write_synth_tree  # noqa: E402


@contextlib.contextmanager
def tf32_on():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def unbiased_running_var():
    """Each train-mode BatchNorm adds (1 − momentum)·var/(n − 1) to its new
    running variance: the update then uses var·n/(n − 1)."""
    import torch

    from ssad_tpu_torch.models.resnet import FlaxBatchNorm

    flax_forward = FlaxBatchNorm.forward

    def forward(self, x):
        y = flax_forward(self, x)
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            x32 = x.float()
            n = x32.numel() // x32.shape[1]
            var = torch.clamp((x32 * x32).mean(dims) - x32.mean(dims) ** 2, min=0.0)
            with torch.no_grad():
                self.running_var.add_((1.0 - self.MOMENTUM) * var / (n - 1))
        return y

    FlaxBatchNorm.forward = forward
    try:
        yield
    finally:
        FlaxBatchNorm.forward = flax_forward


def main() -> int:
    import _torch_step_parity as sp
    import torch

    from ssad_tpu_torch.data import mvtec

    if not torch.cuda.is_available():
        print("torch_train_parity: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "synth_mvtec"
        write_synth_tree(root)
        tree = mvtec.prepare_pretext_data(root, "bottle", imsize=(256, 256),
                                          val_fraction=0.2, seed=0)
    cases = [("disc_64", sp.disc_data(64), 8, sp.CPU_LIMITS),
             ("tree_256", tree, 16, sp.TREE_256_LIMITS)]
    ways = [("clean", contextlib.nullcontext), ("tf32_on", tf32_on),
            ("unbiased_running_var", unbiased_running_var)]
    ok = True
    for name, data, batch, limits in cases:
        cfg = sp.step_config(data.imsize, batch)
        host = sp.step_record(cfg, data, "cpu")
        for way, plant in ways:
            t0 = time.perf_counter()
            with plant():
                deltas = sp.step_deltas(sp.step_record(cfg, data, device), host)
            beyond = sp.beyond(deltas, limits)
            ok &= (not beyond) if way == "clean" else bool(beyond)
            print(json.dumps({"case": name, "batch": batch, "way": way, **deltas,
                              "beyond": beyond, "limits": limits,
                              "seconds": time.perf_counter() - t0}), flush=True)
    print(f"card: {chip_smoke.card_line()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
