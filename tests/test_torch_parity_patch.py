"""The accuracy-parity harness, continued from tests/test_torch_parity.py:
the evaluation half of ``run_parity`` at patch level against the JAX
package's (``_torch_parity.check_evaluation_half``), and a tiny port-only
run that trains, writes ``best_model.ckpt`` and its fingerprint, and
skips training when rerun."""

import functools
import json

import torch
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_parity import check_evaluation_half

from ssad_tpu_torch import parity
from ssad_tpu_torch.config import DataConfig

torch.set_num_threads(1)


def test_patch_level_evaluation_half_matches_jax(tmp_path):
    check_evaluation_half(tmp_path, "patch", ["carpet"])


def test_a_tiny_port_run_trains_then_skips_training(tmp_path, monkeypatch, capsys):
    """One subject, 1 + 1 epochs at 32² (an epoch of 16 images, batch 8):
    trains and writes best_model.ckpt and the fingerprint; a rerun trains
    nothing."""
    monkeypatch.setattr(parity, "DataConfig", functools.partial(DataConfig,
                                                               min_dataset_length=16))
    kw = dict(dataset_dir=None, outputs_dir=str(tmp_path), subjects=["bottle"], imsize=32,
              batch_size=8, projection_epochs=1, fine_tune_epochs=1, modes=("image",),
              device="cpu")
    first = parity.run_parity(**kw)
    ckpt = tmp_path / "image_level" / "models" / "bottle" / "best_model.ckpt"
    assert ckpt.exists()
    fp = json.loads((tmp_path / "image_level" / "models" / "parity_run.json").read_text())
    assert fp == {"backbone": "resnet18", "pretrained": False, "imsize": 32, "batch_size": 8,
                  "projection_epochs": 1, "fine_tune_epochs": 1, "seed": 0, "mode": "image"}
    assert "[parity/image] training bottle" in capsys.readouterr().out
    stamp = ckpt.stat().st_mtime_ns
    calls = []
    monkeypatch.setattr(parity, "_train_subject", lambda *a: calls.append(a))
    second = parity.run_parity(**kw)
    assert calls == [] and ckpt.stat().st_mtime_ns == stamp
    assert "bottle: checkpoint exists, skipping train" in capsys.readouterr().out
    assert second == first
    assert 0.0 <= first["image"]["image_auroc"] <= 1.0
