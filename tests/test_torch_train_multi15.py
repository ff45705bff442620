"""``train-multi --subjects all`` of the port over the 15-category taxonomy,
with a SIGTERM drain and a resume, on the CPU (the counterpart of
tests/test_train_multi15.py; slow, as that test is).

The tree is the port's ``generate_parity_dataset`` of all 15 categories at
64² (4 train-good, 1 good and 1 defect test image each).  The command
(batch 4, 1 + 4 epochs of one step, ``--stack 8``, ``--resume-dir``) runs
in a subprocess, since the CLI owns the SIGTERM handler:

* run 1: the three non-fixed objects (hazelnut, metal_nut, screw) train
  first on the single-category ``Trainer``, then the 5 textures as one
  chunk padded to 8.  At the first group snapshot
  (``multi_<group>/resume_snapshot.pt``) the process gets SIGTERM: exit 75,
  a JSON resume hint naming the resume dir, and no ``<subject>/best_model*``
  of any of the 15 (artifacts are written only once every chunk is done);
* run 2, the same command: exit 0; the texture chunk
  (``carpet+grid+leather+tile+wood``, 3 of 8 padded) and the 7 fixed
  objects (1 of 8) are announced with their padding lines, and each of the
  15 subjects has its checkpoint and a history.json with 1 projection and
  4 fine-tune entries (the drained chunk's from its snapshot, the non-fixed
  subjects' from their completed per-subject snapshots).

    python -m pytest -m slow tests/test_torch_train_multi15.py
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ssad_tpu_torch import constants
from ssad_tpu_torch.parity import generate_parity_dataset

REPO = Path(__file__).resolve().parent.parent

TEXTURES = ["carpet", "grid", "leather", "tile", "wood"]
FIXED = ["bottle", "cable", "capsule", "pill", "toothbrush", "transistor", "zipper"]
NON_FIXED = ["hazelnut", "metal_nut", "screw"]


@pytest.fixture(scope="module")
def mvtec15(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvtec15")
    return generate_parity_dataset(root, subjects=constants.ALL_CATEGORIES, imsize=64,
                                   n_train=4, n_test_good=1, n_test_defect=1)


def _hint(log: str) -> dict:
    for line in reversed(log.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise AssertionError(log[-2000:])


@pytest.mark.slow
def test_all_categories_with_drain_and_resume(mvtec15, tmp_path):
    assert sorted(TEXTURES + FIXED + NON_FIXED) == list(constants.ALL_CATEGORIES)
    out, resume = tmp_path / "out", tmp_path / "resume"
    cmd = [sys.executable, "-m", "ssad_tpu_torch.cli", "train-multi", "--device", "cpu",
           "--dataset-dir", str(mvtec15), "--outputs-dir", str(out), "--subjects", "all",
           "--imsize", "64", "--batch-size", "4", "--min-dataset-length", "4",
           "--projection-epochs", "1", "--fine-tune-epochs", "4", "--stack", "8",
           "--resume-dir", str(resume)]
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}

    # ---- run 1: drained after the first group snapshot ----------------------
    log1 = tmp_path / "run1.log"
    with open(log1, "w") as log:
        p = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 900
            while not list(resume.glob("multi_*/resume_snapshot.pt")):
                if p.poll() is not None:
                    raise AssertionError("run 1 ended before a group snapshot:\n"
                                         + log1.read_text()[-3000:])
                assert time.time() < deadline, "no group snapshot within 900 s"
                time.sleep(0.1)
            p.send_signal(signal.SIGTERM)
            p.wait(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
    run1 = log1.read_text()
    assert p.returncode == 75, run1[-3000:]
    info = _hint(run1)
    assert info["preempted"] is True and info["resume_dir"] == str(resume), info
    partial = [s for s in TEXTURES + FIXED + NON_FIXED if list((out / s).glob("best_model*"))]
    assert not partial, partial

    # ---- run 2: the same command completes the schedule --------------------
    log2 = tmp_path / "run2.log"
    with open(log2, "w") as log:
        r = subprocess.run(cmd, env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                           timeout=1800)
    run2 = log2.read_text()
    assert r.returncode == 0, run2[-3000:]
    both = run1 + run2
    assert "+".join(TEXTURES) in both and "+".join(FIXED) in both
    assert "padding 5-category chunk to stack=8 with duplicates (3/8" in both
    assert "padding 7-category chunk to stack=8 with duplicates (1/8" in both
    for s in TEXTURES + FIXED + NON_FIXED:
        assert (out / s / "best_model.ckpt").is_file(), s
        hist = json.loads((out / s / "history.json").read_text())
        assert len(hist["projection_train_loss"]) == 1, (s, hist)
        assert len(hist["fine_tune_val_loss"]) == 4, (s, hist)
