"""``cli train --data-shards 2`` (two local gloo ranks spawned by the
command, rank 0 writing), ``cli sweep --skip-existing`` and the refusals
of shards above the device count (exit 2, as the JAX commands refuse
them), on the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch
from _torch_parallel import ROOT, write_tree

from ssad_tpu_torch import cli
from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint

torch.set_num_threads(1)

#: seconds the two-rank train may take (three interpreters, a few 64² steps)
TRAIN_TIMEOUT_S = 150
FLAGS = ["--imsize", "64", "--batch-size", "4", "--min-dataset-length", "4",
         "--projection-epochs", "1", "--fine-tune-epochs", "1", "--quiet", "--device", "cpu"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("tree"), subjects=("bottle", "carpet"))


def test_train_data_shards_2_launches_two_ranks(tree, tmp_path):
    out = tmp_path / "out"
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "ssad_tpu_torch.cli", "train", "--dataset-dir", str(tree),
         "--subject", "bottle", "--outputs-dir", str(out), "--data-shards", "2", *FLAGS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TRAIN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines == [f"checkpoint: {out / 'bottle' / 'best_model.ckpt'}"]  # rank 0 alone
    _, _, _, tcfg = load_checkpoint(out / "bottle" / "best_model.ckpt")
    assert (tcfg.mesh.data_axis, tcfg.mesh.model_axis) == (2, 1)
    hist = json.loads((out / "bottle" / "history.json").read_text())
    assert len(hist["fine_tune_train_loss"]) == 1


def test_sweep_skips_existing_checkpoints(tree, tmp_path, capsys):
    out = tmp_path / "out"
    (out / "bottle").mkdir(parents=True)
    (out / "bottle" / "best_model.ckpt").write_bytes(b"")
    assert cli.main(["sweep", "--dataset-dir", str(tree), "--outputs-dir", str(out),
                     "--subjects", "bottle,carpet", "--skip-existing", *FLAGS]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "=== bottle: checkpoint exists, skipping ==="
    assert lines[1] == "=== training carpet ===" and lines[-1].startswith("checkpoint: ")
    assert (out / "carpet" / "best_model.ckpt").stat().st_size > 0
    assert (out / "bottle" / "best_model.ckpt").stat().st_size == 0  # left as it was


@pytest.mark.parametrize("argv", [
    ["train", "--subject", "bottle", "--data-shards", "1000000"],
    ["train-multi", "--subjects", "bottle", "--coordinator", "127.0.0.1:1",
     "--num-processes", "1"],
], ids=["train-data-shards", "train-multi-no-process-id"])
def test_refusals(tree, tmp_path, capsys, argv):
    args = argv[:1] + ["--dataset-dir", str(tree), "--outputs-dir", str(tmp_path)] + argv[1:]
    if "--data-shards" in argv:
        assert cli.main(args + ["--device", "cpu"]) == 2
        assert "--data-shards 1000000 >" in capsys.readouterr().err
    else:
        with pytest.raises(SystemExit, match="--num-processes and --process-id"):
            cli.main(args + ["--device", "cpu"])
