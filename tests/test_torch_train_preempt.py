"""``cli train --resume-dir``: a SIGTERM drains at the next epoch boundary,
the command exits 75 with its JSON resume hint, and the same command run
again continues from the snapshot (fine-tune only) and finishes."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

from test_torch_train_cli import _train_args

ROOT = Path(__file__).resolve().parent.parent


def test_sigterm_with_resume_dir_exits_75_with_a_hint_and_the_rerun_finishes(fake_mvtec,
                                                                             tmp_path):
    args = [sys.executable, "-m", "ssad_tpu_torch.cli",
            *_train_args(fake_mvtec, tmp_path / "out", fine_tune_epochs=5),
            "--resume-dir", str(tmp_path / "resume")]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        for line in proc.stdout:  # the guard is active once an epoch has printed
            if "epoch 1/1" in line:
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 75, err[-2000:]
    hint = json.loads(out.strip().splitlines()[-1])
    assert hint["preempted"] and hint["stage"] == "fine_tune" and hint["epochs_done"] < 5
    assert hint["resume_dir"] == str(tmp_path / "resume")
    rerun = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, env=env, timeout=240)
    assert rerun.returncode == 0, rerun.stderr[-2000:]
    assert f"[bottle/fine_tune] epoch {hint['epochs_done'] + 1}/5" in rerun.stdout
    assert "projection" not in rerun.stdout
    assert (tmp_path / "out" / "bottle" / "best_model.ckpt").is_file()
