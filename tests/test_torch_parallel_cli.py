"""``cli train-multi --coordinator``: two processes (one gloo CPU rank
each) form one world of two ranks and train bottle data-parallel (model
axis 1, stack 1), as the JAX test runs two processes over one global mesh
(tests/test_multiprocess.py).  Process 0 writes every artifact, process 1
none.  Then the coordinated drain: a SIGTERM to process 1 only drains
both at one persisted epoch boundary, exit 75 each, process 0 printing
the JSON hint and writing no artifact.  Each process has its own timeout
and its output goes to a file."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
from _torch_parallel import ROOT, free_port, write_tree

#: seconds a train-multi process may take (imports, a few 64² steps)
PROC_TIMEOUT_S = 150


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("tree"), subjects=("bottle",))


def _cmd(tree, out, port, pid, extra=()):
    return [sys.executable, "-m", "ssad_tpu_torch.cli", "train-multi",
            "--dataset-dir", str(tree), "--outputs-dir", str(out), "--subjects", "bottle",
            "--imsize", "64", "--batch-size", "4", "--min-dataset-length", "4",
            "--projection-epochs", "1", "--model-shards", "1", "--stack", "1",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(pid), "--local-devices", "1", "--quiet", "--device", "cpu",
            *extra]


def _start(cmds, logs):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return [subprocess.Popen(c, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                             text=True) for c, log in zip(cmds, logs)]


def _finish(procs, logs, paths):
    try:
        for p in procs:
            p.wait(timeout=PROC_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    return [Path(p).read_text() for p in paths]


def test_two_processes_rank_0_writes(tree, tmp_path):
    port = free_port()
    outs = [tmp_path / "out0", tmp_path / "out1"]
    paths = [tmp_path / f"w{i}.log" for i in (0, 1)]
    logs = [open(p, "w") for p in paths]
    procs = _start([_cmd(tree, outs[i], port, i, ["--fine-tune-epochs", "1"]) for i in (0, 1)],
                   logs)
    text = _finish(procs, logs, paths)
    assert [p.returncode for p in procs] == [0, 0], text
    assert (outs[0] / "bottle" / "best_model.ckpt").exists()
    hist = json.loads((outs[0] / "bottle" / "history.json").read_text())
    assert len(hist["fine_tune_val_loss"]) == 1 and len(hist["projection_train_loss"]) == 1
    assert text[0].strip().splitlines()[-1].startswith("bottle: ")
    assert not (outs[1] / "bottle").exists()  # other processes write nothing


def test_sigterm_to_one_process_drains_both(tree, tmp_path):
    port = free_port()
    resume = tmp_path / "resume"
    outs = [tmp_path / "out0", tmp_path / "out1"]
    paths = [tmp_path / f"w{i}.log" for i in (0, 1)]
    logs = [open(p, "w") for p in paths]
    extra = ["--fine-tune-epochs", "200", "--resume-dir", str(resume)]
    procs = _start([_cmd(tree, outs[i], port, i, extra) for i in (0, 1)], logs)
    snap = resume / "multi_bottle" / "resume_snapshot.pt"
    deadline = time.time() + PROC_TIMEOUT_S
    while time.time() < deadline and not snap.exists() and all(p.poll() is None for p in procs):
        time.sleep(0.2)
    assert snap.exists(), [Path(p).read_text() for p in paths]
    procs[1].send_signal(signal.SIGTERM)  # the process that writes nothing
    text = _finish(procs, logs, paths)
    assert [p.returncode for p in procs] == [75, 75], text
    info = json.loads(text[0].strip().splitlines()[-1])
    assert info["preempted"] is True and info["resume_dir"] == str(resume)
    total = {"projection": 1, "fine_tune": 200}[info["stage"]]
    assert info["epochs_done"] < total
    assert not (outs[0] / "bottle").exists() and not (outs[1] / "bottle").exists()
