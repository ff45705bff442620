"""A cell added as files and one manifest entry runs its driver at a tiny
size on the CPU plain path; with the timed path broken underneath,
``correct`` comes out false; without a card the benchmark refuses to run."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from pb_helpers import ROOT, add_tiny_cell, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("mode", ["patch", "image"])
@pytest.mark.parametrize("trace", [0, 1])
def test_added_cell_runs(tmp_path, capsys, mode, trace):
    cell = add_tiny_cell(tmp_path, mode)
    rc, line = run_cell(tmp_path, cell, trace=trace, capsys=capsys)
    assert rc == 0 and KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    if trace:
        assert "breakdown" in line and "window_s" in line["device"]
        assert f"scorer_ms.{mode}" in line["metrics"]
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


def _alter_one_answer(score_tensor):
    def broken(self, x):
        out = score_tensor(self, x)
        first = out[0].clone()
        first[0] = first[0] * 1.5 + 0.05  # one answer altered where it is produced
        return (first,) + tuple(out[1:])
    return broken


def _drop_half_the_batch(score_tensor):
    def broken(self, x):
        half = x.shape[0] // 2
        out = score_tensor(self, x[:half])  # the rest left out, its rows copied over
        return tuple(torch.cat([o, o[: x.shape[0] - half]]) for o in out)
    return broken


@pytest.mark.parametrize("mode", ["patch", "image"])
@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_batch],
                         ids=["altered_answer", "half_batch"])
def test_broken_timed_path_is_not_correct(tmp_path, capsys, monkeypatch, mode, fault):
    from ssad_tpu_torch.serving import export

    cell = add_tiny_cell(tmp_path, mode)
    # every request in the sample: the fault must show on one that is checked
    traffic = tmp_path / "port_bench" / "traffic" / f"{cell}.json"
    t = json.loads(traffic.read_text())
    t.update(sample=10**6, pool_images=4)
    traffic.write_text(json.dumps(t))
    monkeypatch.setattr(export.ServedScorer, "score_tensor",
                        fault(export.ServedScorer.score_tensor))
    rc, line = run_cell(tmp_path, cell, capsys=capsys)
    assert rc == 0 and line["correct"] is False


def test_no_card_no_result(tmp_path):
    """Without a card: a non-zero exit and nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "r18_patch_serve",
                           "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_bench_files_alone_do_not_run(tmp_path):
    """A directory with only BENCHMARK.json and port_bench/ has no program
    to measure: a non-zero exit, nothing on standard output."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "r18_patch_serve",
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_seeded_inputs_repeat():
    from port_bench.core import seeded

    a = seeded.images(3, 64, 2**31 + 5, "x", torch.device("cpu"))
    b = seeded.images(3, 64, 2**31 + 5, "x", torch.device("cpu"))
    c = seeded.images(3, 64, 2**31 + 6, "x", torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 1
    assert np.isfinite(a.numpy()).all()
