"""Profiling (ssad_tpu_torch/utils/profiling.py) and ``cli profile``
against the JAX package's (ssad_tpu/utils/profiling.py, ``cli profile``).

Held: ``StepTimer.summary()`` equal to JAX's on the same injected step
times (the first step dropped); ``device_memory_stats()`` empty on the
CPU; ``trace`` writes a Chrome-trace JSON with events; and ``cli profile
--device cpu --what patch|train`` at 64², batch 1–2, 2 steps prints one
JSON line with the JAX command's keys and writes a trace (the JAX
command's own run is not repeated here: it compiles its programs for
~20 s).  Data come from
a seeded numpy generator (not conftest's shared ``rng``)."""

import json

import numpy as np
import pytest
import torch

from ssad_tpu.utils import profiling as jprofiling
from ssad_tpu_torch import cli
from ssad_tpu_torch.parity import generate_parity_dataset
from ssad_tpu_torch.utils import profiling

torch.set_num_threads(1)

#: the keys of the JAX ``cli profile`` line (ssad_tpu/cli.py:681-685)
PROFILE_KEYS = {"trace_dir", "steps", "mean_ms", "p50_ms", "p95_ms", "items_per_sec", "memory"}


@pytest.mark.parametrize("n,items", [(1, 1), (2, 8), (7, 96), (0, 4)])
def test_step_timer_summary_equals_jax(n, items):
    times = list(np.random.default_rng(n).uniform(1e-3, 0.2, n))
    port, jax = profiling.StepTimer(items), jprofiling.StepTimer(items)
    port.times, jax.times = list(times), list(times)
    assert port.summary() == jax.summary()


def test_step_timer_times_a_step_and_synchronises_nested_results():
    timer = profiling.StepTimer(items_per_step=4)
    x = torch.ones(3)
    with timer.step() as box:
        box["sync"] = {"a": [x, (x + 1,)], "b": x * 2}
    timer.start()
    timer.stop(sync=x)
    assert len(timer.times) == 2 and all(t >= 0 for t in timer.times)
    assert timer.summary()["steps"] == 2
    assert profiling.block_until_ready(x) is x
    with pytest.raises(RuntimeError, match="start"):
        timer.stop()


def test_device_memory_stats_is_empty_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: its statistics are not empty")
    assert profiling.device_memory_stats() == {} == jprofiling.device_memory_stats()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile_tree")
    generate_parity_dataset(root, ("bottle",), imsize=64, n_train=5, n_test_good=1,
                            n_test_defect=1, seed=2)
    return root


def _profile(tree, out, what, flags):
    return cli.main(["profile", "--dataset-dir", str(tree), "--subject", "bottle", "--imsize", "64",
                 "--steps", "2", "--what", what, "--profile-dir", str(out)] + flags)


def _line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("what,flags", [("patch", ["--profile-batch", "1"]),
                                        ("train", ["--batch-size", "2"])])
def test_cli_profile_prints_the_jax_keys_and_writes_a_trace(tree, tmp_path, capsys, what, flags):
    assert _profile(tree, tmp_path / "port", what, flags + ["--device", "cpu"]) == 0
    line = _line(capsys)
    assert set(line) == PROFILE_KEYS
    assert line["trace_dir"] == str(tmp_path / "port") and line["steps"] == 2
    assert line["memory"] == {} or torch.cuda.is_available()
    assert 0 < line["p50_ms"] <= line["p95_ms"] and line["items_per_sec"] > 0
    (trace,) = (tmp_path / "port").glob("*.pt.trace.json")
    assert trace.stat().st_size > 0


def test_cli_profile_refuses_the_cpu_unless_asked(tree, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert _profile(tree, tmp_path, "patch", []) == 2
    assert "--device cpu" in capsys.readouterr().err
