"""``python -m ssad_tpu_torch.cli doctor`` against the JAX package's
``cli doctor``: the same report keys (``torch`` for ``jax``), the device
probe in a subprocess (a probe that hangs past ``--probe-timeout`` gives
the ``unreachable`` error and exit 1; no card and no ``--device cpu``
gives the device's error), the kernel build directory in place of the
compile cache, and ``native_loader.available`` false under
``SSAD_NATIVE=0``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ssad_tpu import cli as jcli
from ssad_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent


def _report(capsys) -> dict:
    (line,) = capsys.readouterr().out.strip().splitlines()
    return json.loads(line)


def test_doctor_on_the_cpu_has_the_jax_keys(capsys):
    assert cli.main(["doctor", "--device", "cpu"]) == 0
    got = _report(capsys)
    assert jcli.main(["doctor", "--platform", "cpu"]) == 0
    want = _report(capsys)
    assert set(got) == set(want) - {"jax"} | {"torch"}
    assert got["torch"] == torch.__version__ and got["python"] == want["python"]
    assert set(got["backend"]) == set(want["backend"]) == {"platform", "device_kind",
                                                            "n_devices"}
    assert got["backend"] == {"platform": "cpu", "device_kind": "cpu", "n_devices": 1}
    assert set(want["compile_cache"]) <= set(got["compile_cache"])
    assert got["compile_cache"]["writable"] is True
    assert got["compile_cache"]["dir"] == str(ROOT / "ssad_tpu_torch" / "_build")
    assert "nvcc" in got["compile_cache"]
    assert set(got["native_loader"]) == set(want["native_loader"]) == {"available"}
    assert got["ok"] is True


def test_a_hung_probe_is_unreachable(capsys, monkeypatch):
    monkeypatch.setattr(cli, "_backend_probe", lambda device: "import time; time.sleep(30)")
    assert cli.main(["doctor", "--device", "cpu", "--probe-timeout", "0.1"]) == 1
    got = _report(capsys)
    assert got["backend"]["error"].startswith("unreachable: ") and ">0.1s" in \
        got["backend"]["error"]
    assert got["ok"] is False


def test_without_a_card_the_default_device_fails_the_probe(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert cli.main(["doctor"]) == 1
    got = _report(capsys)
    (err,) = got["backend"]["error"]
    assert "no CUDA device is available" in err and "--device cpu" in err
    assert got["ok"] is False


def test_ssad_native_0_reports_no_native_loader():
    env = dict(os.environ, SSAD_NATIVE="0")
    proc = subprocess.run([sys.executable, "-m", "ssad_tpu_torch.cli", "doctor", "--device",
                           "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["native_loader"] == {"available": False} and got["ok"] is True
