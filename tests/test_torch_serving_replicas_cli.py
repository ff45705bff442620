"""``serve --devices 2 --frontend native|stdlib`` of the port on the CPU,
through the product loaders (serving/cli.py ``_load_artifact_models`` and
``_make_http_server``), as tests/test_serving_stress.py:84 drives the
JAX stack: replicas, a reload mid-stream, drift and open-loop traffic
together.

An image artifact (imsize 64, batch 4, the port's ``export_checkpoint``
with its calibration) on two CPU replicas takes 96 requests offered at
32/s (``loadgen.run_load(rate=)``) while ``POST /admin/reload`` swaps the
models 1 s in, then a closed-loop burst of 64.  Held, per front end:
the front end asked for is the one that serves; no request fails and
none is shed; the reload answers 200 with ``["bottle"]``; ``/stats``
counts 2 replicas, both ran batches, and ``replica_batches`` sums to
``batches``; the drift window is live past its gate; ``/metrics`` has
``ssad_replica_batches_total{model="bottle",replica="0|1"}``, those
counts sum to ``/stats``' batches, and its families and label sets are
the JAX stack's (``_prometheus_metrics`` over a two-replica JAX
batcher).  Also ``cli serve --frontend native`` with ``SSAD_NATIVE=0``
in its own process prints the JAX command's warning line and
``"frontend": "stdlib"``, and exits 0 on SIGTERM.

Planted faults that break these: ``_load_artifact_models`` ignoring
``devices`` (``replicas`` missing from ``/stats``); ``_make_http_server``
falling back to stdlib although the library builds (the front end
assertion).
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from test_ref_checkpoint import reference_state_dict

from ssad_tpu_torch.serving import loadgen, native_frontend
from ssad_tpu_torch.serving.cli import _load_artifact_models, _make_http_server
from ssad_tpu_torch.serving.client import ServingClient

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
IMSIZE, BATCH = 64, 4


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.serving.export import export_checkpoint
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    root = tmp_path_factory.mktemp("replicas_cli")
    bank = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    ckpt = root / "bottle" / "best_model.ckpt"
    save_reference_checkpoint(ckpt, reference_state_dict(seed=0), bank,
                              ModelConfig(compute_dtype="float32"))
    return export_checkpoint(ckpt, root / "bottle_image.ssadpt", batch=BATCH,
                             imsize=(IMSIZE, IMSIZE), subject="bottle", device="cpu")


def _families_and_labels(text: str) -> set:
    """{(family or sample name, label names)} of a Prometheus text."""
    out = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            out.add(tuple(line.split()[2:4]))
        elif line and not line.startswith("#"):
            name, _, labels = line.split(" ")[0].partition("{")
            out.add((name, tuple(sorted(re.findall(r'(\w+)="', labels)))))
    return out


def _jax_families_and_labels() -> set:
    from ssad_tpu.serving import drift as jdrift
    from ssad_tpu.serving import server as jserver

    def stub(x):
        s = x.reshape(x.shape[0], -1).mean(axis=1)
        return s, (s > 0.5).astype(np.int32), np.zeros((x.shape[0], 4), np.float32)

    sc = jserver.BatchingScorer([stub, stub], batch=2, max_delay_ms=1.0)
    tracker = jdrift.ScoreTracker(baseline=jdrift.quantile_summary(np.linspace(0, 1, 64)))
    tracker.min_scores = 4
    try:
        for i in range(16):
            tracker.observe(float(sc.score(np.full((2, 2, 3), i / 16, np.float32))[0]))
        return _families_and_labels(jserver._prometheus_metrics({"bottle": (sc, {})},
                                                                {"bottle": tracker}))
    finally:
        sc.close()


@pytest.mark.parametrize("frontend", ["stdlib", "native"])
def test_reload_under_open_loop_load_with_two_cpu_replicas(artifact, frontend):
    if frontend == "native" and not native_frontend.available():
        pytest.skip("native HTTP front end not buildable here")

    def loader():
        return _load_artifact_models([artifact], 5.0, 256, torch.device("cpu"), devices=2)

    models, _ = loader()
    warm = models["bottle"][0].stats()
    assert (warm["requests"], warm["batches"], warm["replica_batches"]) == (0, 0, [0, 0])
    server, got = _make_http_server(frontend, host="127.0.0.1", port=0, score_timeout=60.0,
                                    models=models, reloader=loader, max_queue=256)
    server.start()
    assert got == frontend
    host, port = "127.0.0.1", server.port
    body = loadgen.npy_body((IMSIZE, IMSIZE), seed=1)
    box = {}

    def offered():
        box["report"] = loadgen.run_load(host, port, body, concurrency=8, total=96, rate=32.0,
                                         timeout=120.0)

    try:
        t = threading.Thread(target=offered)
        t.start()
        time.sleep(1.0)
        with ServingClient(f"http://{host}:{port}", timeout=120.0) as c:
            reloaded = c.reload()
        mid_run = t.is_alive()
        t.join(timeout=120)
        report = box["report"]
        assert (report["errors"], report["shed"], report["ok"]) == (0, 0, 96), report
        assert reloaded["reloaded"] == ["bottle"] and mid_run
        burst = loadgen.run_load(host, port, body, concurrency=8, total=64, timeout=120.0)
        assert (burst["errors"], burst["shed"]) == (0, 0), burst
        stats = loadgen.fetch_stats(host, port)
        metrics = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30).read()
        metrics = metrics.decode()
    finally:
        server.stop()
    assert stats["replicas"] == 2
    rb = stats["replica_batches"]
    assert len(rb) == 2 and min(rb) >= 1 and sum(rb) == stats["batches"], rb
    scores = stats["scores"]
    assert scores["recent_n"] >= 64 and np.isfinite(scores["drift_ks"])
    samples = dict(re.findall(
        r'^ssad_replica_batches_total\{model="bottle",replica="(\d)"\} (\d+)$', metrics, re.M))
    assert set(samples) == {"0", "1"}
    assert sum(int(v) for v in samples.values()) == stats["batches"]
    assert _families_and_labels(metrics) == _jax_families_and_labels()


def test_native_disabled_falls_back_loudly(artifact):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ssad_tpu_torch.cli", "serve", "--artifact", str(artifact),
         "--port", "0", "--device", "cpu", "--frontend", "native", "--devices", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "SSAD_NATIVE": "0", "OMP_NUM_THREADS": "1"},
    )
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        warning = proc.stdout.readline().strip()
        info = json.loads(proc.stdout.readline())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    jax_cli = (ROOT / "ssad_tpu" / "serving" / "cli.py").read_text()
    assert warning.startswith("WARNING: native front end unavailable")
    assert re.sub(r"\s+", "", warning) in re.sub(r'[\s"]+', "", jax_cli)
    assert info["frontend"] == "stdlib" and info["devices"] == 2
    assert info["models"] == {"bottle": "image"} and info["device"] == "cpu"
