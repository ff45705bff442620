"""The serving extras of the port (serving/server.py ``/metrics`` and
``/admin/reload``, serving/client.py, serving/loadgen.py, ``cli
serve-bench`` and ``cli score --url``) against the JAX package's
(ssad_tpu/serving/server.py:352-512, :674-730, client.py, loadgen.py,
cli.py:257-580).

Held:
* ``/metrics``: the two servers, each over the same stub scorer and the
  same 40 requests, print the same lines (HELP, TYPE, metric names,
  labels, and every value but the latency quantiles, which are timings);
* ``/admin/reload``: both packages' servers answer 404 with no reloader,
  200 with the reloaded names, 409 while a reload runs, 500 with the old
  models still serving when the reloader raises; under 4 clients' load
  with three reloads, no request of either fails;
* the port's ``ServingClient`` gets the JAX client's answers from the
  same server, and the same error classes;
* ``cli serve-bench``: the port's JSON line has the JAX command's keys,
  against a running server (``--url``, both commands) and an artifact
  of its own (``--artifact``);
* ``cli score --url``: the port's scores.csv and summary equal the JAX
  command's against the same server, errors.csv included;
* ``cli evaluate-artifact`` of a patch artifact prints the JAX command's
  keys (image mode against the JAX command:
  tests/test_torch_serving_extras_cli.py).
"""

import csv
import json
import threading
import time

import numpy as np
import pytest
import torch
from _torch_port import seeded

from ssad_tpu.serving import drift as jdrift
from ssad_tpu.serving import server as jserver
from ssad_tpu_torch import cli
from ssad_tpu_torch.serving import client as pclient
from ssad_tpu_torch.serving import drift as pdrift
from ssad_tpu_torch.serving import server as pserver

torch.set_num_threads(1)
SIDE = 8
PACKAGES = {"port": (pserver, pdrift), "jax": (jserver, jdrift)}


def stub(x):
    """A scorer: the mean pixel, thresholded at 0.5, four zero logits."""
    scores = np.asarray(x, np.float32).mean(axis=(1, 2, 3))
    return scores, (scores > 0.5).astype(np.int32), np.zeros((x.shape[0], 4), np.float32)


def meta(drift_module, name="bottle"):
    calib = np.linspace(0.3, 0.7, 50)
    return {"mode": "image", "imsize": [SIDE, SIDE], "threshold": 0.5, "subject": name,
            "calibration": drift_module.quantile_summary(calib)}


def start(which, reloader=None, names=("bottle",), fn=stub):
    server_mod, drift_mod = PACKAGES[which]
    models = {n: (server_mod.BatchingScorer(fn, batch=4, max_delay_ms=2.0), meta(drift_mod, n))
              for n in names}
    return server_mod.AnomalyHTTPServer(models=models, reloader=reloader).start()


def npy(image) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, image)
    return buf.getvalue()


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def images(n, seed=0):
    return [seeded((SIDE, SIDE, 3), seed + i) for i in range(n)]


def test_metrics_lines_match_jax():
    servers = {w: start(w) for w in PACKAGES}
    try:
        texts = {}
        for which, srv in servers.items():
            c = pclient.ServingClient(f"http://127.0.0.1:{srv.port}")
            for img in images(40):
                c.score(img)
            texts[which] = c.metrics()
    finally:
        for srv in servers.values():
            srv.stop()
    got, want = texts["port"].splitlines(), texts["jax"].splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.startswith("ssad_request_latency_ms"):
            assert g.rsplit(" ", 1)[0] == w.rsplit(" ", 1)[0]
        else:
            assert g == w
    for family in ("ssad_score_drift_ks", "ssad_score_drift_alert", "ssad_requests_total"):
        assert f"# TYPE {family} " in texts["port"]
        assert any(line.startswith(family + '{model="bottle"}') for line in got), family
    assert 'ssad_requests_total{model="bottle"} 40' in got


def reload_scenario(which) -> dict:
    """Status codes of /admin/reload in each case, and whether requests
    failed under load."""
    server_mod, drift_mod = PACKAGES[which]
    out = {}
    srv = start(which)
    try:
        out["no reloader"] = pclient.ServingClient(f"http://127.0.0.1:{srv.port}")._request(
            "POST", "/admin/reload", b"")[0]
    finally:
        srv.stop()

    gate, entered = threading.Event(), threading.Event()
    mode = {"value": "ok"}

    def reloader():
        if mode["value"] == "fail":
            raise RuntimeError("artifact unreadable")
        if mode["value"] == "block":
            entered.set()
            gate.wait(30)
        return ({"bottle": (server_mod.BatchingScorer(stub, batch=4, max_delay_ms=2.0),
                            meta(drift_mod))}, 0.01)

    srv = start(which, reloader=reloader)
    c = pclient.ServingClient(f"http://127.0.0.1:{srv.port}", timeout=60)
    try:
        status, body = c._request("POST", "/admin/reload", b"")
        out["ok"] = (status, json.loads(body)["reloaded"])
        mode["value"] = "block"
        first = threading.Thread(target=lambda: c.__class__(
            f"http://127.0.0.1:{srv.port}", timeout=60)._request("POST", "/admin/reload", b""))
        first.start()
        assert entered.wait(30)
        out["busy"] = c._request("POST", "/admin/reload", b"")[0]
        gate.set()
        first.join(30)
        mode["value"] = "fail"
        out["failing"] = c._request("POST", "/admin/reload", b"")[0]
        out["serves after a failed reload"] = c.score(images(1)[0])["label"] in (0, 1)

        mode["value"] = "ok"
        codes, stop = [], threading.Event()

        def load(seed):
            cc = pclient.ServingClient(f"http://127.0.0.1:{srv.port}", timeout=60)
            i = 0
            while not stop.is_set():
                status, _ = cc._request("POST", "/score", npy(images(1, seed + i)[0]))
                codes.append(status)
                i += 1

        workers = [threading.Thread(target=load, args=(100 * k,)) for k in range(4)]
        for w in workers:
            w.start()
        reloads = []
        for _ in range(3):
            time.sleep(0.05)
            reloads.append(c._request("POST", "/admin/reload", b"")[0])
        time.sleep(0.05)
        stop.set()
        for w in workers:
            w.join(30)
        out["under load"] = (reloads, len(codes) > 0, sorted(set(codes)))
    finally:
        srv.stop()
    return out


def test_admin_reload_statuses_match_jax():
    got, want = reload_scenario("port"), reload_scenario("jax")
    assert got == want
    assert got["no reloader"] == 404 and got["ok"] == (200, ["bottle"])
    assert got["busy"] == 409 and got["failing"] == 500
    assert got["serves after a failed reload"] is True
    assert got["under load"] == ([200, 200, 200], True, [200])


def test_client_matches_the_jax_client():
    from ssad_tpu.serving import client as jclient

    srv = start("port", names=("bottle", "carpet"))
    try:
        url = f"http://127.0.0.1:{srv.port}"
        port_c, jax_c = pclient.ServingClient(url, model="bottle"), \
            jclient.ServingClient(url, model="bottle")
        img = images(1, 7)[0]
        a, b = port_c.score(img), jax_c.score(img)
        a.pop("ms"), b.pop("ms")
        assert a == b and set(a) == {"score", "label", "threshold", "logits"}
        assert port_c.healthz() == jax_c.healthz() == {"ok": True, "models": {
            "bottle": "image", "carpet": "image"}}
        assert port_c.readyz() == jax_c.readyz() == {"ready": True}
        assert set(port_c.stats()) == {"bottle", "carpet"}
        assert port_c.metrics().startswith("# HELP ssad_requests_total")
        for exc, call in ((pclient.BadRequest, lambda c: c.score(np.zeros((3, 3, 3)))),
                          (pclient.NoSuchRoute, lambda c: c.__class__(url, model="nope")
                           .score(img))):
            with pytest.raises(exc) as e:
                call(port_c)
            assert e.value.status in (400, 404)
        with pytest.raises(pclient.NoSuchRoute):
            port_c.reload()
    finally:
        srv.stop()


def _serve_bench(main, url, capsys):
    assert main(["serve-bench", "--url", url, "--requests", "12", "--concurrency", "3",
                 "--warmup", "2", "--imsize", str(SIDE)]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("codes", "server_stats"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_serve_bench_prints_the_jax_keys(capsys, tmp_path):
    from ssad_tpu import cli as jcli

    srv = start("port")
    try:
        url = f"http://127.0.0.1:{srv.port}"
        got, want = _serve_bench(cli.main, url, capsys), _serve_bench(jcli.main, url, capsys)
    finally:
        srv.stop()
    assert _keys(got) == _keys(want)
    assert got["ok"] == want["ok"] == 12 and got["errors"] == want["errors"] == 0
    assert set(got["server_stats"]) == set(want["server_stats"])


def test_serve_bench_on_an_artifact(capsys, tmp_path):
    from test_ref_checkpoint import reference_state_dict

    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.serving.export import export_checkpoint
    from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

    ckpt = tmp_path / "bottle" / "best_model.ckpt"
    bank = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    save_reference_checkpoint(ckpt, reference_state_dict(seed=0), bank,
                              ModelConfig(compute_dtype="float32"))
    art = export_checkpoint(ckpt, tmp_path / "a.ssadpt", batch=2, imsize=(32, 32),
                            subject="bottle", device="cpu", dtype="int8")
    assert cli.main(["serve-bench", "--artifact", art, "--requests", "8", "--concurrency", "2",
                     "--warmup", "2", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["ok"] == 8 and got["errors"] == 0 and got["shed"] == 0
    # the warmup requests, and the loader's warm-up calls through the batcher
    assert got["target"].endswith("/score") and got["server_stats"]["requests"] >= 10
    assert {"requests", "concurrency", "offered_rate", "ok", "shed", "errors", "codes", "wall_s",
            "qps", "latency_ms", "target", "server_stats"} == set(got)


def test_score_url_matches_the_jax_command(fake_mvtec, tmp_path, capsys):
    from ssad_tpu import cli as jcli

    srv = start("port")
    folder = tmp_path / "imgs"
    folder.mkdir()
    from PIL import Image

    for i, img in enumerate(images(5, 20)):
        Image.fromarray((img * 255).astype(np.uint8)).save(folder / f"{i}.png")
    np.save(folder / "bad.npy", np.zeros((3, 3, 3), np.float32))  # a 400: recorded, skipped
    outs = {}
    try:
        for name, main in (("port", cli.main), ("jax", jcli.main)):
            assert main(["score", "--url", f"http://127.0.0.1:{srv.port}", str(folder),
                         "--out", str(tmp_path / name)]) == 0
            outs[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        srv.stop()
    got, want = outs["port"], outs["jax"]
    for d in (got, want):
        d.pop("csv"), d.pop("errors_csv")
    assert got == want and got["n"] == 5 and got["n_errors"] == 1

    def rows(name, f):
        with open(tmp_path / name / f) as fh:
            return list(csv.reader(fh))
    assert rows("port", "scores.csv") == rows("jax", "scores.csv")
    assert [r[:2] for r in rows("port", "errors.csv")] == [r[:2] for r in rows("jax", "errors.csv")]


def test_evaluate_artifact_patch_mode_prints_the_jax_keys(fake_mvtec, tmp_path, capsys):
    """A bfloat16 patch artifact through ``export --validate`` and
    ``evaluate-artifact``: the JAX command's keys (its patch branch,
    ssad_tpu/serving/cli.py:630-655)."""
    from _torch_eval import seeded_state_dict, write_checkpoints

    port_models, _ = write_checkpoints(tmp_path, ["bottle"], seeded_state_dict(0))
    assert cli.main(["export", "--models-dir", str(port_models), "--subject", "bottle",
                     "--mode", "patch", "--dataset-dir", str(fake_mvtec), "--batch", "2",
                     "--dtype", "bfloat16", "--validate", "--out", str(tmp_path / "p.ssadpt"),
                     "--device", "cpu"]) == 0
    exported = _last_json(capsys)
    assert set(exported["validation"]) == {"finite", "max_abs_score_drift"}
    assert cli.main(["evaluate-artifact", "--artifact", str(tmp_path / "p.ssadpt"),
                     "--dataset-dir", str(fake_mvtec), "--chunk", "3", "--device", "cpu"]) == 0
    got = _last_json(capsys)
    metrics = {"pixel_auroc", "iou", "aupro"}
    assert set(got) == {"artifact", "subject", "mode", "dtype", "scorer", "n_test"} | metrics
    assert (got["mode"], got["dtype"], got["n_test"]) == ("patch", "bfloat16", 4)
    assert all(0.0 <= got[k] <= 1.0 for k in metrics)
