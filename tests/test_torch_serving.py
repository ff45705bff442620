"""The port's image-mode serving path as a whole, against the JAX package.

Same weights, bank and threshold on both sides, imsize 64, batch 4, a
40-row checkpoint bank (28 rows after the 70/30 fit):
  JAX   export_scorer(..., platform="cpu") → ServedScorer
  port  export_checkpoint(device="cpu")   → ServedScorer(device="cpu")
Scores agree to 2e-5 and logits to 1e-4 (measured 6e-8 and 6.6e-7: f32
on both sides, summation order only), labels wherever
|score − threshold| > 1e-4.
Then the HTTP stack must return exactly the direct scorer's numbers for
npy and PNG bodies, ``cli export`` → ``cli score --device cpu`` runs end
to end, and ``cli serve --device cpu`` serves from its own process.
"""

import csv
import io
import json
import urllib.request

import numpy as np
import pytest
import torch
from _torch_port import jax_variables, seeded
from test_ref_checkpoint import reference_state_dict

from ssad_tpu_torch import cli
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.serving.export import ServedScorer, export_checkpoint, read_artifact
from ssad_tpu_torch.serving.server import AnomalyHTTPServer, BatchingScorer
from ssad_tpu_torch.utils.ref_checkpoint import save_reference_checkpoint

torch.set_num_threads(1)
IMSIZE, BATCH = 64, 4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    models = tmp_path_factory.mktemp("port_models")
    sd = reference_state_dict(seed=0)
    bank = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    save_reference_checkpoint(
        models / "bottle" / "best_model.ckpt", sd, bank, ModelConfig(compute_dtype="float32")
    )
    return models, sd


@pytest.fixture(scope="module")
def port_scorer(checkpoint, tmp_path_factory):
    models, _ = checkpoint
    path = export_checkpoint(
        models / "bottle" / "best_model.ckpt",
        tmp_path_factory.mktemp("port_art") / "bottle.ssadpt",
        batch=BATCH, imsize=(IMSIZE, IMSIZE), subject="bottle", device="cpu",
    )
    return path, ServedScorer.from_file(path, device="cpu")


def test_artifact_header(port_scorer):
    path, scorer = port_scorer
    meta, payload = read_artifact(path)
    assert meta["format"] == "ssad_tpu_torch.serving/1" and meta["platform"] == "cuda"
    assert (meta["mode"], meta["batch"], meta["imsize"], meta["k"]) == ("image", 4, [64, 64], 3)
    assert meta["scorer"] == "knn" and meta["weights_dtype"] == "float32"
    assert meta["num_classes"] == 4 and meta["subject"] == "bottle"
    assert meta["calibration"]["n"] == 12 and meta["calibration"]["source"] == "fit-val-knn"
    assert payload["bank"].shape == (28, 512) and payload["bank"].dtype == torch.float32
    assert np.isfinite(meta["threshold"])
    with pytest.raises(ValueError, match="empty batch"):
        scorer(np.zeros((0, IMSIZE, IMSIZE, 3), np.float32))


def test_scores_match_jax_export(checkpoint, port_scorer, tmp_path):
    from ssad_tpu.evaluation.inference import InferenceEngine
    from ssad_tpu.serving.export import export_scorer, load_scorer, save_artifact

    _, sd = checkpoint
    path, scorer = port_scorer
    meta, payload = read_artifact(path)
    model, params, stats = jax_variables(sd, "float32")
    exported, jmeta = export_scorer(
        InferenceEngine(model, params, stats), payload["bank"].numpy(), mode="image",
        batch=BATCH, imsize=(IMSIZE, IMSIZE), k=3, threshold=meta["threshold"],
        platform="cpu",
    )
    jscorer = load_scorer(save_artifact(tmp_path / "jax.ssadexp", exported, jmeta))

    imgs = seeded((6, IMSIZE, IMSIZE, 3), 11)  # 6 images: a padded second chunk
    scores, labels, logits = scorer(imgs)
    jscores, jlabels, jlogits = jscorer(imgs)
    assert scores.shape == (6,) and logits.shape == (6, 4) and labels.dtype == np.int32
    np.testing.assert_allclose(scores, jscores, atol=2e-5, rtol=0)
    np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=0)
    clear = np.abs(scores - meta["threshold"]) > 1e-4
    np.testing.assert_array_equal(labels[clear], jlabels[clear])


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read().decode())


def test_http_round_trip_bit_matches_direct_scorer(port_scorer):
    from PIL import Image

    from ssad_tpu_torch.data.mvtec import load_image

    _, scorer = port_scorer
    img = seeded((IMSIZE, IMSIZE, 3), 12)
    npy = io.BytesIO()
    np.save(npy, img)
    png = io.BytesIO()
    Image.fromarray((seeded((IMSIZE, IMSIZE, 3), 13) * 255).astype(np.uint8)).save(png, "PNG")
    decoded = load_image(io.BytesIO(png.getvalue()), (IMSIZE, IMSIZE))

    srv = AnomalyHTTPServer(BatchingScorer(scorer, batch=BATCH), scorer.meta, port=0).start()
    try:
        assert _get(srv.port, "/healthz") == {"ok": True, "mode": "image"}
        assert _get(srv.port, "/readyz") == {"ready": True}
        for body, image in ((npy.getvalue(), img), (png.getvalue(), decoded)):
            res = _post(srv.port, "/score", body)
            score, label, logits = scorer(image[None])
            assert res["score"] == float(score[0])
            assert res["label"] == int(label[0])
            assert res["logits"] == logits[0].tolist()
            assert res["threshold"] == scorer.meta["threshold"]
            assert _post(srv.port, "/score/bottle", body)["score"] == res["score"]
        stats = _get(srv.port, "/stats")
        assert stats["requests"] >= 5 and stats["scores"]["observed_total"] == 4
    finally:
        srv.stop()


def test_cli_export_then_score(checkpoint, port_scorer, tmp_path, capsys):
    models, _ = checkpoint
    art = tmp_path / "cli.ssadpt"
    assert cli.main([
        "export", "--models-dir", str(models), "--subject", "bottle", "--out", str(art),
        "--batch", str(BATCH), "--imsize", str(IMSIZE), "--device", "cpu",
    ]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["artifact"] == str(art)

    imgs = seeded((5, IMSIZE, IMSIZE, 3), 14)
    folder = tmp_path / "images"
    folder.mkdir()
    for i, im in enumerate(imgs):
        np.save(folder / f"{i}.npy", im)
    out = tmp_path / "scored"
    assert cli.main([
        "score", "--artifact", str(art), str(folder), "--out", str(out), "--device", "cpu",
    ]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n"] == 5 and summary["device"] == "cpu"
    with open(out / "scores.csv") as f:
        rows = list(csv.DictReader(f))
    # the CLI's artifact is fitted with the same seed: same bank, same scores
    expected = port_scorer[1](imgs)[0]
    np.testing.assert_array_equal([float(r["score"]) for r in rows], expected)


def test_load_engine_and_normality_embeddings_match_jax(checkpoint):
    from types import SimpleNamespace

    from ssad_tpu.evaluation import inference as jinf
    from ssad_tpu_torch.evaluation.inference import load_engine, normality_embeddings
    from ssad_tpu_torch.train.memory_bank import newest_first

    models, sd = checkpoint
    engine, bank, cfg = load_engine(models / "bottle" / "best_model.ckpt", device="cpu")
    assert cfg.compute_dtype == "float32" and int(bank.count) == 40
    # a bank with enough rows is the normality, newest first
    np.testing.assert_array_equal(
        normality_embeddings(engine, bank, min_bank_rows=10).numpy(), newest_first(bank).numpy()
    )
    # otherwise a seeded sample of the training images is embedded
    imgs = seeded((5, IMSIZE, IMSIZE, 3), 15)
    ours = normality_embeddings(engine, bank, imgs, batch_size=2, max_images=4)
    model, params, stats = jax_variables(sd, "float32")
    ref = jinf.normality_embeddings(
        jinf.InferenceEngine(model, params, stats), None,
        SimpleNamespace(train_images=imgs), batch_size=2, max_images=4,
    )
    assert ours.shape == (4, 512)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_cli_serve_answers_then_drains_on_sigterm(port_scorer):
    """``cli serve --device cpu`` in its own process: it prints its port,
    answers POST /score with the direct scorer's numbers, and exits 0 on
    SIGTERM."""
    import os
    import signal
    import subprocess
    import sys
    import threading
    from pathlib import Path

    path, scorer = port_scorer
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "ssad_tpu_torch.cli", "serve", "--artifact", str(path),
         "--port", "0", "--device", "cpu"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        info = json.loads(proc.stdout.readline())
        assert info["device"] == "cpu" and info["models"] == {"bottle": "image"}
        img = seeded((IMSIZE, IMSIZE, 3), 16)
        buf = io.BytesIO()
        np.save(buf, img)
        res = _post(info["port"], "/score", buf.getvalue())
        assert res["score"] == float(scorer(img[None])[0][0])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()
        proc.stderr.close()
