"""Serving artifacts of the Mahalanobis scorer and of a coreset-distilled
k-NN bank (``serving/export.py``, ``cli export --scorer --coreset``).

On the CPU, from the checkpoints of tests/test_torch_serving.py (a
40-row bank) and tests/test_torch_patch_path.py (fake_mvtec's bottle):
* ``export_checkpoint(scorer="mahalanobis")``, image and patch mode: the
  header (``scorer``, a null ``knn_impl``), a payload of ``mean`` and
  ``precision`` in place of ``bank``, the fit equal to the live
  ``MahalanobisDetector``'s on the same normality and seed, and the
  served scores and maps equal to the live engine's (the same ops: bit
  for bit); image scores against the JAX engine with JAX's distance on
  the artifact's Gaussian within 1e-5 relative;
* ``export_checkpoint(coreset=N)``: the bank is the live
  ``AnomalyDetector.fit(coreset=N)``'s, N rows of the normality;
* the CLI's two stderr notes (the JAX command's), an HTTP request to a
  Mahalanobis artifact, and a k-NN artifact in the layout written before
  the scorer field was read (still served as k-NN).
"""

import io
import json
import struct
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_variables, seeded
from test_ref_checkpoint import reference_state_dict

from ssad_tpu_torch import cli
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.data.mvtec import load_split
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.detector import AnomalyDetector, MahalanobisDetector
from ssad_tpu_torch.ops import image as im
from ssad_tpu_torch.ops.knn import knn_cosine_scores
from ssad_tpu_torch.serving.export import ServedScorer, export_checkpoint, read_artifact
from ssad_tpu_torch.serving.server import AnomalyHTTPServer, BatchingScorer
from ssad_tpu_torch.train.memory_bank import newest_first
from ssad_tpu_torch.utils.ref_checkpoint import load_checkpoint, save_reference_checkpoint

torch.set_num_threads(1)
IMSIZE, BATCH = 64, 4


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    bank = np.random.default_rng(1).standard_normal((40, 512)).astype(np.float32)
    save_reference_checkpoint(root / "bottle" / "best_model.ckpt", reference_state_dict(0),
                              bank, ModelConfig(compute_dtype="float32"))
    return root


def _ckpt(models):
    return models / "bottle" / "best_model.ckpt"


def _engine(models):
    engine, bank, _ = inf.load_engine(_ckpt(models), "cpu")
    return engine, bank


@pytest.fixture(scope="module")
def image_artifact(models, tmp_path_factory):
    path = export_checkpoint(_ckpt(models), tmp_path_factory.mktemp("art") / "maha.ssadpt",
                             batch=BATCH, imsize=(IMSIZE, IMSIZE), subject="bottle",
                             device="cpu", scorer="mahalanobis", seed=2)
    return path, ServedScorer.from_file(path, device="cpu")


def test_mahalanobis_image_export(models, image_artifact):
    path, scorer = image_artifact
    meta, payload = read_artifact(path)
    assert (meta["scorer"], meta["knn_impl"], meta["mode"]) == ("mahalanobis", None, "image")
    assert set(payload) == {"state_dict", "mean", "precision"}
    assert payload["mean"].shape == (512,) and payload["precision"].shape == (512, 512)
    assert payload["precision"].dtype == torch.float32
    assert meta["calibration"]["source"] == "fit-val-mahalanobis"
    assert meta["calibration"]["n"] == 12

    engine, bank = _engine(models)
    det = MahalanobisDetector().fit(newest_first(bank), torch.Generator().manual_seed(2))
    assert torch.equal(payload["mean"], det.mean)
    assert torch.equal(payload["precision"], det.precision)
    assert meta["threshold"] == det.threshold

    imgs = seeded((6, IMSIZE, IMSIZE, 3), 11)  # a padded second chunk
    scores, labels, logits = scorer(imgs)
    live_logits, emb = engine.predict_batch(im.normalize_imagenet(torch.from_numpy(imgs)))
    assert np.array_equal(scores, det.predict(emb).numpy())
    assert np.array_equal(labels, det.predict_labels(emb).numpy())
    assert np.array_equal(logits, live_logits.numpy())


def test_mahalanobis_image_scores_match_jax(models, image_artifact):
    from ssad_tpu.evaluation.inference import InferenceEngine
    from ssad_tpu.models.detector import mahalanobis_distances
    from ssad_tpu.ops.image import normalize_imagenet

    path, scorer = image_artifact
    _, payload = read_artifact(path)
    state_dict = load_checkpoint(_ckpt(models))[0]
    jengine = InferenceEngine(*jax_variables(state_dict, "float32"))
    imgs = seeded((BATCH, IMSIZE, IMSIZE, 3), 12)
    _, jemb = jengine.predict_batch(jnp.stack([normalize_imagenet(x) for x in imgs]))
    want = np.asarray(mahalanobis_distances(jemb, jnp.asarray(payload["mean"].numpy()),
                                            jnp.asarray(payload["precision"].numpy())))
    scores, _, _ = scorer(imgs)
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def patch_models(tmp_path_factory):
    from _torch_eval import seeded_state_dict

    root = tmp_path_factory.mktemp("patch_models")
    save_reference_checkpoint(root / "bottle" / "best_model.ckpt", seeded_state_dict(0), None,
                              ModelConfig(compute_dtype="float32"))
    return root


def _patch_export(patch_models, fake_mvtec, out, **kw):
    path = export_checkpoint(_ckpt(patch_models), out, mode="patch", batch=2,
                             imsize=(IMSIZE, IMSIZE), subject="bottle", device="cpu",
                             dataset_dir=fake_mvtec, **kw)
    return (*read_artifact(path), ServedScorer.from_file(path, device="cpu"))


def _patch_normality(engine, fake_mvtec):
    data = load_split(fake_mvtec, "bottle", imsize=(IMSIZE, IMSIZE))
    return inf.normality_embeddings(engine, None, data.train_images, batch_size=4,
                                    min_bank_rows=10**9, patch_localization=True)


def test_mahalanobis_patch_export(patch_models, fake_mvtec, tmp_path):
    meta, payload, scorer = _patch_export(patch_models, fake_mvtec, tmp_path / "p.ssadpt",
                                          scorer="mahalanobis")
    assert (meta["scorer"], meta["knn_impl"], meta["upsample_to"]) == ("mahalanobis", None,
                                                                     IMSIZE)
    assert meta["calibration"]["source"] == "val-image-map-max-mahalanobis"
    engine, _ = _engine(patch_models)
    det = MahalanobisDetector().fit(_patch_normality(engine, fake_mvtec),
                                    torch.Generator().manual_seed(0))
    assert torch.equal(payload["mean"], det.mean)
    assert torch.equal(payload["precision"], det.precision)
    assert meta["threshold"] == det.threshold
    imgs = seeded((3, IMSIZE, IMSIZE, 3), 24)
    (maps,) = scorer(imgs)
    live = engine.score_patch_maps_mahalanobis(
        im.normalize_imagenet(torch.from_numpy(imgs[:2])), det.mean,
        det.precision, upsample_to=IMSIZE)
    assert maps.shape == (3, IMSIZE, IMSIZE) and np.isfinite(maps).all()
    assert np.array_equal(maps[:2], live.numpy())


@pytest.mark.parametrize("mode,rows", [("image", 10), ("patch", 16)])
def test_coreset_export(models, patch_models, fake_mvtec, tmp_path, mode, rows):
    """The bank is the coreset of the fit's train part: ``rows`` rows of
    the normality, the live detector's, and the k-NN scores are served
    from it."""
    if mode == "image":
        path = export_checkpoint(_ckpt(models), tmp_path / "c.ssadpt", batch=BATCH,
                                 imsize=(IMSIZE, IMSIZE), device="cpu", coreset=rows, k=1)
        meta, payload, scorer = (*read_artifact(path), ServedScorer.from_file(path, "cpu"))
        engine, bank = _engine(models)
        normality = newest_first(bank)
    else:
        meta, payload, scorer = _patch_export(patch_models, fake_mvtec, tmp_path / "c.ssadpt",
                                              coreset=rows, k=1)
        engine, _ = _engine(patch_models)
        normality = _patch_normality(engine, fake_mvtec)
    det = AnomalyDetector(k=1).fit(normality, torch.Generator().manual_seed(0), coreset=rows)
    assert (meta["scorer"], meta["knn_impl"], meta["k"]) == ("knn", "cuda", 1)
    assert payload["bank"].shape == (rows, 512) and torch.equal(payload["bank"], det.bank)
    assert meta["threshold"] == det.threshold
    norm_rows = {r.tobytes() for r in normality.numpy()}
    assert all(r.tobytes() in norm_rows for r in payload["bank"].numpy())
    if mode == "image":
        imgs = seeded((BATCH, IMSIZE, IMSIZE, 3), 13)
        _, emb = engine.predict_batch(im.normalize_imagenet(torch.from_numpy(imgs)))
        assert np.array_equal(scorer(imgs)[0], knn_cosine_scores(emb, det.bank, k=1).numpy())


def test_cli_export_notes(models, tmp_path, capsys):
    """The JAX command's notes: a coreset with Mahalanobis is ignored; a
    coreset with k > 1 inflates normal scores."""
    base = ["export", "--models-dir", str(models), "--subject", "bottle", "--imsize",
            str(IMSIZE), "--batch", str(BATCH), "--device", "cpu"]
    assert cli.main(base + ["--scorer", "mahalanobis", "--coreset", "8",
                            "--out", str(tmp_path / "m.ssadpt")]) == 0
    out = capsys.readouterr()
    assert "--coreset has no effect with --scorer mahalanobis" in out.err
    line = json.loads(out.out.strip().splitlines()[-1])
    meta, payload = read_artifact(line["artifact"])
    assert meta["scorer"] == "mahalanobis" and "bank" not in payload
    assert cli.main(base + ["--coreset", "8", "--out", str(tmp_path / "k.ssadpt")]) == 0
    out = capsys.readouterr()
    assert "consider --knn-k 1" in out.err
    assert read_artifact(tmp_path / "k.ssadpt")[1]["bank"].shape == (8, 512)
    assert cli.main(base + ["--coreset", "8", "--knn-k", "1",
                            "--out", str(tmp_path / "k1.ssadpt")]) == 0
    assert capsys.readouterr().err == ""


def test_http_serves_a_mahalanobis_artifact(image_artifact):
    _, scorer = image_artifact
    img = seeded((IMSIZE, IMSIZE, 3), 14)
    npy = io.BytesIO()
    np.save(npy, img)
    srv = AnomalyHTTPServer(BatchingScorer(scorer, batch=BATCH), scorer.meta, port=0).start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/score",
                                     data=npy.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            res = json.loads(r.read().decode())
    finally:
        srv.stop()
    score, label, _ = scorer(img[None])
    assert res["score"] == float(score[0]) and res["label"] == int(label[0])


@pytest.mark.parametrize("with_scorer_field", [True, False])
def test_an_older_knn_artifact_still_loads(models, tmp_path, with_scorer_field):
    """An artifact written as the k-NN-only export wrote it (the same magic,
    header and ``{"state_dict", "bank"}`` payload), and one whose header
    has no ``scorer`` at all, are served as k-NN."""
    state_dict, bank, cfg, _ = load_checkpoint(_ckpt(models))
    rows = newest_first(bank)[:20]
    meta = {"format": "ssad_tpu_torch.serving/1", "mode": "image", "batch": BATCH,
            "imsize": [IMSIZE, IMSIZE], "k": 3, "threshold": 0.5, "patch_dim": 32,
            "stride": 8, "upsample_to": None, "platform": "cuda", "knn_impl": "cuda",
            "weights_dtype": "float32", "num_classes": 4,
            "model": {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}}
    if with_scorer_field:
        meta["scorer"] = "knn"
    buf = io.BytesIO()
    torch.save({"state_dict": state_dict, "bank": rows}, buf)
    header = json.dumps(meta).encode()
    path = tmp_path / "old.ssadpt"
    path.write_bytes(b"SSADPT01" + struct.pack("<Q", len(header)) + header + buf.getvalue())
    scorer = ServedScorer.from_file(path, device="cpu")
    assert scorer.scorer == "knn" and torch.equal(scorer.detector.bank, rows)
    imgs = seeded((BATCH, IMSIZE, IMSIZE, 3), 15)
    engine, _ = _engine(models)
    _, emb = engine.predict_batch(im.normalize_imagenet(torch.from_numpy(imgs)))
    assert np.array_equal(scorer(imgs)[0], knn_cosine_scores(emb, rows, k=3).numpy())
