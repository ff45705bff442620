"""The Mahalanobis scorer (``models/detector.py``) and its patch maps
(``InferenceEngine.score_patch_maps_mahalanobis``) against the JAX
package's.

The port computes the quadratic form in float64 and rounds once to f32;
JAX computes it in f32 at ``Precision.HIGHEST``.  Tolerances, relative:
distances 1e-5 (measured 4.3e-7 on 512-d rows), the fit's calibration
scores and threshold 1e-5, its precision 1e-4 of its largest entry
(measured 1.2e-5 at 45 rows × 512, 1.3e-6 at 3,000), its mean 1e-6
absolute; the engine's maps 1e-5 where both sides run the module
forward (16×16 windows), and the patch path's tolerances of
tests/test_torch_patch_path.py where both take the fused stem (32×32
windows: the stem rounds its f32 sums to bf16 in other orders).  The
JAX permutation is handed to the port (``_torch_eval.jax_perm``).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_eval import jax_engine, jax_perm, seeded_state_dict

from ssad_tpu.evaluation import inference as jinf
from ssad_tpu.models.detector import MahalanobisDetector as JMahalanobisDetector
from ssad_tpu.models.detector import mahalanobis_distances as jmahalanobis
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.detector import MahalanobisDetector, mahalanobis_distances
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.ops import image as im

torch.set_num_threads(1)

REL = 1e-5


def _embeddings(m, d=512, seed=0):
    """Correlated rows, like embeddings: a seeded mixing of normal rows."""
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)
    return (rng.normal(size=(m, d)).astype(np.float32) @ mix + 0.3).astype(np.float32)


def _fit_both(m, d=512, seed=0):
    emb = _embeddings(m, d, seed)
    jdet = JMahalanobisDetector().fit(jnp.asarray(emb), jax.random.key(seed))
    det = MahalanobisDetector().fit(torch.from_numpy(emb), perm=jax_perm(seed, m))
    return emb, jdet, det


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def test_distances_match_jax():
    _, jdet, _ = _fit_both(300)
    q = _embeddings(200, seed=1)
    want = np.asarray(jmahalanobis(jnp.asarray(q), jdet.mean, jdet.precision))
    got = mahalanobis_distances(torch.from_numpy(q), torch.from_numpy(np.array(jdet.mean)),
                                torch.from_numpy(np.array(jdet.precision)))
    assert got.dtype == torch.float32 and got.shape == (200,)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("m", [45, 300])
def test_fit_matches_jax(m):
    """45 rows: fewer than the 512 dimensions, the shrinkage keeps the
    covariance invertible."""
    _, jdet, det = _fit_both(m)
    np.testing.assert_allclose(det.mean.numpy(), np.asarray(jdet.mean), rtol=0, atol=1e-6)
    jp = np.asarray(jdet.precision)
    assert det.precision.dtype == torch.float32 and det.precision.shape == (512, 512)
    assert np.max(np.abs(det.precision.numpy() - jp)) <= 1e-4 * np.max(np.abs(jp))
    assert _rel(det.calibration_scores, jdet.calibration_scores) <= REL
    assert abs(det.threshold - jdet.threshold) <= REL * abs(jdet.threshold)
    assert det.threshold == float(det.calibration_scores.max())


def test_predict_reshapes_patch_scores_to_maps():
    emb = _embeddings(120, d=32)
    det = MahalanobisDetector(patch_level=True, batch=2, num_patches=9).fit(torch.from_numpy(emb))
    q = torch.from_numpy(_embeddings(18, d=32, seed=2))
    maps = det.predict(q)
    assert maps.shape == (2, 1, 3, 3)
    assert torch.equal(maps.reshape(-1), mahalanobis_distances(q, det.mean, det.precision))
    assert torch.equal(det.predict_labels(q), (maps > det.threshold).to(torch.int32))
    with pytest.raises(RuntimeError):
        MahalanobisDetector().predict(q)


def test_scores_do_not_read_the_tf32_flag():
    """The fit and the scores are the same with TF32 allowed and not (on
    the CPU the flag is not read; chip_smoke.py checks the card)."""
    emb = torch.from_numpy(_embeddings(200))
    q = torch.from_numpy(_embeddings(50, seed=3))
    flag = torch.backends.cuda.matmul.allow_tf32
    runs = []
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            det = MahalanobisDetector().fit(emb, torch.Generator().manual_seed(0))
            runs.append((det.precision, det.predict(q)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def _engines():
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd, strict=True)
    return inf.InferenceEngine(model, "cpu"), jax_engine(sd)


@pytest.mark.parametrize("dim,rtol,atol", [(16, 1e-5, 0.0), (32, 5e-3, 1e-4)])
@pytest.mark.parametrize("upsample_to", [None, 64])
def test_patch_maps_match_the_jax_engine(dim, rtol, atol, upsample_to):
    engine, jengine = _engines()
    rng = np.random.default_rng(5)
    x = im.normalize_imagenet(torch.from_numpy(
        rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))).numpy()
    # a Gaussian fitted to the JAX engine's window embeddings of other images
    normal = im.normalize_imagenet(torch.from_numpy(
        rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))).numpy()
    _, emb, _ = jengine.predict_patches(normal, dim, 8)
    jdet = JMahalanobisDetector().fit(emb, jax.random.key(0))
    want = np.asarray(jengine.score_patch_maps_mahalanobis(
        x, jdet.mean, jdet.precision, dim=dim, stride=8, upsample_to=upsample_to))
    got = engine.score_patch_maps_mahalanobis(
        torch.from_numpy(x), torch.from_numpy(np.array(jdet.mean)),
        torch.from_numpy(np.array(jdet.precision)), dim=dim, stride=8, upsample_to=upsample_to)
    side = (64 - dim) // 8 + 1
    assert got.shape == ((2, side, side) if upsample_to is None else (2, 64, 64))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("patch", [False, True])
def test_attach_anomaly_scores_matches_jax(patch, monkeypatch, capsys):
    """Fit + score through ``attach_anomaly_scores(scorer='mahalanobis')``
    on both sides (JAX's permutation handed over); a coreset is ignored
    with one note per process."""
    normality = _embeddings(150, d=64, seed=6)
    queries = _embeddings(2 * 9 if patch else 10, d=64, seed=7)
    shape = dict(patch_localization=patch, num_images=2 if patch else None,
                 patches_per_image=9 if patch else None)
    jout, jdet = jinf.attach_anomaly_scores(SimpleNamespace(embeddings=jnp.asarray(queries)),
                                            jnp.asarray(normality), scorer="mahalanobis",
                                            seed=3, **shape)
    monkeypatch.setattr(inf, "_coreset_noted", False)
    capsys.readouterr()
    for _ in range(2):
        out, det = inf.attach_anomaly_scores(
            SimpleNamespace(embeddings=torch.from_numpy(queries)), torch.from_numpy(normality),
            scorer="mahalanobis", coreset=10, seed=3, perm=jax_perm(3, 150), **shape)
    assert capsys.readouterr().err.count("coreset has no effect") == 1
    assert isinstance(det, MahalanobisDetector)
    assert tuple(out.anomaly_maps.shape) == tuple(jout.anomaly_maps.shape)
    assert _rel(out.anomaly_maps, jout.anomaly_maps) <= REL
    assert abs(det.threshold - jdet.threshold) <= REL * abs(jdet.threshold)
    with pytest.raises(ValueError, match="unknown scorer"):
        inf.attach_anomaly_scores(SimpleNamespace(embeddings=torch.from_numpy(queries)),
                                  torch.from_numpy(normality), scorer="lof")
