"""The evaluation slice's inference (evaluation/inference.py) against the
JAX package's on ``fake_mvtec`` (tests/conftest.py), f32 weights on both
sides (``_torch_eval``):

* ``predict_mvtec`` at image level: labels, masks and originals equal;
  logits and embeddings within the f32 model's 1e-5
  (tests/test_torch_models.py); at patch level within the patch path's
  1e-3 (tests/test_torch_patch_path.py: bf16 windows through the fused
  stem, whose f32 sums run in another order);
* ``attach_anomaly_scores`` with the JAX permutation: the threshold and
  the image scores to 1e-5, the patch maps' (B, 1, side, side) shape and
  values to rtol 5e-3 / atol 1e-4 (the patch path's), and ``upsample``
  of them to the same;
* ``predict_artificial``: tests/test_torch_eval_artificial.py.
"""

import numpy as np
import pytest
import torch
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_eval import IMSIZE, MODEL_TOL, jax_engine, jax_perm, seeded_state_dict

from ssad_tpu.data import mvtec as jm
from ssad_tpu.evaluation import inference as jinf
from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.data import mvtec as pm
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.peranet import build_model

PATCH_EMB_TOL, MAP_RTOL, MAP_ATOL = 1e-3, 5e-3, 1e-4


@pytest.fixture(scope="module")
def engines():
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd)
    return inf.InferenceEngine(model, "cpu"), jax_engine(sd)


@pytest.fixture(scope="module")
def test_sets(fake_mvtec):
    return (pm.prepare_mvtec_test_data(fake_mvtec, "bottle", (IMSIZE, IMSIZE)),
            jm.prepare_mvtec_test_data(fake_mvtec, "bottle", (IMSIZE, IMSIZE)))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("patch", [False, True])
def test_predict_mvtec_and_scores_match_jax(engines, test_sets, fake_mvtec, patch):
    engine, jengine = engines
    test, jtest = test_sets
    out = inf.predict_mvtec(engine, test, batch_size=3, patch_localization=patch).to_host()
    want = jinf.predict_mvtec(jengine, jtest, batch_size=3, patch_localization=patch).to_host()
    for name in ("y_true_binary", "y_true_multiclass", "ground_truths", "original_data"):
        assert np.array_equal(getattr(out, name), getattr(want, name)), name
    assert out.y_true_multiclass.tolist() == [4, 4, -1, -1]
    _close(out.tensor_data, want.tensor_data, 1e-6)
    tol = PATCH_EMB_TOL if patch else MODEL_TOL
    assert out.embeddings.shape == want.embeddings.shape == ((4 * 25 if patch else 4), 512)
    _close(out.raw_predictions, want.raw_predictions, tol)
    _close(out.embeddings, want.embeddings, tol)
    assert np.array_equal(out.y_hat, want.y_hat)

    # normality from the train split, the fit on the JAX permutation
    data = pm.prepare_pretext_data(fake_mvtec, "bottle", imsize=(IMSIZE, IMSIZE))
    jdata = jm.prepare_pretext_data(fake_mvtec, "bottle", imsize=(IMSIZE, IMSIZE))
    kw = dict(patch_localization=patch, max_images=3 if patch else None, batch_size=4)
    normality = inf.normality_embeddings(engine, None, data.train_images, **kw)
    jnormality = jinf.normality_embeddings(jengine, None, jdata, **kw)
    _close(normality, jnormality, tol)
    grid = dict(patch_localization=patch, num_images=4 if patch else None,
                patches_per_image=25 if patch else None)
    outputs = inf.predict_mvtec(engine, test, batch_size=3, patch_localization=patch)
    joutputs = jinf.predict_mvtec(jengine, jtest, batch_size=3, patch_localization=patch)
    outputs, det = inf.attach_anomaly_scores(
        outputs, normality, perm=jax_perm(0, normality.shape[0]), **grid)
    joutputs, jdet = jinf.attach_anomaly_scores(joutputs, jnormality, **grid)
    maps, jmaps = outputs.anomaly_maps.numpy(), np.asarray(joutputs.anomaly_maps)
    assert maps.shape == jmaps.shape == ((4, 1, 5, 5) if patch else (4,))
    if patch:
        np.testing.assert_allclose(maps, jmaps, rtol=MAP_RTOL, atol=MAP_ATOL)
        up = inf.upsample(outputs.anomaly_maps[:, 0], IMSIZE).numpy()
        jup = np.asarray(jinf.upsample(joutputs.anomaly_maps[:, 0], IMSIZE))
        assert up.shape == (4, IMSIZE, IMSIZE)
        np.testing.assert_allclose(up, jup, rtol=MAP_RTOL, atol=MAP_ATOL)
        assert abs(det.threshold - jdet.threshold) <= MAP_ATOL + MAP_RTOL * abs(jdet.threshold)
    else:
        _close(maps, jmaps, MODEL_TOL)
        assert abs(det.threshold - jdet.threshold) <= MODEL_TOL


def test_a_given_perm_decides_the_split(engines):
    emb = torch.from_numpy(np.random.default_rng(0).normal(size=(10, 512)).astype(np.float32))
    outputs = inf.ModelOutputs(embeddings=emb[:2])
    perm = torch.arange(10).flip(0)
    _, det = inf.attach_anomaly_scores(outputs, emb, perm=perm)
    assert torch.equal(det.bank, emb[perm[3:]])  # round(10 · 0.3) = 3 validation rows
