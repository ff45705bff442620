"""Sharded inference (parallel/infer_parallel.py) on 4 CPU shards.

Against the unsharded port engine within 1e-5 (no collectives: each shard
scores its own slice; JAX's own bound, tests/test_infer_parallel.py):
the forward, window embeddings, fused patch scoring on a resident and a
tiled bank, Mahalanobis maps, ``score_maps`` with fitted detectors, a
batch that 4 does not divide (padded and trimmed), and the drivers
(``predict_mvtec``, ``normality_embeddings``) handed the sharded engine.
Against the JAX ``ShardedEngine`` on 4 of the tests' virtual CPU devices,
same f32 weights (``_torch_eval.jax_engine``), at the evaluator tests'
tolerances: the forward 1e-5 (the f32 model's), window embeddings 1e-3
and maps rtol 5e-3 / atol 1e-4 (the patch path's: bf16 windows through
the fused stem, tests/test_torch_eval_inference.py)."""

import numpy as np
import pytest
import torch
from _torch_eval import MODEL_TOL, jax_engine, seeded_state_dict

from ssad_tpu_torch.config import ModelConfig
from ssad_tpu_torch.data.mvtec import MVTecTestData
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.detector import make_detector
from ssad_tpu_torch.models.peranet import build_model
from ssad_tpu_torch.parallel.infer_parallel import ShardedEngine, maybe_shard_engine
from ssad_tpu_torch.parallel.mesh import ShardingError

torch.set_num_threads(1)

SHARDS, TOL = 4, 1e-5
PATCH_EMB_TOL, MAP_RTOL, MAP_ATOL = 1e-3, 5e-3, 1e-4
CPUS = [torch.device("cpu")] * SHARDS


@pytest.fixture(scope="module")
def sd():
    return seeded_state_dict(0)


@pytest.fixture(scope="module")
def engine(sd):
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd)
    return inf.InferenceEngine(model, "cpu")


@pytest.fixture(scope="module")
def sharded(engine):
    return maybe_shard_engine(engine, SHARDS, devices=CPUS)


def _images(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(size=(n, 64, 64, 3))
                            .astype(np.float32))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [8, 6], ids=["divisible", "indivisible"])
def test_forward_matches_the_unsharded_engine(engine, sharded, n):
    x = _images(n, seed=n)
    (l1, e1), (ln, en) = engine.predict_batch(x), sharded.predict_batch(x)
    assert ln.shape == l1.shape and en.shape == (n, 512)
    _close(ln, l1)
    _close(en, e1)


def test_patch_forward_matches(engine, sharded):
    x = _images(5, seed=2)
    l1, e1, p1 = engine.predict_patches(x, dim=32, stride=16)
    ln, en, pn = sharded.predict_patches(x, dim=32, stride=16)
    assert p1 == pn == 9 and en.shape == e1.shape == (45, 512)
    _close(en, e1)
    _close(ln, l1)


@pytest.mark.parametrize("rows", [64, 1100], ids=["resident", "tiled"])
def test_fused_patch_scoring_matches(engine, sharded, rows):
    x = _images(5, seed=3)
    bank = torch.from_numpy(np.random.default_rng(9).normal(size=(rows, 512))
                            .astype(np.float32))
    m1 = engine.score_patch_maps(x, bank, dim=32, stride=16, k=3, upsample_to=64)
    mn = sharded.score_patch_maps(x, bank, dim=32, stride=16, k=3, upsample_to=64)
    assert mn.shape == (5, 64, 64)
    _close(mn, m1)


def test_mahalanobis_scoring_matches(engine, sharded):
    x = _images(4, seed=4)
    rows = torch.from_numpy(np.random.default_rng(5).normal(size=(80, 512)).astype(np.float32))
    det = make_detector("mahalanobis").fit(rows, torch.Generator().manual_seed(0))
    m1 = engine.score_patch_maps_mahalanobis(x, det.mean, det.precision, dim=32, stride=32)
    mn = sharded.score_patch_maps_mahalanobis(x, det.mean, det.precision, dim=32, stride=32)
    _close(mn, m1)


@pytest.mark.parametrize("scorer", ["knn", "mahalanobis"])
def test_score_maps_with_a_fitted_detector(engine, sharded, scorer):
    """The evaluator's patch loop hands ``score_maps`` a detector's score."""
    x = _images(3, seed=6)
    rows = torch.from_numpy(np.random.default_rng(7).normal(size=(80, 512)).astype(np.float32))
    det = make_detector(scorer, k=3).fit(rows, torch.Generator().manual_seed(0))
    m1 = engine.score_maps(x, det.score, dim=32, stride=16, upsample_to=64)
    mn = sharded.score_maps(x, det.score, dim=32, stride=16, upsample_to=64)
    _close(mn, m1)


def test_drivers_accept_the_sharded_engine(engine, sharded):
    images = _images(5, seed=8).numpy()
    gts = np.zeros((5, 64, 64), np.float32)
    gts[3:, 20:30, 20:30] = 1
    data = MVTecTestData("bottle", (64, 64), images, gts,
                         (gts.max(axis=(1, 2)) > 0).astype(np.int32),
                         [f"img{i}.png" for i in range(5)])
    for patch in (False, True):
        o1 = inf.predict_mvtec(engine, data, batch_size=3, patch_localization=patch)
        on = inf.predict_mvtec(sharded, data, batch_size=3, patch_localization=patch)
        _close(on.embeddings, o1.embeddings)
        assert torch.equal(on.y_hat, o1.y_hat)
        n1 = inf.normality_embeddings(engine, None, images, batch_size=2,
                                      patch_localization=patch)
        nn = inf.normality_embeddings(sharded, None, images, batch_size=2,
                                      patch_localization=patch)
        _close(nn, n1)


def test_maybe_shard_engine_passthrough_and_validation(engine):
    assert maybe_shard_engine(engine, None) is engine
    assert maybe_shard_engine(engine, 1) is engine
    sharded = maybe_shard_engine(engine, 2)  # the CPU: a shard per core
    assert isinstance(sharded, ShardedEngine) and sharded.devices == CPUS[:2]
    assert sharded.model is engine.model and sharded.device == engine.device
    with pytest.raises(ShardingError, match="exceeds"):
        maybe_shard_engine(engine, 1 << 20)
    with pytest.raises(ShardingError, match="exceeds 4 available"):
        maybe_shard_engine(engine, 5, devices=CPUS)


@pytest.fixture(scope="module")
def jax_sharded(sd):
    from ssad_tpu.parallel.infer_parallel import maybe_shard_engine as jax_shard

    return jax_shard(jax_engine(sd), SHARDS)


def test_forward_matches_jax_sharded_engine(sharded, jax_sharded):
    x = _images(6, seed=10)  # padded on both sides
    (lj, ej), (ln, en) = jax_sharded.predict_batch(x.numpy()), sharded.predict_batch(x)
    _close(ln, np.asarray(lj), MODEL_TOL)
    _close(en, np.asarray(ej), MODEL_TOL)


def test_patch_scoring_matches_jax_sharded_engine(sharded, jax_sharded):
    x = _images(4, seed=11)
    bank = np.random.default_rng(12).normal(size=(64, 512)).astype(np.float32)
    _, ej, pj = jax_sharded.predict_patches(x.numpy(), dim=32, stride=32)
    _, en, pn = sharded.predict_patches(x, dim=32, stride=32)
    assert pj == pn
    np.testing.assert_allclose(en.numpy(), np.asarray(ej), rtol=0, atol=PATCH_EMB_TOL)
    mj = jax_sharded.score_patch_maps(x.numpy(), bank, dim=32, stride=32, k=3, upsample_to=64)
    mn = sharded.score_patch_maps(x, torch.from_numpy(bank), dim=32, stride=32, k=3,
                                  upsample_to=64)
    np.testing.assert_allclose(mn.numpy(), np.asarray(mj), rtol=MAP_RTOL, atol=MAP_ATOL)
