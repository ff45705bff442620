"""k-center-greedy coreset selection (``ops/coreset.py``) and the k-NN
detector's ``fit(coreset=)`` against the JAX package's.

``jax.random.randint`` and a ``torch.Generator`` draw other first
centers, so the port is handed JAX's (``jax_coreset_first``) and, for the
fit, JAX's 70/30 permutation.  From there the selection is deterministic:
the indices must be equal, and the bank, threshold and calibration scores
within 1e-6.  A planted fault, selecting before the split, must fail the
same checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_eval import jax_coreset_first, jax_perm, with_jax_coreset_first

from ssad_tpu.models.detector import AnomalyDetector as JAnomalyDetector
from ssad_tpu.ops import coreset as jcoreset
from ssad_tpu_torch.models.detector import AnomalyDetector
from ssad_tpu_torch.ops import coreset
from ssad_tpu_torch.ops.knn import knn_cosine_scores

torch.set_num_threads(1)


def _rows(n, d=64, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_kcenter_greedy_equals_jax_given_its_first_index():
    x = _rows(2000)
    key = jax.random.key(3)
    want = np.asarray(jcoreset.kcenter_greedy(jnp.asarray(x), 64, key))
    first = int(jax.random.randint(key, (), 0, 2000))
    got = coreset.kcenter_greedy(torch.from_numpy(x), 64, first=first)
    assert got.dtype == torch.long and got.shape == (64,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.tolist())) == 64  # no row picked twice


def test_the_first_center_comes_from_the_generator():
    x = torch.from_numpy(_rows(300))
    a = coreset.kcenter_greedy(x, 16, torch.Generator().manual_seed(5))
    b = coreset.kcenter_greedy(x, 16, torch.Generator().manual_seed(5))
    first = int(torch.randint(0, 300, (), generator=torch.Generator().manual_seed(5)))
    assert torch.equal(a, b) and int(a[0]) == first


@pytest.mark.parametrize("n", [5, 16])
def test_coreset_select_is_the_identity_at_or_below_k(n):
    x = torch.from_numpy(_rows(n))
    assert coreset.coreset_select(x, 16) is x
    np.testing.assert_array_equal(
        np.asarray(jcoreset.coreset_select(jnp.asarray(x.numpy()), 16)), x.numpy())


def test_coreset_select_takes_the_selected_rows():
    x = _rows(500, seed=2)
    got = coreset.coreset_select(torch.from_numpy(x), 32, first=7)
    idx = coreset.kcenter_greedy(torch.from_numpy(x), 32, first=7)
    assert torch.equal(got, torch.from_numpy(x)[idx])


def _check_against_jax(det, jdet, emb, perm, n_val):
    """The port's fitted detector against the JAX one, and its bank drawn
    from the train split only."""
    np.testing.assert_allclose(det.bank.numpy(), np.asarray(jdet.bank), rtol=0, atol=1e-6)
    np.testing.assert_allclose(det.calibration_scores.numpy(),
                               np.asarray(jdet.calibration_scores), rtol=0, atol=1e-6)
    assert abs(det.threshold - jdet.threshold) <= 1e-6
    train_rows = {r.tobytes() for r in emb[perm[n_val:].numpy()]}
    assert all(r.tobytes() in train_rows for r in det.bank.numpy())


def _fit_both(m=600, coreset_rows=50, seed=4):
    emb = _rows(m, seed=1)
    jdet = JAnomalyDetector(k=1).fit(jnp.asarray(emb), jax.random.key(seed),
                                     coreset=coreset_rows)
    perm = jax_perm(seed, m)
    n_val = round(0.3 * m)
    first = jax_coreset_first(seed, m - n_val)
    return emb, jdet, perm, n_val, first


def test_fit_with_a_coreset_matches_jax(monkeypatch):
    emb, jdet, perm, n_val, first = _fit_both()
    with_jax_coreset_first(monkeypatch, first)
    det = AnomalyDetector(k=1).fit(torch.from_numpy(emb), perm=perm, coreset=50)
    assert det.bank.shape == (50, 64) and jdet.bank.shape == (50, 64)
    _check_against_jax(det, jdet, emb, perm, n_val)


def test_fit_keeps_every_row_when_the_coreset_is_larger():
    emb, jdet, perm, n_val, _ = _fit_both(m=60, coreset_rows=100)
    det = AnomalyDetector(k=1).fit(torch.from_numpy(emb), perm=perm, coreset=100)
    assert det.bank.shape == (60 - n_val, 64)
    _check_against_jax(det, jdet, emb, perm, n_val)


def test_a_planted_fault_selecting_before_the_split_fails():
    """The selection taken over every row and then split 70/30 (the order
    the JAX docstring warns against), sized so that the bank again has 50
    rows, must not pass the checks."""
    emb, jdet, perm, n_val, first = _fit_both()
    x = torch.from_numpy(emb)
    selected = coreset.coreset_select(x, 71, first=first)
    split = torch.randperm(71, generator=torch.Generator().manual_seed(0))
    det = AnomalyDetector(k=1)
    det.bank, val = selected[split[21:]], selected[split[:21]]
    assert det.bank.shape == jdet.bank.shape
    det.calibration_scores = knn_cosine_scores(val, det.bank, k=1)
    det.threshold = float(det.calibration_scores.max())
    with pytest.raises(AssertionError):
        _check_against_jax(det, jdet, emb, perm, n_val)
