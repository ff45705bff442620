"""The port's exact t-SNE (evaluation/tsne.py) against scikit-learn's
``TSNE``, as the JAX package calls it (ssad_tpu/evaluation/
visualization.py:114-135: two components, ``random_state=seed``,
perplexity min(30, max(5, n // 4)); Barnes-Hut, its default), on seeded
512-d Gaussian classes of the size ``evaluate`` embeds (256 artificial +
the test set).  The two optimise the same objective from different
starts (scikit-learn's randomized PCA, the port's exact one), so they are
held by trustworthiness (k = 5), not by coordinates: the port's at least
scikit-learn's − 0.02, and at least 0.9 (measured: the port 0.9609 /
0.9615 / 0.9630 against 0.9594 / 0.9602 / 0.9628); and by the objective,
the exact KL(P‖Q) of both embeddings under one P: the port's at most
``KL_RATIO`` = 1.05 times scikit-learn's (measured 0.0298 / 0.2277 /
0.3987 against 0.0307 / 0.2312 / 0.4042).  Planted faults: the PCA start
alone (the optimisation skipped: trustworthiness 0.9153 / 0.9201 /
0.9285, KL 1.36 / 1.92 / 2.32) and an ascending step (the gradient's sign
flipped: 0.46–0.50) fail both.  A halved gradient is a slower learning
rate, reaches the same optimum (KL 0.0300 / 0.2273 / 0.3991) and passes,
as it should.  The start is PCA, so the same input gives the same points
whatever the seed; ``plot_tsne`` draws them."""

import functools

import numpy as np
import pytest
import torch
from sklearn.manifold import TSNE, trustworthiness

from ssad_tpu_torch.evaluation import tsne as T
from ssad_tpu_torch.evaluation import visualization as vis

torch.set_num_threads(1)
#: (points, classes) of the three datasets
CASES = [(100, 4), (220, 5), (339, 6)]


def gaussian_classes(seed: int, n: int, classes: int):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (classes, 512))
    labels = rng.integers(0, classes, n)
    return (centers[labels] + rng.normal(0, 0.8, (n, 512))).astype(np.float32), labels


KL_RATIO = 1.05
IDS = [f"n{n}" for n, _ in CASES]


def _exact_kl(x: np.ndarray, y) -> float:
    p = T.joint_probabilities(torch.from_numpy(x), T.default_perplexity(x.shape[0]))
    return float(T._kl_and_grad(p, torch.as_tensor(y).double())[0])


@functools.lru_cache(maxsize=None)
def _sklearn(seed, case):
    """(x, scikit-learn's trustworthiness, its embedding's exact KL)."""
    x, _ = gaussian_classes(seed, *case)
    want = TSNE(n_components=2, random_state=seed,
                perplexity=T.default_perplexity(x.shape[0])).fit_transform(x)
    return x, trustworthiness(x, want, n_neighbors=5), _exact_kl(x, want)


def _against_sklearn(seed, case):
    """(the port's embedding, the failed limits) for one dataset."""
    x, t_sk, kl_sk = _sklearn(seed, case)
    got = T.tsne(torch.from_numpy(x), seed=seed).numpy()
    t_port = trustworthiness(x, got, n_neighbors=5)
    kl_port = _exact_kl(x, got)
    print(f"n={x.shape[0]}: trustworthiness port {t_port:.4f}, sklearn {t_sk:.4f}; "
          f"KL port {kl_port:.4f}, sklearn {kl_sk:.4f}")
    failed = [name for name, ok in (("trustworthiness", t_port >= t_sk - 0.02 and t_port >= 0.9),
                                    ("kl", kl_port <= KL_RATIO * kl_sk)) if not ok]
    return got, failed


@pytest.mark.parametrize("seed,case", list(enumerate(CASES)), ids=IDS)
def test_trustworthiness_against_sklearn(seed, case):
    got, failed = _against_sklearn(seed, case)
    assert got.shape == (case[0], 2) and got.dtype == np.float32 and np.isfinite(got).all()
    assert failed == []


@pytest.mark.parametrize("plant", ["pca_start_only", "ascending_step"])
@pytest.mark.parametrize("seed,case", list(enumerate(CASES)), ids=IDS)
def test_a_planted_fault_fails_the_limits(monkeypatch, seed, case, plant):
    if plant == "pca_start_only":
        monkeypatch.setattr(T, "EXPLORATION_ITERS", 0)
        monkeypatch.setattr(T, "MAX_ITERS", 0)
    else:
        kl_and_grad = T._kl_and_grad
        monkeypatch.setattr(T, "_kl_and_grad",
                            lambda p, y: (lambda kl, g: (kl, -g))(*kl_and_grad(p, y)))
    assert _against_sklearn(seed, case)[1] == ["trustworthiness", "kl"]


def test_the_same_seed_gives_the_same_points():
    x, _ = gaussian_classes(3, 120, 4)
    xt = torch.from_numpy(x)
    a = T.tsne(xt, seed=7)
    assert torch.equal(a, T.tsne(xt, seed=7)) and torch.equal(a, T.tsne(xt, seed=8))


def test_joint_probabilities_are_symmetric_and_sum_to_one():
    x, _ = gaussian_classes(4, 60, 3)
    p = T.joint_probabilities(torch.from_numpy(x), 15.0)
    assert torch.allclose(p, p.T) and abs(float(p.sum()) - 1.0) < 1e-9
    assert float(p.diagonal().abs().max()) == 0.0


def test_perplexity_rule_matches_the_jax_package():
    assert [T.default_perplexity(n) for n in (8, 40, 100, 339)] == [5.0, 10.0, 25.0, 30.0]


def test_plot_tsne_writes_the_figure(tmp_path):
    x, labels = gaussian_classes(5, 40, 4)
    labels = np.where(labels == 3, -1, labels)
    out = vis.plot_tsne(x, labels, tmp_path, "BOTTLE feature visualization", "bottle_tsne.png")
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert out.endswith("bottle_tsne.png") and img.shape[2] == 3
    for label in (0, 1, 2, -1):
        rgb = tuple(int(vis.TSNE_LABELS[label][1][i:i + 2], 16) for i in (1, 3, 5))
        assert (img == rgb).all(axis=2).any(), label
