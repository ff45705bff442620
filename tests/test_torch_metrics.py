"""The port's host metrics (ssad_tpu_torch/evaluation/metrics.py) against
the JAX package's (ssad_tpu/evaluation/metrics.py), on the same seeded
scores: with ties, with one class only, with NaN scores.  Floats must
agree to 1e-12 (both are f64 numpy; the connected components behind
AUPRO are scipy's in both), integers and curves' lengths exactly.  The
score tables: the port's csv and LaTeX files are byte-equal to the ones
pandas writes through the JAX ``export_dataframe``, and its Markdown is
the same grid as pandas' ``to_markdown`` (tabulate's pipe table)."""

import numpy as np
import pytest

from ssad_tpu.evaluation import metrics as JM
from ssad_tpu_torch.evaluation import metrics as M

TOL = 1e-12


def _cases():
    rng = np.random.default_rng(3)
    labels = (rng.random(400) < 0.35).astype(int)
    scores = rng.normal(0.3, 0.2, 400) + 0.4 * labels
    ties = np.round(scores * 6) / 6  # ~12 levels
    nan = scores.copy()
    nan[::37] = np.nan
    return {
        "continuous": (labels, scores),
        "ties": (labels, ties),
        "all_tied": (labels, np.full(400, 0.5)),
        "one_class_negative": (np.zeros(400, int), scores),
        "one_class_positive": (np.ones(400, int), scores),
        "nan_scores": (labels, nan),
        "f32_scores": (labels, scores.astype(np.float32)),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_curves_and_scalars_match_jax(case):
    labels, scores = CASES[case]
    for got, want in zip(M.roc_curve(labels, scores), JM.roc_curve(labels, scores)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for got, want in zip(M.precision_recall_curve(labels, scores),
                         JM.precision_recall_curve(labels, scores)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    same = lambda a, b: (np.isnan(a) and np.isnan(b)) or abs(a - b) <= TOL  # noqa: E731
    assert same(M.auroc(labels, scores), JM.auroc(labels, scores))
    thr = M.optimal_f1_threshold(labels, scores)
    assert same(thr, JM.optimal_f1_threshold(labels, scores))
    for t in (thr, 0.5, -1.0):
        assert same(M.f1_score(labels, scores, t), JM.f1_score(labels, scores, t))
        assert same(M.iou_score(labels, scores, t), JM.iou_score(labels, scores, t))


def _maps(seed, n=5, size=32, quantize=None):
    rng = np.random.default_rng(seed)
    gts = np.zeros((n, size, size), np.uint8)
    for i in range(n - 1):  # the last image good
        for _ in range(rng.integers(1, 4)):
            cy, cx, r = rng.integers(4, size - 4), rng.integers(4, size - 4), rng.integers(2, 6)
            yy, xx = np.ogrid[:size, :size]
            gts[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    maps = (0.7 * gts + rng.normal(0.3, 0.25, gts.shape)).astype(np.float32)
    if quantize:
        maps = np.round(maps * quantize) / quantize
    return maps, gts


@pytest.mark.parametrize("quantize", [None, 8])
def test_pro_curve_and_aupro_match_jax(quantize):
    maps, gts = _maps(5, quantize=quantize)
    (fx, fy), (jx, jy) = M.compute_pro(maps, gts), JM.compute_pro(maps, gts)
    assert fx.shape == jx.shape
    np.testing.assert_allclose(fx, jx, rtol=0, atol=TOL)
    np.testing.assert_allclose(fy, jy, rtol=0, atol=TOL)
    for limit in (0.3, 0.05, 1.0):
        assert abs(M.aupro(maps, gts, limit) - JM.aupro(maps, gts, limit)) <= TOL
    x = np.linspace(0, 1, 11)
    assert M.trapezoid_bounded(x, x ** 2, 0.33) == JM.trapezoid_bounded(x, x ** 2, 0.33)


def test_connected_components_equal_jax():
    _, gts = _maps(9)
    for g in gts:
        got, n = M._connected_components(g > 0)
        want, jn = JM._connected_components(g > 0)
        assert n == jn and np.array_equal(got, want)


@pytest.mark.parametrize("rows", [
    {"AUC (image)": [0.5, 0.87654321, 0.99], "F1 (image)": [0.666666, 1.0, 0.25]},
    {"AUC (pixel)": [0.912345678, 0.1], "IOU": [0.1234567, 1e-7], "AUPRO": [12345678.9, 0.0]},
    {"accuracy": [float("nan"), 1.0], "f1": [0.25, 0.125], "auroc": [1.0, 0.5]},
])
def test_tables_equal_the_pandas_files(tmp_path, rows):
    index = ["bottle", "metal_nut", "average"][:len(next(iter(rows.values())))]
    port, jax_df = M.scores_dataframe(rows, index=index), JM.scores_dataframe(rows, index=index)
    for mode, name in (("csv", "t.csv"), ("latex", "t.tex"), ("markdown", "t.md")):
        got = (tmp_path / "port" / name)
        M.export_dataframe(port, tmp_path / "port", name, mode)
        JM.export_dataframe(jax_df, tmp_path / "jax", name, mode)
        assert got.read_text() == (tmp_path / "jax" / name).read_text(), mode


def test_table_refuses_a_short_column():
    with pytest.raises(ValueError):
        M.ScoreTable({"a": [1.0]}, ["x", "y"])
