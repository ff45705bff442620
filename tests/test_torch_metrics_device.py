"""The port's fused pixel-metrics program (evaluation/metrics_device.py)
on the CPU, against the JAX package's ``pixel_metrics`` on the CPU and
against the host oracles (evaluation/metrics.py).

Bounds: against the f64 oracles, the JAX tests' own (tests/
test_metrics_device.py): 2e-4 on AUROC, F1 and IoU, 3e-4 on AUPRO, since
both programs sum in f32 (measured at most 8.5e-8).  Against the JAX
program, which runs the same f32 arithmetic in another summation order:
1e-5 on every scalar (measured at most 3.0e-7, AUPRO above 2²⁰ pixels)
and 1e-5 on every curve point (measured 1.8e-7; both take the same
quantile positions of the same stable sort).  The curves' endpoints are
(0, 0) and (1, 1) exactly.

The plotted curves are held to tests/test_metrics_device.py's rule
(tests/_torch_card_fixtures.py ``curve_faults``: no step of x or y below -1e-7, y in [0,
1 + 1e-6], the ROC's trapezoid within 5e-3 of the AUROC) on that test's
problem drawn from ``default_rng(s)`` (``_torch_card_fixtures.curve_problem``, the
same numpy rebuilt without the JAX test module so that the card test and
chip_smoke.py can draw it).  On seeds 1, 2, 16, 99 and 196 the JAX program's
PRO curve falls one f32 step from 1.0 (its f32 cumsum;
``scripts/torch_curve_sweep.py``: 86 of 200 problems); the port's does
not (0 of 200), and its AUPRO stays within JAX_TOL of JAX's there."""

import _torch_card_fixtures as fx
import numpy as np
import pytest
from test_metrics_device import _blob_gts, _correlated_maps, _host_reference

from ssad_tpu.evaluation import metrics_device as JMD
from ssad_tpu_torch.evaluation import metrics_device as MD

ORACLE_TOL = {"auroc": 2e-4, "f1": 2e-4, "iou": 2e-4, "aupro": 3e-4}
JAX_TOL = 1e-5


def _problem(seed, n, h, w, quantize=None):
    rng = np.random.default_rng(seed)
    gts = _blob_gts(rng, n, h, w)
    maps = _correlated_maps(rng, gts)
    if quantize:
        maps = np.round(maps * quantize) / quantize
    return maps.astype(np.float32), gts


CASES = {
    "continuous": dict(seed=0, n=6, h=64, w=64),
    "many_ties": dict(seed=1, n=4, h=48, w=48, quantize=8),  # ~16 levels
    "above_2_20_pixels": dict(seed=2, n=2, h=1024, w=520),  # 1,064,960 pixels
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_oracles_and_the_jax_program(case):
    maps, gts = _problem(**CASES[case])
    auroc, thr, f1, iou, aupro = _host_reference(maps, gts)
    got = MD.pixel_metrics(maps, gts)
    want = JMD.pixel_metrics(maps, gts)
    for name, ref in (("auroc", auroc), ("f1", f1), ("iou", iou), ("aupro", aupro)):
        assert abs(getattr(got, name) - ref) <= ORACLE_TOL[name], (name, getattr(got, name), ref)
        assert abs(getattr(got, name) - getattr(want, name)) <= JAX_TOL, name
    assert abs(got.threshold - want.threshold) <= JAX_TOL * max(1.0, abs(want.threshold))
    for (gx, gy), (wx, wy) in ((got.roc, want.roc), (got.pro, want.pro)):
        assert gx.shape == wx.shape == (MD.CURVE_POINTS + 2,)
        np.testing.assert_allclose(gx, wx, rtol=0, atol=JAX_TOL)
        np.testing.assert_allclose(gy, wy, rtol=0, atol=JAX_TOL)
        assert (gx[0], gy[0], gx[-1], gy[-1]) == (0.0, 0.0, 1.0, 1.0)
        assert np.all(np.diff(gx) >= 0) and np.all(np.diff(gy) >= 0)


def test_reference_layout_and_no_pro():
    maps, gts = _problem(**CASES["continuous"])
    a, b = MD.pixel_metrics(maps[:, None], gts), MD.pixel_metrics(maps, gts)
    assert a.auroc == b.auroc and a.aupro == b.aupro
    c = MD.pixel_metrics(maps, gts, with_pro=False)
    assert c.aupro is None and c.pro is None and c.auroc == b.auroc


def test_fpr_limit_interpolates_like_the_oracle():
    maps, gts = _problem(**CASES["continuous"])
    from ssad_tpu.evaluation import metrics as JM

    for limit in (0.05, 0.17, 1.0):
        fprs, pros = JM.compute_pro(maps, gts)
        want = JM.compute_aupro(fprs, pros, limit)
        assert abs(MD.pixel_metrics(maps, gts, fpr_limit=limit).aupro - want) <= 3e-4


def test_needs_both_classes():
    maps = np.random.default_rng(0).random((2, 8, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        MD.pixel_metrics(maps, np.zeros((2, 8, 8)))
    with pytest.raises(ValueError):
        MD.pixel_metrics(maps, np.ones((2, 8, 8)))


def test_pro_weights_equal_jax():
    _, gts = _problem(**CASES["continuous"])
    (got, n), (want, jn) = MD.pro_changes(gts), JMD.pro_changes(gts)
    assert n == jn and np.array_equal(got, want)


#: seed 0 (the JAX test fixture's) and five on which the JAX program's PRO
#: curve falls
CURVE_SEEDS = (0, 1, 2, 16, 99, 196)


@pytest.mark.parametrize("seed", [0, 1, 196])
def test_the_curve_problem_is_the_jax_tests(seed):
    rng = np.random.default_rng(seed)
    gts = _blob_gts(rng, 6, 64, 64)
    maps, got_gts = fx.curve_problem(seed)
    assert np.array_equal(got_gts, gts)
    assert np.array_equal(maps, _correlated_maps(rng, gts))


@pytest.mark.parametrize("seed", CURVE_SEEDS)
def test_curves_are_monotone_where_the_jax_program_dips(seed):
    maps, gts = fx.curve_problem(seed)
    got = fx.curve_faults(MD.pixel_metrics(maps, gts))
    assert got["ok"] and got["dip"] == 0.0, got
    want = fx.curve_faults(JMD.pixel_metrics(maps, gts))
    assert want["ok"] == (seed == 0), want  # the seeds were chosen for JAX's dip


@pytest.mark.parametrize("seed", CURVE_SEEDS)
def test_aupro_within_jax_tol_where_the_jax_program_dips(seed):
    maps, gts = fx.curve_problem(seed)
    got, want = MD.pixel_metrics(maps, gts), JMD.pixel_metrics(maps, gts)
    assert abs(got.aupro - want.aupro) <= JAX_TOL
    assert abs(got.auroc - want.auroc) <= JAX_TOL
    np.testing.assert_allclose(got.pro[1], want.pro[1], rtol=0, atol=JAX_TOL)


def test_the_curve_rule_catches_a_dip():
    """A planted fall of 2e-7 on the PRO curve (and a y above 1 + 1e-6)
    breaks the rule; the unplanted curves pass it."""
    maps, gts = fx.curve_problem(0)
    pm = MD.pixel_metrics(maps, gts)
    assert fx.curve_faults(pm)["ok"]
    x, y = pm.pro
    dipped = y.copy()
    dipped[-3] -= 2e-7 + (dipped[-3] - dipped[-4])
    f = fx.curve_faults(MD.PixelMetrics(**{**pm.__dict__, "pro": (x, dipped)}))
    assert not f["ok"] and not f["monotone"] and f["dip"] > fx.CURVE_STEP_TOL
    high = y.copy()
    high[-1] = 1 + 2e-6
    assert not fx.curve_faults(MD.PixelMetrics(**{**pm.__dict__, "pro": (x, high)}))[
        "monotone"]


def test_the_pro_sum_in_f64_is_the_cpus_f32_cumsum():
    """The PRO weights are summed in f64 and cast once (the card's f32 scan
    dipped); on the CPU a plain cumsum of f32 already accumulates in f64,
    so the port's PRO curve there is that of the plain sum, bit for bit."""
    import torch

    maps, gts = fx.curve_problem(1)
    got = MD.pixel_metrics(maps, gts)
    scores, _, pro, _, _, regions = MD.metric_inputs(maps, gts)
    _, order = torch.sort(-scores, stable=True)
    pro_y = torch.clamp(torch.cumsum(pro[order], 0) / float(regions), max=1.0)
    n = scores.shape[0]
    step = torch.tensor(n, dtype=torch.float32) / MD.CURVE_POINTS
    qidx = torch.clamp((torch.arange(1, MD.CURVE_POINTS + 1, dtype=torch.float32) * step)
                       .to(torch.int64), max=n - 1)
    want = np.r_[0.0, pro_y[qidx].numpy().astype(np.float64), 1.0]
    assert np.array_equal(got.pro[1], want)


def test_tied_maps_keep_monotone_curves_and_jaxs_trapezoid():
    """Maps that are 0 on most pixels (as Grad-CAM's are): the plotted
    curves stay monotone, but their quantile points skip the ends of the
    long tied runs, so the ROC's trapezoid leaves the AUROC by more than
    the JAX test's 5e-3, in both packages alike (chip_smoke phase 7 holds
    such maps to the monotone part only)."""
    maps, gts = fx.curve_problem(0)
    tied = np.where(maps > 0.9, maps, 0).astype(np.float32)
    got = fx.curve_faults(MD.pixel_metrics(tied, gts))
    want = fx.curve_faults(JMD.pixel_metrics(tied, gts))
    assert got["monotone"] and got["trapz_gap"] > fx.CURVE_TRAPZ_TOL
    assert abs(got["trapz_gap"] - want["trapz_gap"]) <= JAX_TOL
