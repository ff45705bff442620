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
(0, 0) and (1, 1) exactly."""

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
