"""``evaluate_categories`` in patch mode (evaluation/evaluator.py) against
the JAX package's on fake_mvtec's bottle and carpet (tests/conftest.py):
the same f32 weights written as a checkpoint of each package
(``_torch_eval.write_checkpoints``), the JAX fit permutation handed to the
port.  Held: each category's pixel AUROC, IoU and AUPRO within 1e-3
(measured at most 6.3e-6: the maps agree to the patch path's rtol 5e-3 /
atol 1e-4, tests/test_torch_patch_path.py), from the host oracles; the
same from the fused program on the CPU (``device_metrics=True``) within
the JAX program's bounds of the oracles (2e-4, AUPRO 3e-4); the curves'
endpoints; every file the JAX sweep writes, the score tables with the
same labels and layout and numbers within 1e-3 plus one unit of their
last digit.

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import numpy as np
import pytest
from _torch_eval import (
    IMSIZE, assert_tables_match, files_under, seeded_state_dict, with_jax_draws,
    write_checkpoints,
)

from ssad_tpu.config import EvalConfig as JEvalConfig
from ssad_tpu.evaluation import evaluator as jev
from ssad_tpu_torch.config import EvalConfig
from ssad_tpu_torch.evaluation import evaluator as ev

SUBJECTS = ["bottle", "carpet"]
TOL = 1e-3
KW = dict(imsize=(IMSIZE, IMSIZE), batch_size=8, patch_localization=True, device_metrics=False)


@pytest.fixture(scope="module")
def sweeps(fake_mvtec, tmp_path_factory):
    root = tmp_path_factory.mktemp("patch_sweep")
    port_models, jax_models = write_checkpoints(root, SUBJECTS, seeded_state_dict(0))
    want = jev.evaluate_categories(str(fake_mvtec), str(jax_models), SUBJECTS,
                                   JEvalConfig(**KW), str(root / "jax_out"))
    mp = pytest.MonkeyPatch()
    with_jax_draws(mp)
    try:
        got = ev.evaluate_categories(str(fake_mvtec), str(port_models), SUBJECTS,
                                     EvalConfig(**KW), str(root / "port_out"), device="cpu")
        dev = ev.evaluate_categories(str(fake_mvtec), str(port_models), SUBJECTS,
                                     EvalConfig(**{**KW, "device_metrics": True}),
                                     str(root / "port_dev"), device="cpu")
    finally:
        mp.undo()
    return root, want, got, dev


@pytest.mark.parametrize("subject", SUBJECTS)
def test_category_scores_match_jax(sweeps, subject):
    _, want, got, dev = sweeps
    w, g, d = want[subject], got[subject], dev[subject]
    for name in ("pixel_auroc", "iou", "aupro"):
        assert abs(getattr(g, name) - getattr(w, name)) <= TOL, name
    assert abs(d.pixel_auroc - g.pixel_auroc) <= 2e-4 and abs(d.iou - g.iou) <= 2e-4
    assert abs(d.aupro - g.aupro) <= 3e-4
    for curves in (g.pixel_roc, g.pro_curve, d.pixel_roc, d.pro_curve):
        x, y = curves
        assert (x[0], y[0], x[-1], y[-1]) == (0.0, 0.0, 1.0, 1.0)
    assert g.image_auroc is None and g.artificial is None


def test_sweep_writes_the_jax_files_and_tables(sweeps):
    root, *_ = sweeps
    assert files_under(root / "port_out") == files_under(root / "jax_out")
    assert_tables_match(root / "port_out" / "tables", root / "jax_out" / "tables", TOL)
    csv = (root / "port_out" / "tables" / "csv" / "patch_all_scores.csv").read_text()
    assert csv.splitlines()[0] == ",AUC (pixel),IOU,AUPRO"
    assert [r.split(",")[0] for r in csv.splitlines()[1:]] == SUBJECTS + ["average"]
    assert np.isfinite([float(v) for r in csv.splitlines()[1:] for v in r.split(",")[1:]]).all()
