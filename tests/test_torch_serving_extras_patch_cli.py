"""``cli export --dtype int8 --validate`` and ``cli evaluate-artifact`` of
the port against the JAX commands in patch mode, on the checkpoints of
tests/test_torch_serving_extras_cli.py (its ``models`` fixture), the port
on ``--device cpu`` with the JAX fit permutation, so both artifacts hold
the same bank.

Patch mode, int8 (measured on this CPU): each ``--validate`` drift from
its own f32 twin (port 2.574e-4, JAX 2.524e-4) within ``PATCH_DRIFT_TOL``
= 2e-5 of the other's; the two artifacts' maps of the bottle test images
within ``PATCH_MAP_TOL`` = 4e-5 (measured 2.1e-5 on maps up to 2.8e-3;
two f32 artifacts agree to 2.2e-7).  The gap is a rounding the JAX
package makes and the port does not: its int8 program hands the model
bf16 leaves, and the 32×32 windows' folded stem combines its kernel in
the leaves' dtype (the image forward is bit-equal with bf16 or f32
leaves of the same values; the patch maps move 3.6e-5), while the port
loads the dequantized bf16 values into f32 parameters.  The limit is the
bf16 map limit of tests/test_torch_evaluator_bf16.py.
``evaluate-artifact`` (``--aupro-fpr-limit 0.2``) prints exactly what the
JAX oracles compute from the port artifact's maps, to its 4 decimals,
and pixel AUROC and AUPRO within ``PATCH_METRIC_TOL`` = 2e-3 of the JAX
command's (measured 1e-4 and 4e-4); the IoU, at the optimal-F1
threshold, is ill-conditioned (1.1e-3 apart here, 2.7e-3–3.4e-3 at
bf16 in the evaluator test) and held through the oracle only.

A bfloat16 patch artifact: tests/test_torch_serving_extras.py."""

import numpy as np
import torch
from _torch_eval import IMSIZE, with_jax_draws
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from test_torch_serving_extras_cli import _last_json, models  # noqa: F401  (fixture)

from ssad_tpu_torch import cli

torch.set_num_threads(1)
PATCH_DRIFT_TOL = 2e-5
PATCH_MAP_TOL = 4e-5
PATCH_METRIC_TOL = 2e-3


def test_patch_export_validate_and_evaluate_artifact_match_jax(models, fake_mvtec, tmp_path,
                                                                capsys, monkeypatch):
    """Patch mode: an int8 artifact of each package on the same bank (the
    JAX fit permutation); ``--validate``'s drift from each package's own
    f32 twin; the two artifacts' maps of the bottle test images
    elementwise; and ``evaluate-artifact`` at a non-default
    ``--aupro-fpr-limit``, its numbers as the JAX oracles compute them from
    the port artifact's maps (module docstring)."""
    from ssad_tpu import cli as jcli
    from ssad_tpu.data import mvtec as jm
    from ssad_tpu.evaluation import metrics as JM
    from ssad_tpu.serving.export import load_scorer as jload
    from ssad_tpu_torch.serving.export import load_scorer

    port_models, jax_models = models

    def export(models_dir, out):
        return ["export", "--models-dir", str(models_dir), "--subject", "bottle", "--mode",
                "patch", "--dataset-dir", str(fake_mvtec), "--batch", "2",
                "--dtype", "int8", "--validate", "--out", str(out)]

    assert jcli.main(export(jax_models, tmp_path / "j.ssadexp")) == 0
    want = _last_json(capsys)
    with_jax_draws(monkeypatch)
    assert cli.main(export(port_models, tmp_path / "p.ssadpt") + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want) and got["mode"] == want["mode"] == "patch"
    gv, wv = got["validation"], want["validation"]
    assert set(gv) == set(wv) == {"finite", "max_abs_score_drift"}
    assert gv["finite"] is wv["finite"] is True
    assert gv["max_abs_score_drift"] < 0.05 and wv["max_abs_score_drift"] < 0.05
    assert abs(gv["max_abs_score_drift"] - wv["max_abs_score_drift"]) <= PATCH_DRIFT_TOL

    test = jm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=(IMSIZE, IMSIZE))
    port_scorer, jax_scorer = load_scorer(tmp_path / "p.ssadpt", "cpu"), jload(str(tmp_path / "j.ssadexp"))
    chunks = [test.images[lo:lo + 3] for lo in range(0, len(test.images), 3)]
    pmaps = np.concatenate([port_scorer(c)[0] for c in chunks])
    jmaps = np.concatenate([np.asarray(jax_scorer(c)[0]) for c in chunks])
    assert pmaps.shape == jmaps.shape == np.asarray(test.ground_truths).shape
    assert np.abs(pmaps - jmaps).max() <= PATCH_MAP_TOL

    evaluate = ["evaluate-artifact", "--dataset-dir", str(fake_mvtec), "--chunk", "3",
                "--aupro-fpr-limit", "0.2", "--artifact"]
    assert jcli.main(evaluate + [str(tmp_path / "j.ssadexp")]) == 0
    want = _last_json(capsys)
    assert cli.main(evaluate + [str(tmp_path / "p.ssadpt"), "--device", "cpu"]) == 0
    got = _last_json(capsys)
    gts = np.asarray(test.ground_truths)
    flat = np.nan_to_num(pmaps.ravel())
    fpr, tpr, _ = JM.roc_curve(gts.ravel() > 0, flat)
    fprs, pros = JM.compute_pro(pmaps, gts)
    oracle = {"pixel_auroc": JM.auc(fpr, tpr),
              "iou": JM.iou_score(gts.ravel(), flat, JM.optimal_f1_threshold(gts.ravel() > 0, flat)),
              "aupro": JM.compute_aupro(fprs, pros, 0.2)}
    assert set(got) == set(want)
    assert (got["dtype"], want["dtype"]) == ("int8", None)
    for key in ("subject", "mode", "scorer", "n_test"):
        assert got[key] == want[key], key
    for key, value in oracle.items():
        assert got[key] == round(float(value), 4), key
    for key in ("pixel_auroc", "aupro"):
        assert abs(got[key] - want[key]) <= PATCH_METRIC_TOL, key
