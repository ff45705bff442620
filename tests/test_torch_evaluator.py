"""``evaluate_category`` at image level (evaluation/evaluator.py) against
the JAX package's on fake_mvtec's bottle (tests/conftest.py), from one
f32 model in both packages, with the JAX fit permutation handed to the
port (``perm=``) and the JAX artificial draws
(``_torch_eval.jax_artificial_batches``).
Patch level and the sweep's tables: tests/test_torch_evaluator_patch.py.

Tolerances (measured in brackets): image AUROC and F1 1e-6 (equal); the
Grad-CAM pixel AUROC and AUPRO 1e-3 (equal: the maps agree to 1e-4,
tests/test_torch_gradcam.py), from the host oracles and, in the port,
also from the fused program on the CPU; the artificial report's accuracy,
macro F1 and per-class rows equal, its good-vs-defect AUROC 2e-3
(8.0e-4: the two synthesizers' batches differ by up to two bf16 ulps,
tests/test_torch_eval_artificial.py, and this untrained model's p(good)
are nearly tied, so small differences reorder them).  The files are the
JAX evaluator's, ``<subject>_tsne.png`` among them (each package's own
t-SNE: tests/test_torch_tsne.py holds the port's)."""

import dataclasses

import pytest
import torch
from _torch_port import jax_masks_on_the_numpy_path  # noqa: F401  (autouse fixture)
from _torch_eval import (
    IMSIZE, files_under, jax_artificial_batches, jax_engine, jax_perm, seeded_state_dict,
)

from ssad_tpu.config import EvalConfig as JEvalConfig
from ssad_tpu.data import mvtec as jm
from ssad_tpu.evaluation import evaluator as jev
from ssad_tpu_torch.config import EvalConfig, ModelConfig
from ssad_tpu_torch.data import mvtec as pm
from ssad_tpu_torch.evaluation import evaluator as ev
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.models.peranet import build_model

EXACT, PIXEL_TOL, ART_AUROC_TOL = 1e-6, 1e-3, 2e-3


@pytest.fixture(scope="module")
def setup(fake_mvtec):
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd)
    size = (IMSIZE, IMSIZE)
    return (inf.InferenceEngine(model, "cpu"), jax_engine(sd),
            pm.prepare_pretext_data(fake_mvtec, "bottle", imsize=size),
            pm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=size),
            jm.prepare_pretext_data(fake_mvtec, "bottle", imsize=size),
            jm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=size))


@pytest.fixture(scope="module")
def jax_result(setup, tmp_path_factory):
    _, jengine, _, _, jdata, jtest = setup
    out = tmp_path_factory.mktemp("jax_eval")
    cfg = JEvalConfig(imsize=(IMSIZE, IMSIZE), batch_size=8)
    return jev.evaluate_category(jengine, None, jdata, jtest, cfg, "bottle",
                                 outputs_dir=str(out)), out


def _close(a, b, tol):
    return a is None and b is None or abs(a - b) <= tol


def _perm(data):
    """The JAX fit's permutation of the image-level normality (one row per
    train image: the checkpoint has no bank)."""
    return jax_perm(0, data.train_images.shape[0])


def test_image_level_matches_jax(setup, jax_result, tmp_path, monkeypatch):
    engine, _, data, test, _, _ = setup
    want, jout = jax_result
    monkeypatch.setattr(inf, "artificial_batches", jax_artificial_batches)
    cfg = EvalConfig(imsize=(IMSIZE, IMSIZE), batch_size=8)
    got = ev.evaluate_category(engine, None, data, test, cfg, "bottle", outputs_dir=str(tmp_path),
                               perm=_perm(data))
    assert _close(got.image_auroc, want.image_auroc, EXACT)
    assert _close(got.image_f1, want.image_f1, EXACT)
    assert _close(got.gradcam_pixel_auroc, want.gradcam_pixel_auroc, PIXEL_TOL)
    assert _close(got.gradcam_aupro, want.gradcam_aupro, PIXEL_TOL)
    assert got.pixel_auroc is None and got.iou is None and got.aupro is None
    a, b = got.artificial, want.artificial
    assert (a.accuracy, a.f1_macro, a.per_class) == (b.accuracy, b.f1_macro, b.per_class)
    assert abs(a.auroc_binary - b.auroc_binary) <= ART_AUROC_TOL
    assert files_under(tmp_path) == files_under(jout)
    assert "bottle_tsne.png" in files_under(tmp_path)
    assert (tmp_path / "bottle_artificial_report.txt").read_text().splitlines()[0] == \
        (jout / "bottle_artificial_report.txt").read_text().splitlines()[0]


def test_device_metrics_on_the_cpu_match_the_host_ones(setup, jax_result):
    """``device_metrics=True`` runs the fused program on the maps' device
    (here the CPU): the Grad-CAM pixel metrics within the JAX program's
    bounds of the host oracles (2e-4 AUROC, 3e-4 AUPRO)."""
    engine, _, data, test, _, _ = setup
    want, _ = jax_result
    cfg = EvalConfig(imsize=(IMSIZE, IMSIZE), batch_size=8, device_metrics=True)
    got = ev.evaluate_category(engine, None, data, test, cfg, "bottle", with_artificial=False,
                               perm=_perm(data))
    assert abs(got.gradcam_pixel_auroc - want.gradcam_pixel_auroc) <= 2e-4
    assert abs(got.gradcam_aupro - want.gradcam_aupro) <= 3e-4
    assert _close(got.image_auroc, want.image_auroc, EXACT)


def test_library_evaluator_matches_jax(setup):
    """``Evaluator`` (tools.Evaluator's dispatch) on the same outputs."""
    import numpy as np

    rng = np.random.default_rng(0)
    gts = (rng.random((3, 16, 16)) > 0.8).astype(np.float32)
    maps = (gts + rng.normal(0, 0.5, gts.shape)).astype(np.float32)
    outputs = inf.ModelOutputs(ground_truths=torch.from_numpy(gts),
                               anomaly_maps=torch.from_numpy(maps))
    metrics = ("auroc", "aupro", "iou")
    got = ev.Evaluator(metrics).evaluate(outputs, "bottle", patch_level=True)
    want = jev.Evaluator(metrics).evaluate(outputs.to_host(), "bottle", patch_level=True)
    assert dataclasses.asdict(got) == pytest.approx(dataclasses.asdict(want), abs=1e-12)
    with pytest.raises(ValueError):
        ev.Evaluator(("f1-score",)).evaluate(outputs, "bottle", patch_level=True)
    with pytest.raises(ValueError):
        ev.Evaluator(("dice",))
