"""Localization (evaluation/localizer.py, the panel figures of
evaluation/visualization.py, ``cli localize``) against the JAX package's
(ssad_tpu/evaluation/localizer.py, visualization.py, cli.py:388-410), on
fake_mvtec's bottle with one seeded f32 model in both packages.

Held:
* patch level: both detectors fitted on the same 75 windows (3 images ×
  25 at 64²) with the same 70/30 permutation (the JAX fit's, handed to
  the port), the same threshold within 1e-6 (a score 1 − cos: measured
  3.0e-8, a quarter of f32's ulp at 1), the maps within
  ``MAP_TOL`` = 5e-5 (the bf16x3-vs-f32 k-NN gap of ≤ 3e-5 plus blur and
  resize; this bank's 53 rows take f32 on both sides: measured ≤ 2e-7),
  the predicted masks equal except at pixels within 1e-4 of the
  threshold;
* image level: the Grad-CAM maps within 1e-4 (tests/test_torch_gradcam.py);
* the segmentation overlay's tint bit-equal to the JAX package's off the
  border; the border (mask pixels with a 4-neighbour outside the mask)
  within one pixel of OpenCV's Canny edges of the mask and Canny's within
  one pixel of it (IoU 0.37–0.41: each edge is one pixel wide and Canny
  keeps the outer pixel on two sides of a shape, the inner one on the
  other two), or, without OpenCV, the hand-computed border;
``cli localize``: tests/test_torch_localizer_cli.py.

The JAX package's object masks here are its OpenCV path's, which the
port computes bit for bit without OpenCV: these comparisons need
OpenCV on the machine that runs the tests (without it the JAX package
takes its numpy fallback, which the port does not compute)."""

import numpy as np
import pytest
import torch
from _torch_eval import IMSIZE, jax_engine, jax_perm, seeded_state_dict

from ssad_tpu.config import EvalConfig as JEvalConfig
from ssad_tpu.data import mvtec as jm
from ssad_tpu.evaluation import visualization as jvis
from ssad_tpu.evaluation.localizer import Localizer as JLocalizer
from ssad_tpu_torch.config import EvalConfig, ModelConfig
from ssad_tpu_torch.data import mvtec as pm
from ssad_tpu_torch.evaluation import inference as inf
from ssad_tpu_torch.evaluation import visualization as vis
from ssad_tpu_torch.evaluation.localizer import Localizer
from ssad_tpu_torch.models.peranet import build_model

torch.set_num_threads(1)
MAP_TOL = 5e-5
CAM_TOL = 1e-4
SIZE = (IMSIZE, IMSIZE)


@pytest.fixture(scope="module")
def models():
    sd = seeded_state_dict(0)
    model = build_model(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd)
    return inf.InferenceEngine(model, "cpu"), jax_engine(sd), sd


@pytest.fixture(scope="module")
def test_data(fake_mvtec):
    return pm.prepare_mvtec_test_data(fake_mvtec, "bottle", imsize=SIZE)


def test_patch_level_maps_match_jax(models, fake_mvtec, test_data):
    engine, jengine, _ = models
    jcfg, cfg = JEvalConfig(patch_localization=True, imsize=SIZE), \
        EvalConfig(patch_localization=True, imsize=SIZE)
    jloc = JLocalizer(jengine, jcfg).setup(jm.prepare_pretext_data(fake_mvtec, "bottle",
                                                                   imsize=SIZE))
    m = 3 * 25
    loc = Localizer(engine, cfg).setup(pm.load_split(fake_mvtec, "bottle", imsize=SIZE),
                                       perm=jax_perm(0, m))
    assert loc.detector.bank.shape == tuple(jloc.detector.bank.shape) == (53, 512)
    threshold = float(jloc.detector.threshold)
    assert abs(loc.default_threshold() - threshold) <= 1e-6
    for i, image in enumerate(test_data.images):
        want = jloc.anomaly_map(image)
        got = loc.anomaly_map(image)
        assert got.shape == want.shape == SIZE and got.dtype == np.float32
        err = float(np.abs(got - want).max())
        print(f"image {i}: max |d| {err:.3g}")
        assert err <= MAP_TOL
        amap, mask = loc.localize_single_image(image)
        _, jmask = jloc.localize_single_image(image)
        near = np.abs(want - threshold) <= 1e-4
        assert np.array_equal(mask[~near], np.asarray(jmask)[~near])


def test_image_level_gradcam_maps_match_jax(models, test_data):
    engine, jengine, _ = models
    jloc = JLocalizer(jengine, JEvalConfig(imsize=SIZE)).setup(None)
    loc = Localizer(engine, EvalConfig(imsize=SIZE)).setup(None)
    assert loc.default_threshold() == 0.7 and loc.detector is None
    for image in test_data.images:
        want, got = np.asarray(jloc.anomaly_map(image)), loc.anomaly_map(image)
        assert got.shape == want.shape == SIZE
        assert float(np.abs(got - want).max()) <= CAM_TOL


def _masks():
    yy, xx = np.mgrid[0:IMSIZE, 0:IMSIZE]
    disc = (yy - 32) ** 2 + (xx - 30) ** 2 < 15 ** 2
    rect = np.zeros(SIZE, bool)
    rect[20:30, 20:40] = True
    blobs = (((yy - 12) / 6.0) ** 2 + ((xx - 45) / 9.0) ** 2 < 1) | \
        (((yy - 48) / 8.0) ** 2 + ((xx - 18) / 5.0) ** 2 < 1)
    return {"disc": disc, "rect": rect, "blobs": blobs}


@pytest.mark.parametrize("name", ["disc", "rect", "blobs"])
def test_segmentation_overlay_tint_and_border(name):
    from scipy import ndimage

    mask = _masks()[name]
    image = np.random.default_rng(1).uniform(size=SIZE + (3,)).astype(np.float32)
    got = vis.segmentation_overlay(image, mask)
    want = jvis.segmentation_overlay(image, mask)
    border = vis.mask_border(mask)
    red = (want == (255, 0, 0)).all(axis=2)
    off = ~border & ~red
    assert np.array_equal(got[off], want[off])
    assert (got[border] == (255, 0, 0)).all()
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        inner = ndimage.binary_erosion(mask, structure=ndimage.generate_binary_structure(2, 1),
                                       border_value=0)
        assert np.array_equal(border, mask & ~inner)
        return
    canny = cv2.Canny(mask.astype(np.uint8) * 255, 50, 150) > 0
    near = lambda a: ndimage.binary_dilation(a, structure=np.ones((3, 3), bool))  # noqa: E731
    assert not (canny & ~near(border)).any() and not (border & ~near(canny)).any()
    iou = (canny & border).sum() / (canny | border).sum()
    print(f"{name}: IoU with Canny {iou:.3f}")
    assert iou >= 0.3


def test_mask_border_by_hand():
    m = np.zeros((6, 7), bool)
    m[1:5, 2:6] = True
    want = m.copy()
    want[2:4, 3:5] = False
    assert np.array_equal(vis.mask_border(m), want)
    assert not vis.mask_border(np.zeros((4, 4), bool)).any()
    assert vis.mask_border(np.ones((3, 3), bool)).sum() == 8  # the image's edge is outside


@pytest.mark.parametrize("with_gt", [True, False])
def test_localization_panel_tiles(tmp_path, with_gt):
    from PIL import Image

    rng = np.random.default_rng(2)
    image = rng.uniform(size=SIZE + (3,)).astype(np.float32)
    amap = rng.uniform(size=SIZE).astype(np.float32)
    gt = (amap > 0.8).astype(np.float32) if with_gt else None
    out = vis.localization_panel(image, amap, gt, amap > 0.5, tmp_path, "x_panel.png")
    panel = np.asarray(Image.open(out))
    tiles = 6 if with_gt else 5
    assert panel.shape[1] == tiles * (IMSIZE + 4) and panel.shape[0] > IMSIZE
    top = panel.shape[0] - IMSIZE
    assert np.array_equal(panel[top:, :IMSIZE], (image * 255).astype(np.uint8))
    heat = slice(IMSIZE + 4, 2 * IMSIZE + 4)
    assert np.array_equal(panel[top:, heat], jvis.heatmap_overlay(image, amap))
    seg = slice((tiles - 1) * (IMSIZE + 4), (tiles - 1) * (IMSIZE + 4) + IMSIZE)
    assert np.array_equal(panel[top:, seg], vis.segmentation_overlay(image, amap > 0.5))
