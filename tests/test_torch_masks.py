"""The port's host-side object masks and the full ``prepare_pretext_data``
against the JAX package.  The port has one path, numpy (a gradient
threshold and a hole fill), which the JAX package takes where OpenCV does
not import.  Held: bit-equal to the JAX numpy path (forced by setting its
``_HAS_CV2`` to False); against the JAX OpenCV path (Canny, morphology,
the largest component), each mask within an IoU of ``MASK_IOU`` = 0.85
(measured 0.884–0.897 on these discs: the gradient mask is about 11 %
larger, the edge band the OpenCV erosion removes), the hole fills and
the images bit-equal (the coordinates and counts pack the masks, so they
are held where the masks are bit-equal)."""

import numpy as np
import pytest
from PIL import Image

from ssad_tpu.data import masks as jmasks
from ssad_tpu.data import mvtec as jmvtec
from ssad_tpu_torch.data import masks
from ssad_tpu_torch.data import mvtec

SIZE = 64
MASK_IOU = 0.85


@pytest.fixture(params=["cv2", "numpy"])
def backend(request, monkeypatch):
    """The JAX package's mask path the port is held to."""
    if request.param == "numpy":
        monkeypatch.setattr(jmasks, "_HAS_CV2", False)
    elif not jmasks._HAS_CV2:
        pytest.skip("OpenCV is not installed here")
    return request.param


def _hold(ours, theirs, backend, what=""):
    """Bit-equal to the JAX numpy path; within MASK_IOU of its OpenCV path."""
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, what
    if backend == "numpy":
        np.testing.assert_array_equal(ours, theirs, err_msg=what)
        return
    a, b = ours.reshape(-1, *ours.shape[-2:]) > 0, theirs.reshape(-1, *theirs.shape[-2:]) > 0
    iou = (a & b).sum((1, 2)) / np.maximum((a | b).sum((1, 2)), 1)
    assert iou.min() >= MASK_IOU, (what, iou)


def _disc_image(seed, shift=(0, 0), size=SIZE, base=60, gain=150):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.full((size, size, 3), base, np.uint8)
    img += rng.integers(0, 12, img.shape, dtype=np.uint8)
    disc = (yy - size // 2 - shift[0]) ** 2 + (xx - size // 2 - shift[1]) ** 2 < (size // 3) ** 2
    img[disc] = np.clip(img[disc].astype(int) + gain, 0, 255).astype(np.uint8)
    return img


@pytest.mark.parametrize("seed", range(3))
def test_object_mask_matches_jax(backend, seed):
    img = _disc_image(seed, shift=(seed - 1, 2 - seed))
    ours = masks.object_mask(img)
    _hold(ours, jmasks.object_mask(img), backend)
    assert ours.dtype == np.uint8 and 0 < ours.sum() < ours.size


def test_object_mask_blank_image_is_all_ones(backend):
    img = np.full((32, 32, 3), 128, np.uint8)
    np.testing.assert_array_equal(masks.object_mask(img), jmasks.object_mask(img))
    assert masks.object_mask(img).all()


def test_fill_holes_matches_jax_and_scipy(backend):
    from scipy.ndimage import binary_fill_holes

    rng = np.random.default_rng(0)
    for _ in range(20):
        m = rng.random((24, 24)) < 0.35
        ours = masks.fill_holes(m)
        np.testing.assert_array_equal(ours, jmasks.fill_holes(m))
        np.testing.assert_array_equal(ours.astype(bool), binary_fill_holes(m))


@pytest.mark.parametrize("subject", ["bottle", "carpet", "hazelnut"])
def test_subject_mask_and_pack_coords_match_jax(backend, subject):
    img = _disc_image(5)
    ours = masks.subject_mask(img, subject)
    _hold(ours, jmasks.subject_mask(img, subject), backend)
    for cap in (None, 100):
        c, n = masks.pack_coords(ours, cap)
        jc, jn = jmasks.pack_coords(ours, cap)
        np.testing.assert_array_equal(c, jc)
        assert n == jn


def test_pack_coords_of_an_empty_mask_matches_jax():
    c, n = masks.pack_coords(np.zeros((6, 8), np.uint8))
    jc, jn = jmasks.pack_coords(np.zeros((6, 8), np.uint8))
    np.testing.assert_array_equal(c, jc)
    assert n == jn == 0 and (c == (4, 3)).all()


@pytest.fixture(scope="module")
def mvtec_tree(tmp_path_factory):
    """An MVTec-layout tree: a fixed-pose object, a texture and two
    non-fixed objects (the disc moves from image to image), 5 train-good
    PNGs each."""
    root = tmp_path_factory.mktemp("mvtec_masks")
    for k, cat in enumerate(("bottle", "carpet", "hazelnut", "screw")):
        good = root / cat / "train" / "good"
        good.mkdir(parents=True)
        for i in range(5):
            if cat == "carpet":
                img = np.random.default_rng(100 + i).integers(70, 110, (SIZE, SIZE, 3), np.uint8)
            else:
                shift = (0, 0) if cat == "bottle" else (i - 2, 2 - i)
                img = _disc_image(10 * k + i, shift)
            Image.fromarray(img).save(good / f"{i:03d}.png")
    return root


@pytest.mark.parametrize("subject, patch", [
    ("carpet", False), ("bottle", False), ("hazelnut", False), ("screw", True),
])
def test_prepare_pretext_data_matches_jax(backend, mvtec_tree, subject, patch):
    kw = dict(imsize=(SIZE, SIZE), patch_localization=patch)
    ref = jmvtec.prepare_pretext_data(mvtec_tree, subject, **kw)
    ours = mvtec.prepare_pretext_data(mvtec_tree, subject, **kw)
    assert (ours.subject, ours.imsize) == (ref.subject, ref.imsize)
    # the counts and coordinates pack the masks: bit-equal where the masks are
    assert backend == "cv2" or ours.fixed_count == ref.fixed_count
    for name in ("train_images", "val_images", "cut_pool", "fixed_mask", "fixed_coords",
                 "train_masks", "train_coords", "train_counts", "val_masks", "val_coords",
                 "val_counts"):
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        if name.endswith("_mask") or name.endswith("_masks"):
            _hold(a, b, backend, name)
        elif backend == "numpy" or not name.endswith(("_coords", "_counts")):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.cut_pool.shape[0] == 4  # the first train-good image of each category
    if subject in ("hazelnut", "screw"):
        rows = 1 if patch else SIZE * SIZE
        assert ours.train_coords.shape == (len(ours.train_images), rows, 2)


@pytest.mark.parametrize("subject", ["bottle", "hazelnut"])
def test_load_split_is_the_pretext_split_at_the_data_config_defaults(mvtec_tree, subject):
    """The patch export's loader gives the JAX prepare_pretext_data's split
    images at the JAX DataConfig's split and seed; the port's DataConfig
    holds the same values, and its loaders and SynthSpec default to them."""
    from ssad_tpu.config import DataConfig as JaxDataConfig
    from ssad_tpu.data.synthetic import SynthSpec as JaxSynthSpec
    from ssad_tpu_torch.config import DataConfig
    from ssad_tpu_torch.data.synthetic import SynthSpec

    cfg, jcfg = DataConfig(), JaxDataConfig()
    names = ("imsize", "batch_size", "train_val_split", "seed", "patch_localization",
             "patch_size")
    assert [getattr(cfg, n) for n in names] == [getattr(jcfg, n) for n in names]
    ref = jmvtec.prepare_pretext_data(mvtec_tree, subject, imsize=(SIZE, SIZE),
                                      val_fraction=jcfg.train_val_split, seed=jcfg.seed)
    split = mvtec.load_split(mvtec_tree, subject, imsize=(SIZE, SIZE))
    full = mvtec.prepare_pretext_data(mvtec_tree, subject, imsize=(SIZE, SIZE))
    for name in ("train_images", "val_images"):
        np.testing.assert_array_equal(getattr(split, name), getattr(ref, name), err_msg=name)
        np.testing.assert_array_equal(getattr(full, name), getattr(ref, name), err_msg=name)
    assert len(split.files) == len(split.train_images) + len(split.val_images)
    ours, theirs = SynthSpec(subject=subject), JaxSynthSpec(subject=subject)
    assert (ours.imsize, ours.patch_localization, ours.patch_size) == (
        tuple(theirs.imsize), theirs.patch_localization, theirs.patch_size)
