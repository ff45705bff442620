"""The port's host-side object masks (numpy + scipy, no OpenCV) against the
JAX package's OpenCV path, bit for bit, and the full
``prepare_pretext_data``.

* The corpus (tests/_torch_card_fixtures.py ``MASK_CORPUS``, at 64² and 256²): the ten
  object subjects of the parity generator, discs on noise σ 0–10 and on
  a smooth texture, an object at the border, a ring, a thin bar, two
  objects of different and of equal size, a blank image.  Each mask
  ``np.array_equal`` to ``ssad_tpu.data.masks.object_mask``.
* Each stage against its own ``cv2`` call, fed the previous stage's
  OpenCV output: gray, blur, Canny, dilate, close, erode, the component
  choice; gray and Lab over every 8-bit colour; blur and Canny on
  random images; the component numbering on random masks.
  ``connectedComponentsWithStats`` numbers components by their first
  2×2 block, not their first pixel: the corpus's two equal discs tell
  the two orders apart.
* Three planted faults (edits of the port's source) must each break the
  corpus: the suppression's ``>=`` as ``>``, the 4×4 erosion anchored at
  (1, 1), the blur as OpenCV blurs a float image (the exact kernel, σ·4
  a side, rounded once).  The float image's size rule alone is no fault
  at these σ: the taps it adds quantise to 0 (held too).
* Cable: ``cv2.kmeans`` draws from OpenCV's per-thread generator, which
  the JAX function never seeds.  Given OpenCV's own draws (its generator
  emulated here), the port's k-means labels, posterized image and mask
  equal OpenCV's; with its own seeded draws the port's mask is the same
  for a seed and within an IoU of 0.99 of each of 6 consecutive JAX calls
  (measured minimum 0.9919, JAX's own spread 0.9919–1.0 on these images;
  OpenCV's generator seeded once per image, so the calls are the same
  on every run).

These comparisons need OpenCV on the machine that runs the tests (the
JAX package's declared dependency); the port's masks do not."""

import inspect
import types

import _torch_card_fixtures as fx
import numpy as np
import pytest
from PIL import Image

from ssad_tpu.data import masks as jmasks
from ssad_tpu.data import mvtec as jmvtec
from ssad_tpu_torch.data import masks
from ssad_tpu_torch.data import mvtec

SIZE = 64
SIZES = (64, 256)
OBJECTS = [name for name, subject in fx.MASK_CORPUS if subject != "cable"]
CABLES = [name for name, subject in fx.MASK_CORPUS if subject == "cable"]
CABLE_IOU = 0.99


@pytest.fixture(scope="module")
def cv2():
    """OpenCV, imported directly; the JAX package's masks on its path."""
    mod = pytest.importorskip("cv2")
    if not jmasks._HAS_CV2:
        pytest.skip("the JAX package does not take its OpenCV path here")
    return mod


_IMAGES = {}


def corpus_image(name, size):
    if (name, size) not in _IMAGES:
        _IMAGES[name, size] = fx.mask_corpus_image(name, size)
    return _IMAGES[name, size]


def corpus(sizes=SIZES, names=OBJECTS):
    return [(f"{n}@{s}", corpus_image(n, s)) for s in sizes for n in names]


@pytest.mark.parametrize("name", OBJECTS)
@pytest.mark.parametrize("size", SIZES)
def test_object_mask_is_the_jax_opencv_path(cv2, size, name):
    img = corpus_image(name, size)
    ours = masks.object_mask(img)
    theirs = jmasks.object_mask(img)
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    subject = dict(fx.MASK_CORPUS)[name]
    np.testing.assert_array_equal(masks.subject_mask(img, subject),
                                  jmasks.subject_mask(img, subject))


def test_the_corpus_draws_the_jax_parity_generators_images():
    from ssad_tpu import parity as jparity

    for name in ("bottle", "hazelnut", "screw", "cable0"):
        rng = np.random.default_rng(1000 + [n for n, _ in fx.MASK_CORPUS].index(name))
        subject = "cable" if name.startswith("cable") else name
        np.testing.assert_array_equal(corpus_image(name, 64), jparity._make_image(rng, subject, 64))


def _stage_pairs(cv2, img):
    """(stage, OpenCV's output, the port's from OpenCV's input) of every
    stage of ``object_mask``."""
    k3 = np.ones((3, 3), np.uint8)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    yield "gray", gray, masks.rgb_to_gray(img)
    blur = cv2.GaussianBlur(gray, (0, 0), sigmaX=1.5)
    yield "blur", blur, masks.gaussian_blur_u8(gray, 1.5)
    edges = cv2.Canny(blur, 5, 15)
    yield "canny", edges, masks.canny(blur, 5, 15)
    dil = cv2.dilate(edges, k3)
    yield "dilate", dil, masks.dilate(edges, 3)
    closed = cv2.morphologyEx(dil, cv2.MORPH_CLOSE, k3)
    yield "close", closed, masks.close(dil, 3)
    filled = masks.fill_holes(closed > 0).astype(np.uint8) * 255
    eroded = cv2.erode(filled, np.ones((4, 4), np.uint8))
    yield "erode", eroded, masks.erode(filled, 4)
    yield "components", _opencv_largest(cv2, eroded), masks.largest_component(eroded)


def _opencv_largest(cv2, m):
    """The JAX package's component choice (ssad_tpu/data/masks.py:53-58)."""
    n, labels, stats, _ = cv2.connectedComponentsWithStats((m > 0).astype(np.uint8),
                                                           connectivity=8)
    if n <= 1:
        return np.ones(m.shape, np.uint8)
    return (labels == 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))).astype(np.uint8)


@pytest.mark.parametrize("stage", ["gray", "blur", "canny", "dilate", "close", "erode",
                                   "components"])
def test_each_stage_is_its_opencv_call_on_the_corpus(cv2, stage):
    for what, img in corpus():
        for name, theirs, ours in _stage_pairs(cv2, img):
            if name == stage:
                assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, what
                np.testing.assert_array_equal(ours, theirs, err_msg=what)


def _every_colour(chunk):
    """Every 8-bit RGB colour, ``chunk`` red levels at a time, as images."""
    g, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for r0 in range(0, 256, chunk):
        r = np.arange(r0, r0 + chunk)[:, None, None]
        yield np.stack(np.broadcast_arrays(r, g[None], b[None]), -1).reshape(
            chunk * 256, 256, 3).astype(np.uint8)


@pytest.mark.parametrize("conversion", ["gray", "lab"])
def test_colour_conversions_are_opencvs_on_every_colour(cv2, conversion):
    code, ours = {"gray": (cv2.COLOR_RGB2GRAY, masks.rgb_to_gray),
                  "lab": (cv2.COLOR_RGB2LAB, masks.rgb_to_lab)}[conversion]
    for img in _every_colour(16):
        np.testing.assert_array_equal(ours(img), cv2.cvtColor(img, code))


@pytest.mark.parametrize("sigma, taps", [(1.5, 11), (2.0, 13)])
def test_blur_is_opencvs_on_random_images(cv2, sigma, taps):
    k = masks.gaussian_taps_u8(sigma)
    assert len(k) == taps and k.sum() == 256 and (k == k[::-1]).all()
    rng = np.random.default_rng(int(sigma * 10))
    for i in range(24):
        shape = tuple(rng.integers(14, 120, 2)) + ((3,) if i % 2 else ())
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        if i % 3 == 0:
            img = cv2.GaussianBlur(img, (0, 0), 3)
        np.testing.assert_array_equal(masks.gaussian_blur_u8(img, sigma),
                                      cv2.GaussianBlur(img, (0, 0), sigmaX=sigma))


def test_canny_is_opencvs_on_random_images(cv2):
    rng = np.random.default_rng(0)
    for i in range(48):
        img = rng.integers(0, 256, tuple(rng.integers(8, 120, 2)), dtype=np.uint8)
        img = masks.gaussian_blur_u8(img, float(rng.choice([0.8, 1.5, 3.0])))
        low, high = [(5, 15), (10, 40), (1, 3), (20, 60)][i % 4]
        np.testing.assert_array_equal(masks.canny(img, low, high), cv2.Canny(img, low, high))


def test_component_choice_is_opencvs_numbering(cv2):
    """Masks of many equal-area components: the port keeps the one OpenCV
    numbers first; on the corpus's two equal discs that is the left one,
    whose first pixel lies a row below the right one's."""
    rng = np.random.default_rng(1)
    for i in range(60):
        h, w = rng.integers(4, 200, 2)
        m = np.zeros((h, w), np.uint8)
        if i % 2:
            m[rng.random((h, w)) < 0.1] = 255
        for _ in range(rng.integers(0, 30)):
            y, x = rng.integers(0, h), rng.integers(0, w)
            m[y:y + 2, x:x + 2] = 255
        np.testing.assert_array_equal(masks.largest_component(m), _opencv_largest(cv2, m))
    for size in SIZES:
        img = corpus_image("two_equal", size)
        stages = {name: theirs for name, theirs, _ in _stage_pairs(cv2, img)}
        _, labels, stats, _ = cv2.connectedComponentsWithStats(
            (stages["erode"] > 0).astype(np.uint8), connectivity=8)
        assert len(stats) == 3 and stats[1, 4] == stats[2, 4]  # equal areas
        first_rows = [np.nonzero(labels == k)[0].min() for k in (1, 2)]
        assert first_rows[0] == first_rows[1] + 1 and stats[1, 0] < stats[2, 0]
        np.testing.assert_array_equal(masks.object_mask(img), labels == 1)


def test_object_mask_blank_image_is_all_ones(cv2):
    img = np.full((32, 32, 3), 128, np.uint8)
    np.testing.assert_array_equal(masks.object_mask(img), jmasks.object_mask(img))
    assert masks.object_mask(img).all()


def test_fill_holes_matches_jax_and_scipy(cv2):
    from scipy.ndimage import binary_fill_holes

    rng = np.random.default_rng(0)
    for _ in range(20):
        m = rng.random((24, 24)) < 0.35
        ours = masks.fill_holes(m)
        np.testing.assert_array_equal(ours, jmasks.fill_holes(m))
        np.testing.assert_array_equal(ours.astype(bool), binary_fill_holes(m))


def _disc_image(seed, shift=(0, 0), size=SIZE, base=60, gain=150):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.full((size, size, 3), base, np.uint8)
    img += rng.integers(0, 12, img.shape, dtype=np.uint8)
    disc = (yy - size // 2 - shift[0]) ** 2 + (xx - size // 2 - shift[1]) ** 2 < (size // 3) ** 2
    img[disc] = np.clip(img[disc].astype(int) + gain, 0, 255).astype(np.uint8)
    return img


@pytest.mark.parametrize("subject", ["bottle", "carpet", "hazelnut"])
def test_subject_mask_and_pack_coords_match_jax(cv2, subject):
    img = _disc_image(5)
    ours = masks.subject_mask(img, subject)
    np.testing.assert_array_equal(ours, jmasks.subject_mask(img, subject))
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


#: source edits of ssad_tpu_torch/data/masks.py that the corpus must catch
PLANTS = {
    "suppression_strict_ahead": ("mag >= ahead", "mag > ahead"),
    "erosion_anchor_1_1": ("anchor = ksize // 2", "anchor = (ksize - 1) // 2"),
    # OpenCV's float-image blur: the exact kernel at σ·4 a side, rounded once
    "blur_as_for_a_float_image": (
        "    return ((both + (1 << 15)) >> 16).astype(np.uint8)",
        "    return np.rint(ndimage.gaussian_filter(image_u8.astype(np.float64), sigma, "
        "mode='mirror', truncate=4.0, axes=(0, 1))).astype(np.uint8)"),
}


def _planted(old, new):
    src = inspect.getsource(masks)
    assert src.count(old) == 1
    planted = types.ModuleType("planted_masks")
    exec(compile(src.replace(old, new), masks.__file__, "exec"), planted.__dict__)
    return planted


def _broken_by(planted):
    return [what for what, img in corpus()
            if not np.array_equal(planted.object_mask(img), jmasks.object_mask(img))]


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_a_planted_fault_breaks_the_corpus(cv2, plant):
    broken = _broken_by(_planted(*PLANTS[plant]))
    print(plant, "breaks", len(broken), "of", len(OBJECTS) * len(SIZES), broken)
    assert broken


def test_the_float_images_blur_size_alone_moves_no_8bit_tap(cv2):
    """OpenCV sizes an 8-bit blur at σ·3 a side, a float one at σ·4; at
    σ 1.5 and 2 the taps the larger size adds quantise to 0, so that rule
    alone changes no blurred pixel and no mask."""
    for sigma in (1.5, 2.0):
        taps = masks.gaussian_taps_u8(sigma)
        wider = _planted("sigma * 3 * 2 + 1", "sigma * 4 * 2 + 1").gaussian_taps_u8(sigma)
        pad = (len(wider) - len(taps)) // 2
        assert pad > 0
        np.testing.assert_array_equal(wider, np.pad(taps, pad))
    assert _broken_by(_planted("sigma * 3 * 2 + 1", "sigma * 4 * 2 + 1")) == []


class OpenCVDraws:
    """``cv::RNG`` (multiply-with-carry): ``integers(n)`` is ``(unsigned)
    rng % n``, ``random()`` is ``(double)rng``, so the port's k-means
    makes the draws ``cv2.kmeans`` makes after ``cv2.setRNGSeed(seed)``."""

    def __init__(self, seed):
        self.state = seed or 0xFFFFFFFF

    def _next(self):
        self.state = ((self.state & 0xFFFFFFFF) * 4164903690 + (self.state >> 32)) % (1 << 64)
        return self.state & 0xFFFFFFFF

    def integers(self, n):
        return self._next() % n

    def random(self):
        hi = self._next()
        return float((hi << 32) | self._next()) * 2.0**-64


@pytest.mark.parametrize("name", CABLES)
def test_cable_posterization_is_opencvs_given_its_draws(cv2, name):
    img = corpus_image(name, 256)
    blurred = cv2.GaussianBlur(img, (0, 0), sigmaX=2.0)
    np.testing.assert_array_equal(masks.gaussian_blur_u8(img, 2.0), blurred)
    lab = cv2.cvtColor(blurred, cv2.COLOR_RGB2LAB).reshape(-1, 3)
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 20, 1.0)
    for seed in (1, 2024):
        cv2.setRNGSeed(seed)
        _, theirs, _ = cv2.kmeans(lab.astype(np.float32), 5, None, criteria, 3,
                                  cv2.KMEANS_PP_CENTERS)
        labels = masks.kmeans(lab, 5, OpenCVDraws(seed))
        np.testing.assert_array_equal(labels, theirs.ravel())
        cv2.setRNGSeed(seed)
        posterized = jmasks.posterize_cable(img)
        ours = masks.paint_clusters(img, labels)
        np.testing.assert_array_equal(ours, posterized)
        np.testing.assert_array_equal(masks.object_mask(ours), jmasks.object_mask(posterized))


def _iou(a, b):
    return float((a & b).sum() / max((a | b).sum(), 1))


@pytest.mark.parametrize("name", CABLES)
def test_cable_mask_is_seeded_and_within_the_jax_spread(cv2, name):
    img = corpus_image(name, 256)
    ours = masks.subject_mask(img, "cable")
    np.testing.assert_array_equal(masks.subject_mask(img, "cable"), ours)
    np.testing.assert_array_equal(masks.posterize_cable(img, seed=3),
                                  masks.posterize_cable(img, seed=3))
    cv2.setRNGSeed(CABLES.index(name) + 1)
    theirs = [jmasks.subject_mask(img, "cable") for _ in range(6)]
    ious = [_iou(ours, t) for t in theirs]
    spread = [_iou(theirs[0], t) for t in theirs[1:]]
    print(name, "port vs JAX", ious, "JAX vs its first call", spread)
    assert min(ious) >= CABLE_IOU, (ious, spread)
    assert 0.2 < ours.mean() < 0.8


def test_the_corpus_digest_is_chip_smokes(cv2):
    ours = fx.corpus_masks(256)
    assert fx.mask_digest(ours) == fx.MASK_DIGEST
    reference = [ours[i] if subject == "cable"
                 else jmasks.object_mask(corpus_image(name, 256))
                 for i, (name, subject) in enumerate(fx.MASK_CORPUS)]
    assert fx.mask_digest(reference) == fx.MASK_DIGEST


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
def test_prepare_pretext_data_matches_jax(cv2, mvtec_tree, subject, patch):
    kw = dict(imsize=(SIZE, SIZE), patch_localization=patch)
    ref = jmvtec.prepare_pretext_data(mvtec_tree, subject, **kw)
    ours = mvtec.prepare_pretext_data(mvtec_tree, subject, **kw)
    assert (ours.subject, ours.imsize) == (ref.subject, ref.imsize)
    assert ours.fixed_count == ref.fixed_count
    for name in ("train_images", "val_images", "cut_pool", "fixed_mask", "fixed_coords",
                 "train_masks", "train_coords", "train_counts", "val_masks", "val_coords",
                 "val_counts"):
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
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
