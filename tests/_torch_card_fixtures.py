"""Seeded inputs, problems and pinned digests shared by the tests,
``chip_smoke.py`` and ``scripts/``: the seeded images and MVTec-layout
trees, the object-mask corpus and its digest, the pixel-metric curve
problems and their rule, the digest of the JAX package's random stream
rebuilt in numpy, and torchvision-layout ResNet-18 weights.

Each digest is pinned here once.  The CPU tests hold the JAX package to it
(tests/test_torch_masks.py, tests/test_torch_jax_random.py) and
``chip_smoke.py`` holds the card machine to it (its ``masks:`` and
``stream:`` lines).  Nothing here imports JAX, the JAX package or OpenCV:
the card machine, which has none of them, imports this module."""

from __future__ import annotations

from pathlib import Path

import numpy as np

#: the side of the seeded images and of the trees' PNGs
IMSIZE = 256
#: train-good PNGs per category of ``write_synth_tree``'s tree
SYNTH_IMAGES = 12
#: ``write_synth_tree``'s categories: chip_smoke.py phase 5's synthesis
#: subjects, then phase 12's second fixed-pose object (last, so the others'
#: images do not move)
SYNTH_TREE = ("bottle", "hazelnut", "screw", "carpet", "cable")
#: ``write_eval_split``'s default: MVTec bottle's test split (good, then its
#: three defect types)
EVAL_SPLIT = (("good", 20), ("broken_large", 20), ("broken_small", 22), ("contamination", 21))
#: the curve sweep (chip_smoke.py phase 7, tests/test_torch_eval_cuda.py):
#: the problems (tests/test_metrics_device.py's, from default_rng(s) for s <
#: CURVE_SEEDS) and that test's rule on the plotted ROC and PRO curves:
#: every step of x and y ≥ -CURVE_STEP_TOL, y in [0, 1 + CURVE_Y_TOL], the
#: ROC's trapezoid within CURVE_TRAPZ_TOL of the AUROC
CURVE_SEEDS, CURVE_STEP_TOL, CURVE_Y_TOL, CURVE_TRAPZ_TOL = 200, 1e-7, 1e-6, 5e-3
#: the object-mask corpus: (name, subject) of each image; ``mask_corpus_image``
#: draws each from its own seed (its place here)
MASK_CORPUS = (
    ("bottle", "bottle"), ("cable_plain", "bottle"), ("capsule", "capsule"),
    ("hazelnut", "hazelnut"), ("metal_nut", "metal_nut"), ("pill", "pill"),
    ("screw", "screw"), ("toothbrush", "toothbrush"), ("transistor", "transistor"),
    ("zipper", "zipper"), ("disc_noise0", "bottle"), ("disc_noise2", "bottle"),
    ("disc_noise4", "bottle"), ("disc_noise6", "bottle"), ("disc_noise10", "bottle"),
    ("disc_smooth_texture", "bottle"), ("at_border", "bottle"), ("ring", "metal_nut"),
    ("thin_bar", "screw"), ("two_unequal", "bottle"), ("two_equal", "bottle"),
    ("blank", "bottle"), ("cable0", "cable"), ("cable1", "cable"),
    ("cross_section0", "cable"), ("cross_section1", "cable"),
)
#: SHA-256 of the bytes of ``corpus_masks(256)``, in ``MASK_CORPUS`` order:
#: the port's masks; the JAX package's OpenCV path gives the same bytes on
#: every non-cable image
MASK_DIGEST = "b0be4d21844a16d9f3c4db3ef9751fad6e43c4aab2e0b8431149ec91df9e8f2e"
#: the SHA-256 of ``JaxTrainStream(0, 32, 8, 96)``'s first batch on the
#: bottle at 256² (``_torch_jax_random.stream_digest``)
STREAM_DIGEST = "d389c4b95193862d3fccf17fad43b94385f09908697727c5ff9042a94084f6e9"


def synthetic_images(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 256, 256, 3) float32 in [0,1]: a flat colour, a vertical
    gradient and pixel noise, all seeded."""
    base = rng.uniform(0.25, 0.75, (n, 1, 1, 3))
    ramp = np.linspace(0.0, 1.0, IMSIZE)[None, :, None, None] * rng.uniform(0, 0.2, (n, 1, 1, 1))
    noise = rng.uniform(0.0, 0.1, (n, IMSIZE, IMSIZE, 3))
    return np.clip(base + ramp + noise, 0.0, 1.0).astype(np.float32)


def write_synth_tree(root: Path, seed: int = 3, images: int = SYNTH_IMAGES) -> None:
    """A seeded MVTec-layout tree of ``images`` 256² train-good PNGs per
    category: a bright disc on a noisy gradient for the objects (moving
    from image to image for the non-fixed hazelnut and screw; fixed, as
    bottle's, for cable), seeded noise for the carpet texture."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMSIZE, 0:IMSIZE]
    for cat in SYNTH_TREE:
        good = root / cat / "train" / "good"
        good.mkdir(parents=True)
        for i in range(images):
            if cat == "carpet":
                img = rng.integers(70, 130, (IMSIZE, IMSIZE, 3)).astype(np.uint8)
            else:
                img = (synthetic_images(rng, 1)[0] * 160).astype(np.uint8)
                dy, dx = ((0, 0) if cat in ("bottle", "cable")
                          else (8 * (i % 5) - 16, 6 * (i % 7) - 18))
                disc = (yy - 128 - dy) ** 2 + (xx - 128 - dx) ** 2 < 70**2
                img[disc] = np.clip(img[disc].astype(int) + 80, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(good / f"{i:03d}.png")


def write_eval_split(category_dir: Path, seed: int = 5, split=EVAL_SPLIT) -> int:
    """A seeded MVTec-layout test split beside a category's train-good
    images, ``split`` giving (type, count) pairs, by default MVTec bottle's
    counts: test/good (20) and three defect types (broken_large 20,
    broken_small 22, contamination 21) on bottle-like 256² images, each
    defect's region in ground_truth/<type>/*_mask.png.  Returns the number
    of test images."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMSIZE, 0:IMSIZE]
    c, u = IMSIZE / 2, IMSIZE / 256  # the centre; lengths are given at 256²
    n = 0
    for kind, count in split:
        test_dir = category_dir / "test" / kind
        test_dir.mkdir(parents=True)
        for i in range(count):
            img = (synthetic_images(rng, 1)[0] * 160).astype(np.uint8)
            disc = (yy - c) ** 2 + (xx - c) ** 2 < (70 * u) ** 2
            img[disc] = np.clip(img[disc].astype(int) + 80, 0, 255).astype(np.uint8)
            mask = np.zeros((IMSIZE, IMSIZE), bool)
            if kind != "good":
                blobs = {"broken_large": (1, 22, 40), "broken_small": (1, 6, 12),
                         "contamination": (4, 3, 8)}[kind]
                for _ in range(rng.integers(1, blobs[0] + 1)):
                    t = rng.uniform(0, 2 * np.pi)
                    cy, cx = c + 60 * u * np.sin(t), c + 60 * u * np.cos(t)
                    ry, rx = rng.uniform(blobs[1] * u, blobs[2] * u, 2)
                    mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
                color = (20, 20, 20) if kind.startswith("broken") else (120, 70, 20)
                img[mask] = color
                gt_dir = category_dir / "ground_truth" / kind
                gt_dir.mkdir(parents=True, exist_ok=True)
                Image.fromarray((mask * 255).astype(np.uint8)).save(gt_dir / f"{i:03d}_mask.png")
            Image.fromarray(img).save(test_dir / f"{i:03d}.png")
            n += 1
    return n


def mask_corpus_image(name: str, size: int) -> np.ndarray:
    """One seeded RGB uint8 image of ``MASK_CORPUS`` at size × size."""
    from ssad_tpu_torch import constants, parity

    rng = np.random.default_rng(1000 + [n for n, _ in MASK_CORPUS].index(name))
    generated = {"cable_plain": "cable", "cable0": "cable", "cable1": "cable"}
    if name in generated or name in constants.OBJECTS:
        return parity._make_image(rng, generated.get(name, name), size)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)

    def disc(cy, cx, r):
        return (yy - cy) ** 2 + (xx - cx) ** 2 < r**2

    img = np.full((size, size, 3), 90.0)
    if name.startswith("disc_noise"):
        img[disc(size * 0.5 + 3 * size / 256, size * 0.47, size * 0.27)] += 80
        img += rng.normal(0, float(name[len("disc_noise"):]), img.shape)
    elif name == "disc_smooth_texture":
        img += (18 * np.sin(xx * 256 / (13 * size) + rng.uniform(0, 6))
                + 14 * np.cos(yy * 256 / (19 * size)))[..., None]
        img[disc(size * 0.52, size * 0.5, size * 0.3)] += 70
        img += rng.normal(0, 2, img.shape)
    elif name == "at_border":
        img[disc(size * 0.45, size * 0.08, size * 0.3)] += 90
        img += rng.normal(0, 3, img.shape)
    elif name == "ring":
        d = np.hypot(yy - size * 0.5, xx - size * 0.52)
        img[(d < size * 0.32) & (d > size * 0.14)] = (150, 140, 120)
        img += rng.normal(0, 4, img.shape)
    elif name == "thin_bar":
        t = np.deg2rad(rng.uniform(20, 70))
        u = (xx - size / 2) * np.cos(t) + (yy - size / 2) * np.sin(t)
        v = (yy - size / 2) * np.cos(t) - (xx - size / 2) * np.sin(t)
        img[(np.abs(u) < size * 0.32) & (np.abs(v) < max(2.0, size * 0.025))] = 200
        img += rng.normal(0, 3, img.shape)
    elif name == "two_unequal":
        img[disc(size * 0.3, size * 0.3, size * 0.16)] += 80
        img[disc(size * 0.68, size * 0.66, size * 0.22)] += 80
        img += rng.normal(0, 3, img.shape)
    elif name == "two_equal":
        # one disc pasted twice, the left copy a row lower: the masks' two
        # components have equal areas, their first rows (even, then odd)
        # lie in one row of 2×2 blocks, so OpenCV's numbering (by block)
        # picks the left one where a raster order of pixels picks the right
        r = int(size * 0.12)
        py, px = np.mgrid[0:2 * r + 8, 0:2 * r + 8]
        patch = (((py - r - 4) ** 2 + (px - r - 4) ** 2 < r * r) * 80.0)[..., None]
        y0, n = {64: 10, 256: 39}[size], 2 * r + 8
        img[y0:y0 + n, int(size * 0.6):int(size * 0.6) + n] += patch
        img[y0 + 1:y0 + 1 + n, int(size * 0.1):int(size * 0.1) + n] += patch
    elif name.startswith("cross_section"):  # a cable's three insulated wires
        img[:] = (60, 58, 52)
        c = size * 0.5
        img[disc(c, c, size * 0.42)] = (175, 170, 160)
        for k, colour in enumerate([(40, 130, 60), (40, 70, 150), (120, 80, 50)]):
            a = 2 * np.pi * k / 3 + rng.uniform(-0.2, 0.2)
            cy, cx = c + size * 0.19 * np.sin(a), c + size * 0.19 * np.cos(a)
            img[disc(cy, cx, size * 0.14)] = colour
            img[disc(cy, cx, size * 0.07)] = (190, 150, 90)
        img += rng.normal(0, 5, img.shape)
    elif name != "blank":
        raise KeyError(name)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def corpus_masks(size: int) -> list:
    """The port's ``subject_mask(image, subject)`` of every ``MASK_CORPUS``
    image at ``size``."""
    from ssad_tpu_torch.data.masks import subject_mask

    return [subject_mask(mask_corpus_image(name, size), subject)
            for name, subject in MASK_CORPUS]


def mask_digest(masks) -> str:
    import hashlib

    return hashlib.sha256(b"".join(np.ascontiguousarray(m).tobytes() for m in masks)).hexdigest()


def curve_problem(seed: int, n: int = 6, h: int = 64, w: int = 64) -> tuple:
    """(maps, masks) of tests/test_metrics_device.py's problem drawn from
    ``default_rng(seed)`` (its ``_blob_gts`` then ``_correlated_maps``),
    rebuilt in numpy: blob masks on 60 % of the images, scores 0.8 on a
    blob plus N(0.3, 0.25)."""
    rng = np.random.default_rng(seed)
    gts = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        if rng.random() > 0.6:
            continue
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.integers(4, h - 4), rng.integers(4, w - 4)
            r = int(rng.integers(2, 6))
            yy, xx = np.ogrid[:h, :w]
            gts[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    if not gts.any():
        gts[0, 2:6, 2:6] = 1
    maps = gts.astype(np.float32) * 0.8 + rng.normal(0.3, 0.25, gts.shape).astype(np.float32)
    return maps, gts


def curve_faults(pm) -> dict:
    """tests/test_metrics_device.py's rule on a PixelMetrics' ROC and PRO
    curves (either package's) → {"dip": the largest fall of x or y between
    two points, 0 if none; "y_beyond": how far y leaves [0, 1]; "trapz_gap":
    |the ROC's trapezoid - the AUROC|, "ends": the x ends are 0 and 1,
    "monotone": ends, dip and y_beyond within the CURVE_* limits, "ok": the
    trapezoid too}.  The trapezoid bound is the test's, for its continuous
    scores: on maps with long runs of tied scores the plotted curve's
    quantile points skip the runs' ends, so it holds only "monotone"."""
    dip = y_beyond = 0.0
    ends = True
    for x, y in (c for c in (pm.roc, pm.pro) if c is not None):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        ends = ends and x[0] == 0.0 and x[-1] == 1.0
        dip = max(dip, float(-min(np.diff(x).min(), np.diff(y).min(), 0.0)))
        y_beyond = max(y_beyond, float(max(-y.min(), y.max() - 1.0, 0.0)))
    trapz = float(np.sum(np.diff(pm.roc[0]) * (pm.roc[1][1:] + pm.roc[1][:-1]) / 2))
    gap = abs(trapz - pm.auroc)
    monotone = bool(ends and dip <= CURVE_STEP_TOL and y_beyond <= CURVE_Y_TOL)
    return {"dip": dip, "y_beyond": y_beyond, "trapz_gap": gap, "ends": bool(ends),
            "monotone": monotone, "ok": monotone and gap <= CURVE_TRAPZ_TOL}


def curve_sweep(pixel_metrics, seeds=range(CURVE_SEEDS)) -> dict:
    """``pixel_metrics(maps, masks)`` (either package's, the maps wherever
    the caller puts them) over ``seeds``' curve problems → {"problems",
    "dipped": seeds whose curves fall, "largest_dip", "failed": seeds
    breaking any part of the rule, the largest y_beyond and trapz_gap,
    "aupro": {seed: AUPRO}}."""
    out = {"problems": 0, "dipped": [], "largest_dip": 0.0, "failed": [],
           "largest_y_beyond": 0.0, "largest_trapz_gap": 0.0, "aupro": {}}
    for s in seeds:
        pm = pixel_metrics(*curve_problem(s))
        f = curve_faults(pm)
        out["problems"] += 1
        if f["dip"] > 0:
            out["dipped"].append(s)
        if not f["ok"]:
            out["failed"].append(s)
        out["largest_dip"] = max(out["largest_dip"], f["dip"])
        out["largest_y_beyond"] = max(out["largest_y_beyond"], f["y_beyond"])
        out["largest_trapz_gap"] = max(out["largest_trapz_gap"], f["trapz_gap"])
        out["aupro"][s] = pm.aupro
    return out


def on_device_pixel_metrics(device):
    """The port's ``pixel_metrics`` with the maps moved to ``device``."""
    import torch

    from ssad_tpu_torch.evaluation import metrics_device as MD

    return lambda maps, gts: MD.pixel_metrics(torch.from_numpy(maps).to(device), gts)


def torchvision_state_dict(seed: int = 0, mean_std: float = 1.0) -> dict:
    """Seeded random weights with torchvision resnet18's keys and shapes
    (``fc.*`` zeros): convolutions N(0, fan_in^-1/2), BatchNorm scales and
    running variances U(0.5, 1.5), running means N(0, ``mean_std``) (at 1,
    far from a fresh module's zeros, as an ImageNet file's are), biases N(0,
    0.1)."""
    import torch

    from ssad_tpu_torch.config import ModelConfig
    from ssad_tpu_torch.models.peranet import build_model

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in build_model(ModelConfig()).feature_extractor.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
        elif k.endswith("running_var") or k.endswith(".weight") and v.ndim == 1:
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif v.ndim == 4:
            sd[k] = torch.from_numpy(rng.normal(0, v[0].numel() ** -0.5, v.shape)
                                     .astype(np.float32))
        else:
            std = mean_std if k.endswith("running_mean") else 0.1
            sd[k] = torch.from_numpy(rng.normal(0, std, v.shape).astype(np.float32))
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    return sd
