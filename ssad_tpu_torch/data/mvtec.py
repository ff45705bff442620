"""MVTec-AD images: decoding, the train/val split, the train-good arrays
of one subject and its test set.

Counterpart of ssad_tpu/data/mvtec.py:25-38 (load_image), :41-50
(load_mask), :53-63 (load_stack), :66-87 (load_mask_stack),
:90-102 (train_val_split), :105-217 (PretextData, prepare_pretext_data:
the split images with the cut pool and object masks the pretext
synthesizer reads) and :221-252 (MVTecTestData,
prepare_mvtec_test_data).  ``load_split`` is the split images alone,
which is all the patch export reads; ``data.masks`` (OpenCV) is imported
only where masks are made.  ``load_stack`` and ``load_mask_stack`` decode
through the native threaded loader (ssad_tpu_torch/native) when it is
built, and through PIL otherwise and for the files it leaves to PIL
(palette, alpha and 16-bit PNGs, decode failures), as the JAX package's
do.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ssad_tpu_torch import constants
from ssad_tpu_torch.config import DataConfig
from ssad_tpu_torch.utils import filesystem as fs

_DATA = DataConfig()


def load_image(path, imsize: Tuple[int, int]) -> np.ndarray:
    """Decode + resize one image (path or binary file object) to
    (H, W, 3) float32 in [0, 1], in the reference's PIL
    open → resize → convert('RGB') order (PIL's default resample)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.resize((imsize[1], imsize[0])).convert("RGB")
        return np.asarray(img, np.float32) / 255.0


def load_mask(path: Optional[str | Path], imsize: Tuple[int, int]) -> np.ndarray:
    """GT mask → (H, W) float {0,1}: PIL resize, grey, > 127; blank when
    ``path`` is None (reference functional.py:20-24)."""
    if path is None:
        return np.zeros(imsize, np.float32)
    from PIL import Image

    with Image.open(path) as img:
        img = img.resize((imsize[1], imsize[0])).convert("L")
        return (np.asarray(img, np.float32) > 127).astype(np.float32)


def load_stack(paths: Sequence[str], imsize: Tuple[int, int]) -> np.ndarray:
    """Decode + resize a list of images → (N, H, W, 3) float32: the native
    loader when it is built and takes the files, else ``load_image``."""
    if not paths:
        return np.zeros((0,) + tuple(imsize) + (3,), np.float32)
    from ssad_tpu_torch import native

    batch = native.decode_resize_batch(paths, imsize, channels=3)
    if batch is not None:
        return batch
    return np.stack([load_image(p, imsize) for p in paths])


def load_mask_stack(paths: Sequence[Optional[str]], imsize: Tuple[int, int]) -> np.ndarray:
    """GT masks (None: blank) → (N, H, W) float {0,1}: a native grayscale
    decode of the given paths (> 127 as in ``load_mask``) when it takes
    them, else ``load_mask``."""
    out = np.zeros((len(paths),) + tuple(imsize), np.float32)
    real = [(i, p) for i, p in enumerate(paths) if p is not None]
    if not real:
        return out
    from ssad_tpu_torch import native

    batch = native.decode_resize_batch([p for _, p in real], imsize, channels=1)
    if batch is not None:
        idx = np.asarray([i for i, _ in real])
        out[idx] = (batch[..., 0] > (127.0 / 255.0)).astype(np.float32)
        return out
    for i, p in real:
        out[i] = load_mask(p, imsize)
    return out


def train_val_split(
    filenames: Sequence[str], val_fraction: float, seed: int
) -> Tuple[List[str], List[str]]:
    """Deterministic shuffled split: a numpy permutation seeded with
    ``seed``, the first ceil(n · val_fraction) files to val."""
    files = list(filenames)
    idx = np.random.default_rng(seed).permutation(len(files))
    n_val = int(np.ceil(len(files) * val_fraction))
    return [files[i] for i in idx[n_val:]], [files[i] for i in idx[:n_val]]


@dataclasses.dataclass
class SplitImages:
    """The train-good images of one subject, split into train and val.

    As in the JAX package, train trains and val validates (the reference
    swaps the two lists, datasets.py:475-489; that quirk is not kept)."""

    subject: str
    imsize: Tuple[int, int]
    files: List[str]  # every train-good file, before the split
    train_images: np.ndarray  # (Nt, H, W, 3) float32
    val_images: np.ndarray  # (Nv, H, W, 3)


@dataclasses.dataclass
class PretextData:
    """Everything the pretext synthesizer needs for one subject: the split
    images of ``SplitImages``, the cut pool and the object masks."""

    subject: str
    imsize: Tuple[int, int]
    train_images: np.ndarray  # (Nt, H, W, 3) float32
    val_images: np.ndarray  # (Nv, H, W, 3)
    cut_pool: np.ndarray  # (K, H, W, 3) first train-good image per category
    fixed_mask: np.ndarray  # (H, W) float {0,1}
    fixed_coords: np.ndarray  # (H·W, 2) int32
    fixed_count: int
    # per-image masks of NON_FIXED_OBJECTS subjects (datasets.py:232-235);
    # in patch mode the coordinates are 1-row placeholders
    train_masks: Optional[np.ndarray] = None  # (Nt, H, W)
    train_coords: Optional[np.ndarray] = None  # (Nt, H·W, 2) int32
    train_counts: Optional[np.ndarray] = None  # (Nt,)
    val_masks: Optional[np.ndarray] = None
    val_coords: Optional[np.ndarray] = None
    val_counts: Optional[np.ndarray] = None


def _image_masks(images: np.ndarray, imsize: Tuple[int, int], patch_localization: bool):
    """Per-image (masks, coords, counts).  In patch mode the synthesizer
    samples from the cropped mask on the device, so the (N, H·W, 2)
    coordinate stacks are never read: 1-row placeholders stand in."""
    from ssad_tpu_torch.data import masks as masks_mod

    coord_rows = 1 if patch_localization else imsize[0] * imsize[1]
    ms, cs, ns = [], [], []
    for img in images:
        m = masks_mod.object_mask((img * 255).astype(np.uint8))
        if patch_localization:
            c, n = np.zeros((1, 2), np.int32), 0
        else:
            c, n = masks_mod.pack_coords(m)
        ms.append(m.astype(np.float32))
        cs.append(c)
        ns.append(n)
    if not ms:
        return (np.zeros((0,) + tuple(imsize), np.float32),
                np.zeros((0, coord_rows, 2), np.int32), np.zeros((0,), np.int32))
    return np.stack(ms), np.stack(cs), np.asarray(ns, np.int32)


def load_split(
    dataset_dir: str | Path,
    subject: str,
    imsize: Tuple[int, int] = _DATA.imsize,
    val_fraction: float = _DATA.train_val_split,
    seed: int = _DATA.seed,
) -> SplitImages:
    """Discover, decode and split the train-good images of one subject of
    an MVTec-layout tree (reference PretextTaskDatamodule.prepare_filenames,
    datasets.py:438-466; without the file-list duplication, :447-457)."""
    imsize = tuple(imsize)
    subject_dir = Path(dataset_dir) / subject
    files = fs.train_good_images(subject_dir)
    if not files:
        raise FileNotFoundError(f"no train images under {subject_dir}/train/good")
    train_files, val_files = train_val_split(files, val_fraction, seed)
    return SplitImages(subject=subject, imsize=imsize, files=files,
                       train_images=load_stack(train_files, imsize),
                       val_images=load_stack(val_files, imsize))


def prepare_pretext_data(
    dataset_dir: str | Path,
    subject: str,
    imsize: Tuple[int, int] = _DATA.imsize,
    val_fraction: float = _DATA.train_val_split,
    seed: int = _DATA.seed,
    patch_localization: bool = _DATA.patch_localization,
) -> PretextData:
    """``load_split`` plus the cut pool and the object masks of
    PretextTaskDataset's setup (datasets.py:166-206)."""
    from ssad_tpu_torch.data import masks as masks_mod

    split = load_split(dataset_dir, subject, imsize, val_fraction, seed)
    imsize = split.imsize
    root = Path(dataset_dir)

    # cut pool: the first train-good image of every category (datasets.py:189-193)
    pool = []
    for cat in fs.list_categories(root):
        cat_files = fs.train_good_images(root / cat)
        if cat_files:
            pool.append(load_image(cat_files[0], imsize))
    cut_pool = np.stack(pool) if pool else split.train_images[:1]

    # the subject's fixed mask, from its first image (datasets.py:195-206)
    if constants.is_texture(subject):
        fixed_mask = np.ones(imsize, np.uint8)
    else:
        first_u8 = (load_image(split.files[0], imsize) * 255).astype(np.uint8)
        fixed_mask = masks_mod.subject_mask(first_u8, subject)
    fixed_coords, fixed_count = masks_mod.pack_coords(fixed_mask)

    data = PretextData(
        subject=subject,
        imsize=imsize,
        train_images=split.train_images,
        val_images=split.val_images,
        cut_pool=cut_pool,
        fixed_mask=fixed_mask.astype(np.float32),
        fixed_coords=fixed_coords,
        fixed_count=fixed_count,
    )
    if constants.is_non_fixed_object(subject):
        data.train_masks, data.train_coords, data.train_counts = _image_masks(
            split.train_images, imsize, patch_localization)
        data.val_masks, data.val_coords, data.val_counts = _image_masks(
            split.val_images, imsize, patch_localization)
    return data


@dataclasses.dataclass
class MVTecTestData:
    """The test set of one subject (reference MVTecDataset,
    datasets.py:50-84)."""

    subject: str
    imsize: Tuple[int, int]
    images: np.ndarray  # (N, H, W, 3) float32, un-normalized
    ground_truths: np.ndarray  # (N, H, W) float {0,1}
    labels: np.ndarray  # (N,) {0,1}
    filenames: List[str]


def prepare_mvtec_test_data(dataset_dir: str | Path, subject: str,
                            imsize: Tuple[int, int] = (256, 256)) -> MVTecTestData:
    """Every ``test/<defect>/*.png`` of the subject (``fs.test_images``
    order), its GT mask (blank for 'good') and its label."""
    subject_dir = Path(dataset_dir) / subject
    files = fs.test_images(subject_dir)
    if not files:
        raise FileNotFoundError(f"no test images under {subject_dir}/test")
    images = load_stack(files, imsize)
    gts = load_mask_stack([fs.ground_truth_path(f) for f in files], imsize)
    labels = (gts.reshape(len(files), -1).sum(axis=1) > 0).astype(np.int32)
    return MVTecTestData(subject=subject, imsize=imsize, images=images, ground_truths=gts,
                         labels=labels, filenames=list(files))
