"""MVTec-AD images: decoding, the train/val split, and the train-good
arrays of one subject.

Counterpart of ssad_tpu/data/mvtec.py:25-38 (load_image), :53-63
(load_stack, its PIL path), :90-102 (train_val_split) and :105-217
(PretextData, prepare_pretext_data).  It fills the fields patch
normality and the export's calibration read; the cut pool and the
object masks of the synthesis engine, and the native threaded loader,
wait for the synthesis slice.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ssad_tpu_torch.utils import filesystem as fs


def load_image(path, imsize: Tuple[int, int]) -> np.ndarray:
    """Decode + resize one image (path or binary file object) to
    (H, W, 3) float32 in [0, 1], in the reference's PIL
    open → resize → convert('RGB') order (PIL's default resample)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.resize((imsize[1], imsize[0])).convert("RGB")
        return np.asarray(img, np.float32) / 255.0


def load_stack(paths: Sequence[str], imsize: Tuple[int, int]) -> np.ndarray:
    """Decode + resize a list of images → (N, H, W, 3) float32."""
    if not paths:
        return np.zeros((0,) + tuple(imsize) + (3,), np.float32)
    return np.stack([load_image(p, imsize) for p in paths])


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
class PretextData:
    """The decoded train-good images of one subject, split train/val."""

    subject: str
    imsize: Tuple[int, int]
    train_images: np.ndarray  # (Nt, H, W, 3) float32
    val_images: np.ndarray  # (Nv, H, W, 3)


def prepare_pretext_data(
    dataset_dir: str | Path,
    subject: str,
    imsize: Tuple[int, int] = (256, 256),
    val_fraction: float = 0.2,
    seed: int = 0,
) -> PretextData:
    """Discover, decode and split ``<dataset_dir>/<subject>/train/good``."""
    subject_dir = Path(dataset_dir) / subject
    files = fs.train_good_images(subject_dir)
    if not files:
        raise FileNotFoundError(f"no train images under {subject_dir}/train/good")
    train_files, val_files = train_val_split(files, val_fraction, seed)
    return PretextData(
        subject=subject,
        imsize=tuple(imsize),
        train_images=load_stack(train_files, imsize),
        val_images=load_stack(val_files, imsize),
    )
